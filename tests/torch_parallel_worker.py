"""One gloo rank of the sharded tests, writing what it got to
<out_dir>/rank<rank>.npz. It imports the port only.

    python tests/torch_parallel_worker.py cpu <inputs.npz> <out_dir> <init_method> <world> <rank>

(tests/test_torch_parallel.py) reads a model, a camera, targets and a
binocular shift from the npz and runs the port's band-sharded render
(outputs and gradients, replicated and with `shard_gaussians`), one sharded
binocular step, and 3 steps with `shard_adam` beside 3 without, on the CPU.

    python tests/torch_parallel_worker.py card <out_dir> <init_method> <world> <rank>

(tests/test_torch_cuda.py) renders test_torch_cuda.py's scene of 5,000
gaussians at 256x192 in bands on the card, counting the blend launches."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from binocular3dgs_torch.config import Config
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import PARAM_NAMES, GaussianParams, from_numpy
from binocular3dgs_torch.parallel.sharding import (
    gather_opt_state, make_mesh, make_sharded_render, make_sharded_train_step,
)
from binocular3dgs_torch.train.state import init_train_state

STEP_ITER = 501  # > densify_from_iter (500): opacity decay on


def render_loss(out, tgt):
    """A loss of every output plane, for the render's gradients."""
    return (((out.image - tgt) ** 2).mean() + 0.1 * out.alpha.mean()
            + 0.01 * out.depth.mean())


def render_grads(render_fn, cam, model, bg, tgt):
    """The loss's gradients in the raw parameters and the mean2d carrier."""
    leaves = {n: getattr(model.params, n).clone().requires_grad_(True) for n in PARAM_NAMES}
    carrier = torch.zeros(model.capacity, 2, requires_grad=True)
    m = type(model)(GaussianParams(**leaves), model.active, model.max_sh_degree,
                    model.active_sh_degree, model.spatial_lr_scale)
    loss = render_loss(render_fn(cam, m, bg, mean2d_carrier=carrier), tgt)
    grads = torch.autograd.grad(loss, [*leaves.values(), carrier])
    return {f"grad.{n}": g.numpy() for n, g in zip([*PARAM_NAMES, "carrier"], grads)}


def state_arrays(prefix, state):
    out = {f"{prefix}.{k}": getattr(state.model.params, k).numpy().copy() for k in PARAM_NAMES}
    for tree in ("adam_m", "adam_v"):
        out.update({f"{prefix}.{tree}.{k}": getattr(getattr(state, tree), k).numpy().copy()
                    for k in PARAM_NAMES})
    for k in ("grad_accum", "denom", "max_radii2d"):
        out[f"{prefix}.{k}"] = getattr(state, k).numpy().copy()
    out[f"{prefix}.adam_step"] = np.asarray(state.adam_step)
    return out


def main(inputs, out_dir, init_method, world, rank):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        mesh = make_mesh("cpu")
        z = np.load(inputs)

        def fresh_model():  # the steps update the parameters in place
            return from_numpy({n: z[f"params.{n}"] for n in PARAM_NAMES}, z["active"], 1,
                              int(z["active_sh"]), 1.0, device="cpu")

        model = fresh_model()
        W, H = (int(x) for x in z["size"])
        cam = make_camera(np.eye(3), np.zeros(3), *z["fov"], W, H, device="cpu")
        bg, tgt = torch.from_numpy(z["bg"]), torch.from_numpy(z["tgt"])
        cfg = Config()
        res = {}
        for tag, shard in (("rep", False), ("shg", True)):
            render = make_sharded_render(mesh, W, H, cfg.raster, shard_gaussians=shard)
            with torch.no_grad():
                out = render(cam, model, bg)
            res.update({f"{tag}.{k}": getattr(out, k).numpy() for k in
                        ("image", "depth", "alpha", "radii", "num_pairs", "max_tile_pairs")})
            res.update({f"{tag}.{k}": v for k, v in
                        render_grads(render, cam, model, bg, tgt).items()})

        gt, aw = torch.from_numpy(z["gt"]), torch.from_numpy(z["aw"])
        trans = float(z["trans"])
        step = make_sharded_train_step(cfg, mesh, W, H, 1.0, binocular=True,
                                       use_alpha_weight=True)
        st, m = step(init_train_state(fresh_model()), cam, gt, aw, STEP_ITER, trans,
                     torch.zeros(3))
        res.update(state_arrays("step", st))
        res.update({f"step.metrics.{k}": np.asarray(float(getattr(m, k)))
                    for k in ("loss", "l1", "disparity_loss", "alpha_loss", "n_visible")})

        runs = {}
        for tag, shard_adam in (("adam_rep", False), ("adam_shd", True)):
            step = make_sharded_train_step(cfg, mesh, W, H, 1.0, binocular=True,
                                           shard_adam=shard_adam)
            st = init_train_state(fresh_model())
            losses = []
            for it in range(1, 4):
                st, m = step(st, cam, gt, aw, it, trans, torch.zeros(3))
                losses.append(float(m.loss))
            runs[tag] = st
            res[f"{tag}.losses"] = np.asarray(losses)
        res["adam_shd.moment_rows"] = np.asarray(
            [getattr(t, k).shape[0] for t in (runs["adam_shd"].adam_m, runs["adam_shd"].adam_v)
             for k in PARAM_NAMES])
        res.update(state_arrays("adam_rep", runs["adam_rep"]))
        res.update(state_arrays("adam_shd", gather_opt_state(runs["adam_shd"], mesh)))
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def card_main(out_dir, init_method, world, rank):
    from binocular3dgs_torch import tracing
    from test_torch_cuda import CARD_BAND_RASTER, CARD_BAND_SCENE, scene

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        mesh = make_mesh("cuda")
        model, cam = scene(*CARD_BAND_SCENE, mesh.device)
        render = make_sharded_render(mesh, cam.width, cam.height, CARD_BAND_RASTER)
        before = tracing.launches()["blend_forward"]
        with torch.no_grad():
            out = render(cam, model, [0.0, 0.0, 0.0])
        torch.cuda.synchronize()
        res = {k: getattr(out, k).cpu().numpy() for k in ("image", "depth", "alpha", "radii")}
        res["launches"] = np.asarray(tracing.launches()["blend_forward"] - before)
        res["pairs"] = np.asarray([int(out.num_pairs), out.pair_capacity])
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cpu":
        main(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]), int(sys.argv[6]))
    else:
        card_main(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
