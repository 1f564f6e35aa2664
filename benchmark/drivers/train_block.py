"""The training-block driver: a cell that trains one scene in blocks of
iterations through the program's own trainer.

Set-up makes the scene from the seed (scene.py), builds a `Scene` in
memory and the program's `Trainer` from it, puts the cell's model in place
as a `TrainState`, and drives that trainer through one warm-up block:

  * its first three steps, during which the benchmark records what the
    comparison reads (each step's losses from the step's own result, the
    first gradient from the first Adam moment, the three steps' change of
    every leaf and of `grad_accum`), and
  * the rest of the block, whose one densification it records before and
    after (on the host).

The state after the warm-up block (pair capacity grown, Adam moments
filled) is the start of every block of the window: each block restores it,
reseeds the trainer's view and shift draws alike, and runs
`Trainer.train(iterations=first + n - 1, first_iteration=first)`. Set-up
records the first three steps of one such block as it records the warm-up's.
The window runs whole blocks and ends with the first that ends after
`seconds`; `train_it_s` is their iterations over their time, restores
included.

The traced run adds the per-layer readings: the work counts of the start
state at set-up (B2's bound for the block's first iteration, the useful
operations of an iteration), `Trainer._densify` timed with the card
synchronised at its ends during the window, and one block under the
profiler.

After the window the trainer is freed and the reference follows the first
three steps of the warm-up from the cell's inputs, densifies the program's
own state from before its densification, and follows the first three
steps of a block from the program's start state (compare.py).
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from .. import compare, reference as ref, trace as trace_mod, work
from ..scene import make_scene, sub_seed

DRAW_SEED, BLOCK_SEED = 2, 3  # sub-seeds of --seed: the trainer's draws, the blocks'
MIN_OPACITY = 0.005  # the trainer's prune threshold (train/loop.py)


def port_config(config: dict, train_seed: int):
    """The program's `Config`: its defaults, then every value of the
    configuration file's `trainer` groups."""
    from binocular3dgs_torch.config import Config

    cfg = Config()
    for group, values in config["trainer"].items():
        section = getattr(cfg, group)
        for key, value in values.items():
            if not hasattr(section, key):
                raise KeyError(f"the program's config has no {group}.{key}")
            setattr(section, key, tuple(value) if isinstance(value, list) else value)
    cfg.model.sh_degree = config["model"]["sh_degree"]
    cfg.train.seed = train_seed
    return cfg


def port_camera(cam: ref.Cam):
    from binocular3dgs_torch.core.camera import Camera

    return Camera(world_view=cam.world_view.clone(), proj=cam.proj.clone(),
                  full_proj=cam.full_proj.clone(), cam_center=cam.cam_center.clone(),
                  tanfovx=cam.tanfovx.clone(), tanfovy=cam.tanfovy.clone(), width=cam.width,
                  height=cam.height, znear=cam.znear, zfar=cam.zfar)


def build_trainer(cfg, sd, device):
    """The program's trainer of an in-memory scene of the cell's views; its
    own first model (of a four-point stand-in cloud) is replaced by the
    cell's in `put_state`."""
    from binocular3dgs_torch.data.dataset import Scene, View
    from binocular3dgs_torch.data.ply import PointCloud
    from binocular3dgs_torch.data.readers import SceneInfo
    from binocular3dgs_torch.train.loop import Trainer

    views = [View(camera=port_camera(cam), image=sd.gt[i].permute(1, 2, 0).cpu().numpy(),
                  alpha_mask=None if sd.alpha is None else sd.alpha[i][..., None].cpu().numpy(),
                  image_name=f"view_{i}", colmap_id=i, uid=i)
             for i, cam in enumerate(sd.cams)]
    pcd = PointCloud(points=np.eye(4, 3, dtype=np.float32), colors=np.full((4, 3), 0.5, np.float32))
    info = SceneInfo(point_cloud=pcd, train_cameras=[], test_cameras=[],
                     nerf_normalization={"translate": np.zeros(3), "radius": sd.extent},
                     ply_path=None)
    scene = Scene(train_views=views, test_views=[], cameras_extent=sd.extent, scene_info=info)
    return Trainer(cfg, scene, device=device)


def put_state(trainer, sd, adam_step: int):
    """The cell's model as the trainer's state: its first moment and
    statistics zero, its second moment the scene's warm one, the Adam step
    count at the block's start."""
    from binocular3dgs_torch.models.gaussians import GaussianModel, GaussianParams
    from binocular3dgs_torch.train.state import TrainState, zeros_like_params

    params = GaussianParams(**{n: sd.model[n].clone() for n in ref.PARAM_NAMES})
    cap = sd.active.shape[0]
    dev = sd.active.device
    model = GaussianModel(params=params, active=sd.active.clone(), max_sh_degree=sd.sh_degree,
                          active_sh_degree=sd.sh_degree, spatial_lr_scale=sd.extent)
    trainer.state = TrainState(model=model, adam_m=zeros_like_params(params),
                               adam_v=GaussianParams(**{n: sd.v0[n].clone()
                                                        for n in ref.PARAM_NAMES}),
                               adam_step=adam_step,
                               grad_accum=torch.zeros(cap, device=dev),
                               denom=torch.zeros(cap, device=dev),
                               max_radii2d=torch.zeros(cap, device=dev))


def _clone_tree(tree):
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).clone()
                                        for f in dataclasses.fields(tree)})


def clone_state(st):
    model = dataclasses.replace(st.model, params=_clone_tree(st.model.params),
                                active=st.model.active.clone())
    return st.replace(model=model, adam_m=_clone_tree(st.adam_m), adam_v=_clone_tree(st.adam_v),
                      grad_accum=st.grad_accum.clone(), denom=st.denom.clone(),
                      max_radii2d=st.max_radii2d.clone())


@dataclasses.dataclass
class Start:
    state: object
    raster: object
    seed: int


def restore(trainer, start: Start):
    """The block's start: the state, the pair capacity, and the view and
    shift draws seeded alike for every block."""
    trainer.state = clone_state(start.state)
    trainer.raster = start.raster
    trainer.rng = random.Random(start.seed)
    trainer.generator = torch.Generator().manual_seed(start.seed)


def draws(seed: int, n_views: int, dist: float, steps: int) -> list:
    """(view, shift) of the trainer's first `steps` binocular steps from
    `seed`: a view from `random.Random(seed)`, then the shift u * dist with
    a random sign from a CPU `torch.Generator` (train/loop.py's order)."""
    rng, gen = random.Random(seed), torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        v = rng.randrange(n_views)
        u, s = torch.rand(2, generator=gen).tolist()
        out.append((v, u * dist * (1.0 if s < 0.5 else -1.0)))
    return out


class FirstSteps:
    """Records the first three binocular steps that the trainer runs from
    the state `base` (which the steps leave untouched), on the device and
    without a host read: each step's losses, the first gradient as Adam got
    it, worked out from its first moment before and after step 1
    (m1 = b1 m0 + (1 - b1) g), and the change of every leaf and of
    grad_accum after step 3."""

    def __init__(self, trainer, base):
        self.trainer, self.rows = trainer, []
        self.p0 = {n: getattr(base.model.params, n) for n in ref.PARAM_NAMES}
        self.m0 = {n: getattr(base.adam_m, n) for n in ref.PARAM_NAMES}
        self.ga0 = base.grad_accum
        self.orig = trainer.steps[True]
        trainer.steps = {**trainer.steps, True: self.step}

    def step(self, state, *args):
        state, metrics = self.orig(state, *args)
        row = [metrics.loss, metrics.disparity_loss, metrics.alpha_loss]
        if not self.rows:
            row += [(getattr(state.adam_m, n) - self.m0[n] * ref.ADAM_B1).norm()
                    / (1.0 - ref.ADAM_B1) for n in ref.PARAM_NAMES]
        if len(self.rows) == 2:
            row += [(getattr(state.model.params, n) - self.p0[n]).norm() for n in ref.PARAM_NAMES]
            row.append((state.grad_accum - self.ga0).norm())
        self.rows.append(row)
        return state, metrics

    def readings(self) -> dict:
        self.trainer.steps = {**self.trainer.steps, True: self.orig}
        if len(self.rows) != 3:
            raise RuntimeError(f"the trainer ran {len(self.rows)} binocular steps, not 3")
        lengths = [len(r) for r in self.rows]
        flat = torch.stack([v.double() for r in self.rows for v in r]).tolist()
        steps = [flat[sum(lengths[:k]):sum(lengths[:k + 1])] for k in range(3)]
        return dict(loss=[s[0] for s in steps], disparity_loss=[s[1] for s in steps],
                    alpha_loss=[s[2] for s in steps],
                    grad=dict(zip(ref.PARAM_NAMES, steps[0][3:])),
                    change=dict(zip(ref.PARAM_NAMES + ("grad_accum",), steps[2][3:])))


def first_steps(trainer, base, first: int) -> dict:
    """The readings of the trainer's first three binocular steps from its
    current state, `base` being a copy of it that the steps leave alone."""
    rec = FirstSteps(trainer, base)
    trainer.train(iterations=first + 2, first_iteration=first)
    return rec.readings()


def host_state(st) -> dict:
    """A copy, on the host, of what densification reads and writes."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    return dict(params={n: host(getattr(st.model.params, n)) for n in ref.PARAM_NAMES},
                m={n: host(getattr(st.adam_m, n)) for n in ref.PARAM_NAMES},
                v={n: host(getattr(st.adam_v, n)) for n in ref.PARAM_NAMES},
                active=host(st.model.active), grad_accum=host(st.grad_accum),
                denom=host(st.denom), rows=int(st.model.active.sum()))


class DensifyCapture:
    """The trainer's state before and after each `_densify` (on the host)."""

    def __init__(self, trainer):
        self.trainer, self.calls = trainer, []
        orig = trainer._densify

        def call():
            pre = host_state(trainer.state)
            orig()
            self.calls.append((pre, host_state(trainer.state)))

        trainer._densify = call

    def remove(self):
        del self.trainer._densify


class DensifyTimer:
    """Host-clock ms of each `_densify`, the card synchronised at its
    entry and exit."""

    def __init__(self, trainer):
        self.trainer, self.ms = trainer, []
        orig = trainer._densify

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig()
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)

        trainer._densify = call

    def remove(self):
        del self.trainer._densify


def settings(config: dict) -> dict:
    return dict(opt=config["trainer"]["opt"], train=config["trainer"]["train"],
                raster=config["trainer"]["raster"])


@torch.no_grad()
def count_work(start: Start, sd, config: dict, first_view_shift) -> dict:
    """B2's bound for the two renders of the block's first iteration and
    the useful operations of one iteration, counted on the start state by
    the reference's renders."""
    st = start.state
    params = {n: getattr(st.model.params, n) for n in ref.PARAM_NAMES}
    active = st.model.active
    raster = config["trainer"]["raster"]
    cap = start.raster.pairs_per_gaussian * active.shape[0]

    def rend(cam):
        return ref.render(cam, params, active, sd.sh_degree, sd.bg, raster, pair_capacity=cap)

    view, trans = first_view_shift
    b2_bound_ms = (work.blend_backward_bound_ms(rend(sd.cams[view]))
                   + work.blend_backward_bound_ms(rend(ref.shift_cam(sd.cams[view], trans))))
    per_view = [work.render_flops(rend(cam)) for cam in sd.cams]
    img = config["scene"]["images"]
    values = sum(params[n][0].numel() for n in ref.PARAM_NAMES)
    flops = work.iteration_flops(per_view, img["width"], img["height"], int(active.sum()),
                                 values)
    return dict(b2_bound_ms=b2_bound_ms, flops_per_it=flops)


def seed_state(sd, config: dict, first: int) -> dict:
    """The reference's state at the warm-up's start, from the cell's inputs."""
    dev = sd.active.device
    cap = sd.active.shape[0]
    return dict(params={n: sd.model[n].clone() for n in ref.PARAM_NAMES}, active=sd.active,
                m={n: torch.zeros_like(sd.model[n]) for n in ref.PARAM_NAMES},
                v={n: sd.v0[n].clone() for n in ref.PARAM_NAMES}, adam_step=first - 1,
                grad_accum=torch.zeros(cap, device=dev), denom=torch.zeros(cap, device=dev),
                max_radii2d=torch.zeros(cap, device=dev))


def program_state(st) -> dict:
    """A copy of the program's state `st` as the reference's state."""
    def tree(t):
        return {n: getattr(t, n).clone() for n in ref.PARAM_NAMES}

    return dict(params=tree(st.model.params), active=st.model.active.clone(), m=tree(st.adam_m),
                v=tree(st.adam_v), adam_step=st.adam_step, grad_accum=st.grad_accum.clone(),
                denom=st.denom.clone(), max_radii2d=st.max_radii2d.clone())


def reference_steps(state: dict, sd, config, first: int, draw_seed: int,
                    tf32: bool = False) -> dict:
    """The reference's readings of three steps from `state` (updated in
    place), with the views and shifts that the trainer draws from
    `draw_seed`."""
    cap = state["active"].shape[0]
    state.update(sh_degree=sd.sh_degree, spatial_lr_scale=sd.extent,
                 pair_capacity=config["trainer"]["raster"]["pairs_per_gaussian"] * cap)
    params = state["params"]
    p0 = {n: t.clone() for n, t in params.items()}
    ga0 = state["grad_accum"].clone()
    tr = config["trainer"]["train"]
    out = dict(loss=[], disparity_loss=[], alpha_loss=[])
    for k, (v, trans) in enumerate(draws(draw_seed, len(sd.cams), tr["cam_trans_dist"], 3)):
        aw = None if sd.alpha is None else 1.0 - sd.alpha[v]
        res = ref.train_step(state, sd.cams[v], sd.gt[v], aw, first + k, trans, sd.bg,
                             settings(config), tf32)
        out["loss"].append(float(res["loss"]))
        out["disparity_loss"].append(float(res["disparity_loss"]))
        out["alpha_loss"].append(float(res["alpha_loss"]))
        if k == 0:
            out["grad"] = {n: float(g.double().norm()) for n, g in res["grads"].items()}
    out["change"] = {n: float((params[n] - p0[n]).double().norm()) for n in ref.PARAM_NAMES}
    out["change"]["grad_accum"] = float((state["grad_accum"] - ga0).double().norm())
    return out


def densify_steps(config: dict, first: int) -> int:
    """The binocular steps of a block before its densification, which
    follows the first iteration at or after `first` that the interval
    divides."""
    interval = config["trainer"]["opt"]["densification_interval"]
    return -(-first // interval) * interval - first + 1


def reference_densify(pre: dict, config: dict, sd, train_seed: int, steps_before: int,
                      tf32: bool = False) -> dict:
    """The reference's densification of the program's state `pre`, with
    the split noise worked out from the seed: the trainer's generator drew
    two numbers per binocular step before it."""
    dev = sd.active.device
    gen = torch.Generator().manual_seed(train_seed)
    for _ in range(steps_before):
        torch.rand(2, generator=gen)
    cap = pre["active"].shape[0]
    noise = (torch.randn(cap, 3, generator=gen), torch.randn(cap, 3, generator=gen))

    def d(tree):
        return {n: t.to(dev) for n, t in tree.items()}

    opt = config["trainer"]["opt"]
    out = ref.densify(d(pre["params"]), pre["active"].to(dev), d(pre["m"]), d(pre["v"]),
                      pre["grad_accum"].to(dev), pre["denom"].to(dev),
                      opt["densify_grad_threshold"], MIN_OPACITY, sd.extent,
                      opt["percent_dense"], noise, tf32)
    return dict(**{k: {n: t.cpu() for n, t in out[k].items()} for k in ("params", "m", "v")},
                rows=out["n_after"])


@dataclasses.dataclass
class Setup:
    """What set-up leaves: the scene (the benchmark's inputs), the trainer
    after its warm-up block, the program's readings of its first steps and
    of its densification, the blocks' start, and the program's readings of
    the first steps of a block."""

    sd: object
    trainer: object
    prog: dict
    densify: tuple
    start: Start
    block: dict
    first: int
    n_it: int
    train_seed: int


def setup(config: dict, traffic: dict, seed: int, device) -> Setup:
    first = config["trainer"]["train"]["shift_cam_start"] + traffic["start_after_binocular"]
    n_it = traffic["iterations"]
    train_seed, block_seed = sub_seed(seed, DRAW_SEED), sub_seed(seed, BLOCK_SEED)
    sd = make_scene(config, seed, device)
    trainer = build_trainer(port_config(config, train_seed), sd, device)
    put_state(trainer, sd, adam_step=first - 1)
    prog = first_steps(trainer, clone_state(trainer.state), first)
    cap = DensifyCapture(trainer)
    trainer.train(iterations=first + n_it - 1, first_iteration=first + 3)
    cap.remove()
    if len(cap.calls) != 1:
        raise RuntimeError(f"the warm-up block densified {len(cap.calls)} times, not once")
    start = Start(clone_state(trainer.state), trainer.raster, block_seed)
    restore(trainer, start)
    block = first_steps(trainer, start.state, first)
    return Setup(sd, trainer, prog, cap.calls[0], start, block, first, n_it, train_seed)


def reference_warmup(su: Setup, config: dict, tf32: bool = False) -> dict:
    """The reference's first three steps of the warm-up, from the cell's
    inputs."""
    return reference_steps(seed_state(su.sd, config, su.first), su.sd, config, su.first,
                           su.train_seed, tf32)


def reference_block(su: Setup, config: dict, tf32: bool = False) -> dict:
    """The reference's first three steps of a block, from the program's
    start state."""
    return reference_steps(program_state(su.start.state), su.sd, config, su.first,
                           su.start.seed, tf32)


def reference_post(su: Setup, config: dict, tf32: bool = False) -> dict:
    """The reference's densification of the program's state before it."""
    return reference_densify(su.densify[0], config, su.sd, su.train_seed,
                             densify_steps(config, su.first), tf32)


def numbers(su: Setup, config: dict, prog: dict | None = None, post: dict | None = None,
            block: dict | None = None, tf32: bool = False) -> tuple[dict, dict]:
    """(the numbers compared, the reference's readings): the program's
    readings `prog`, densified state `post` and block readings `block` (by
    default set-up's) against the reference's, computed in float32, or with
    TF32 rounding for the control."""
    ref.fp32_only()
    warm, blk = reference_warmup(su, config, tf32), reference_block(su, config, tf32)
    out = compare.step_numbers(su.prog if prog is None else prog, warm)
    out.update(compare.densify_numbers(su.densify[1] if post is None else post,
                                       reference_post(su, config, tf32)))
    out.update({"block_" + k: v
                for k, v in compare.step_numbers(su.block if block is None else block,
                                                 blk).items()})
    return out, dict(warmup=warm, block=blk)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    su = setup(config, traffic, seed, device)
    trainer, start, first, n_it = su.trainer, su.start, su.first, su.n_it
    ctx = dict(iterations_per_block=n_it, pairs_per_gaussian=start.raster.pairs_per_gaussian)
    if trace:
        first_draw = draws(start.seed, len(su.sd.cams),
                           config["trainer"]["train"]["cam_trans_dist"], 1)[0]
        ctx.update(count_work(start, su.sd, config, first_draw))
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    # -- window ------------------------------------------------------------
    timer = DensifyTimer(trainer) if trace and device.type == "cuda" else None
    ends = []
    t0 = time.perf_counter()
    while True:
        restore(trainer, start)
        trainer.train(iterations=first + n_it - 1, first_iteration=first)
        sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    blocks, window_s = len(ends), ends[-1]
    if timer is not None:
        timer.remove()
        ctx["densify_ms"] = timer.ms
    finite = all(bool(torch.isfinite(getattr(trainer.state.model.params, n)).all())
                 for n in ref.PARAM_NAMES)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx.update(blocks=blocks, window_s=window_s, train_it_s=blocks * n_it / window_s)
    log(f"[window] {blocks} blocks of {n_it} iterations in {window_s:.3f} s (blocks "
        f"{[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]} s); pairs per gaussian "
        f"{ctx['pairs_per_gaussian']}; peak {peak / 2**30:.3f} GiB")

    if trace:
        ctx["trace"] = profile_block(trainer, start, first, n_it, device, log)

    # -- the comparison ----------------------------------------------------
    su.trainer = trainer = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, refr = numbers(su, config)
    log(f"[reference] {time.perf_counter() - t_ref:.3f} s; program {su.prog}, block {su.block}; "
        f"reference {refr}")
    return dict(setup_s=setup_s, train_it_s=ctx["train_it_s"], attempted=blocks * n_it,
                failed=0 if finite else blocks * n_it, memory_peak_bytes=peak, numbers=nums,
                ctx=ctx)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_block(trainer, start: Start, first: int, n_it: int, device, log) -> dict:
    """One block under the profiler, device activity only. On the CPU (the
    tests) the host's operators stand in for the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        sync(device)
        t0 = time.time_ns()
        restore(trainer, start)
        trainer.train(iterations=first + n_it - 1, first_iteration=first)
        sync(device)
        t1 = time.time_ns()
    tp = time.perf_counter()
    events = trace_mod.device_events(prof, t0, t1, DeviceType.CUDA if cuda else DeviceType.CPU)
    out = trace_mod.summarize(events, t0, t1)
    out["events"] = events
    log(f"[trace] {len(events)} device events in {out['window_s']:.3f} s, busy "
        f"{out['busy_s']:.3f} s; read in {time.perf_counter() - tp:.3f} s")
    return out
