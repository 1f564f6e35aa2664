"""The reference agrees with the program at a tiny size on the CPU, and a
sound run of each cell, cut to that size, comes out correct under the
cell's own limits."""

import pytest
import torch

from benchmark import reference as ref, run as run_mod, scene
from benchmark.drivers import train_block as tb
from benchmark.tests.tiny_cells import CPU, tiny_config, use_tiny_cells

SEED = 2**31 + 99


def port_model(sd, params):
    from binocular3dgs_torch.models.gaussians import GaussianModel, GaussianParams

    return GaussianModel(params=GaussianParams(**params), active=sd.active.clone(),
                         max_sh_degree=1, active_sh_degree=1, spatial_lr_scale=sd.extent)


@pytest.mark.parametrize("name", ["llff_3view", "blender_8view"])
def test_the_reference_renders_and_differentiates_as_the_program(name):
    from binocular3dgs_torch.config import RasterConfig
    from binocular3dgs_torch.ops.rasterize import render_tiled

    config = tiny_config(name)
    sd = scene.make_scene(config, SEED, CPU)
    raster = config["trainer"]["raster"]
    cap = raster["pairs_per_gaussian"] * sd.active.shape[0]
    w = torch.Generator().manual_seed(1)
    for cam in sd.cams[:2]:
        leaves_p = {n: t.clone().requires_grad_(True) for n, t in sd.model.items()}
        leaves_r = {n: t.clone().requires_grad_(True) for n, t in sd.model.items()}
        out_p = render_tiled(tb.port_camera(cam), port_model(sd, leaves_p), sd.bg,
                             raster=RasterConfig(), device="cpu")
        out_r = ref.render(cam, leaves_r, sd.active, 1, sd.bg, raster, pair_capacity=cap)
        assert int(out_p.num_pairs) == int(out_r["num_pairs"])
        for a, b in ((out_p.image, out_r["image"]), (out_p.depth, out_r["depth"]),
                     (out_p.alpha, out_r["alpha"])):
            a, b = a.detach(), b.detach()
            assert (a - b).abs().max() <= 1e-6 * max(1.0, float(b.abs().max()))
        weights = torch.rand(out_r["image"].shape, generator=w)
        (out_p.image * weights).sum().backward()
        (out_r["image"] * weights).sum().backward()
        for n in ref.PARAM_NAMES:  # the active rows: padding's gradients are masked
            gp, gr = leaves_p[n].grad[sd.active], leaves_r[n].grad[sd.active]
            assert (gp - gr).norm() <= 1e-5 * gr.norm() + 1e-12, n


def test_the_reference_densifies_as_the_program():
    from binocular3dgs_torch.models.densify import densify_and_prune
    from binocular3dgs_torch.train.state import TrainState, zeros_like_params
    from binocular3dgs_torch.models.gaussians import GaussianParams

    config = tiny_config("llff_3view")
    sd = scene.make_scene(config, SEED, CPU)
    cap = sd.active.shape[0]
    g = torch.Generator().manual_seed(3)
    grad_accum = torch.rand(cap, generator=g) * 4e-4 * sd.active
    denom = torch.ones(cap) * sd.active
    params = {n: t.clone() for n, t in sd.model.items()}
    m = {n: torch.rand(t.shape, generator=g) for n, t in params.items()}
    v = {n: torch.rand(t.shape, generator=g) for n, t in params.items()}
    noise = (torch.randn(cap, 3, generator=g), torch.randn(cap, 3, generator=g))
    state = TrainState(model=port_model(sd, {n: t.clone() for n, t in params.items()}),
                       adam_m=GaussianParams(**{n: t.clone() for n, t in m.items()}),
                       adam_v=GaussianParams(**{n: t.clone() for n, t in v.items()}),
                       adam_step=5, grad_accum=grad_accum.clone(), denom=denom.clone(),
                       max_radii2d=torch.zeros(cap))
    got = densify_and_prune(state, 2e-4, 0.005, sd.extent, 0.01, noise=noise)
    want = ref.densify(params, sd.active, m, v, grad_accum, denom, 2e-4, 0.005, sd.extent,
                       0.01, noise)
    assert got.n_after == want["n_after"] and got.n_wanted == want["n_wanted"]
    assert 0 < want["n_after"] != int(sd.active.sum())
    for n in ref.PARAM_NAMES:
        assert torch.equal(getattr(got.state.model.params, n), want["params"][n]), n
        assert torch.equal(getattr(got.state.adam_m, n), want["m"][n]), n
    assert torch.equal(got.state.model.active, want["active"])


@pytest.mark.parametrize("workload", ["llff3.train", "blender8.train"])
def test_a_sound_run_is_correct(monkeypatch, workload):
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell(workload, SEED, 0.0, False, CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 20 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_it_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
