"""Tests that need a CUDA card: the hand-written kernels (blend forward B1,
blend backward B2, warp forward W1 and backward W2, the vertex stage's
forward and backward, SSIM's forward S1 and backward S2, binning and the
record gather with its backward) against their plain PyTorch versions,
bit for bit where the kernels keep the plain version's order (B1 and B2
also on tiles long enough to be walked in chunks, and the chunks' work
list against its plain mirror), and their
launch counters around a render and a training step; a training step that
repeats bit for bit; the port's ranges on the
profiler's device clock, and a traced span of the trainer that syncs no
more than an untraced one; the dense init's Farneback
flow and growth scorer, and one PDCNet+ pass, RANSAC and warp, on the card
against the CPU; a band render over two gloo ranks on the card against the
single render. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from binocular3dgs_torch import tracing
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import (
    PARAM_NAMES, GaussianModel, GaussianParams, from_numpy,
)
from binocular3dgs_torch.config import Config, RasterConfig
from binocular3dgs_torch.ops import losses, warp
from binocular3dgs_torch.ops.binning import (
    bin_gaussians, bin_gaussians_torch, bin_launches, tile_grid,
)
from binocular3dgs_torch.ops.blend_cuda import (
    BLEND_CHUNK,
    PLAN_HEADER,
    blend_backward,
    blend_backward_torch,
    blend_forward,
    blend_forward_cuda,
    blend_forward_torch,
    blend_plan,
    blend_plan_torch,
)
from binocular3dgs_torch.ops.project import (
    compute_cov3d, ewa_cov2d, project_backward, project_backward_torch, project_gaussians,
)
from binocular3dgs_torch.ops.project import ProjectedGaussians
from binocular3dgs_torch.ops.rasterize import (
    _build_fields, _GatherRecords, _tiles_to_planes, gather_backward, project_for_render,
    rasterize_projected, render_tiled, segment_sum_columns,
)
from binocular3dgs_torch.train.state import init_train_state
from binocular3dgs_torch.train.step import make_train_step

TS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from binocular3dgs_torch import resolve_device

    return resolve_device("cuda")


def scene(seed, n, w, h, device, opacity=(0.2, 0.95), depth=(3.0, 9.0), elongated=False):
    """A random scene; `elongated` draws needles (one axis 0.3-0.8, two
    0.005-0.02, random rotations), thin rotated ellipses on screen whose
    alpha box is far smaller than their binning box, for the kernels'
    per-warp culling."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(*depth, n)], axis=1)
    q = rng.normal(size=(n, 4))
    params = dict(
        xyz=xyz,
        f_dc=(rng.random((n, 1, 3)) - 0.5) / 0.28209479177387814,
        f_rest=rng.normal(size=(n, 3, 3)) * 0.1,
        opacity=np.log(1 / (1 / rng.uniform(*opacity, (n, 1)) - 1)),
        scaling=np.log(rng.uniform(0.05, 0.4, (n, 3))),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
    )
    if elongated:
        params["scaling"] = np.log(np.concatenate([rng.uniform(0.3, 0.8, (n, 1)),
                                                   rng.uniform(0.005, 0.02, (n, 2))], 1))
    model = from_numpy(params, np.ones(n, bool), 1, 1, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, w, h, device=device)
    return model, cam


def records_for(model, cam, ppg=16):
    """The blend's inputs from the plain binning and gather, whose unused
    slots hold finite records (the plain blend reads past a tile's pairs)."""
    proj = project_for_render(cam, model)
    TW, TH = tile_grid(cam.width, cam.height, TS)
    b = bin_gaussians_torch(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, TS,
                            ppg * model.capacity)
    records = _build_fields(proj)[:, b.order][:, b.pair_gauss].contiguous()
    return records, b.tile_start, b.tile_count, TW, TH


SCENES = [
    (0, 64, 64, 48, (0.2, 0.95), False),
    (1, 400, 200, 150, (0.9, 0.99), False),  # heavy overdraw: the termination path
    (2, 300, 50, 38, (0.2, 0.95), False),  # size not a multiple of the tile
    (5, 400, 200, 150, (0.5, 0.99), True),  # needles: culling against thin boxes
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opacity,elongated", SCENES)
def test_kernel_matches_plain(cuda_device, seed, n, w, h, opacity, elongated):
    model, cam = scene(seed, n, w, h, cuda_device, opacity, elongated=elongated)
    records, start, count, TW, TH = records_for(model, cam)
    before = tracing.launches()["blend_forward"]
    out5, nc = blend_forward(records, start, count, TW, TH, TS)
    torch.cuda.synchronize()
    assert tracing.launches()["blend_forward"] == before + 1
    want5, want_nc = blend_forward_torch(records, start, count, TW, TH, TS)
    # FMA contraction and summation order differ from the plain version;
    # O(1) planes agree to a few float32 ulps of the running sums
    torch.testing.assert_close(out5[[0, 1, 2, 4]], want5[[0, 1, 2, 4]], atol=1e-4, rtol=0)
    zmax = want5[3].abs().max().item()
    torch.testing.assert_close(out5[3], want5[3], atol=1e-5 * zmax + 1e-4, rtol=0)
    # a pair right at the 1/255 or 1e-4 cut may flip under another rounding
    assert (nc == want_nc).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_render_counts_one_launch(cuda_device):
    model, cam = scene(3, 100, 64, 48, cuda_device)
    before = tracing.launches()
    out = render_tiled(cam, model, [0.0, 0.0, 0.0], device=cuda_device)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert after["blend_forward"] == before["blend_forward"] + 1
    assert after["project_forward"] == before["project_forward"] + 1
    assert out.image.shape == (3, 48, 64) and torch.isfinite(out.image).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opacity,elongated", SCENES)
def test_backward_kernel_matches_plain(cuda_device, seed, n, w, h, opacity, elongated):
    model, cam = scene(seed, n, w, h, cuda_device, opacity, elongated=elongated)
    records, start, count, TW, TH = records_for(model, cam)
    # the forward kernels' outputs and the long tiles' boundary state they
    # keep for B2, which must be of the same forward as out5 and n_contrib
    out5, nc, state = blend_forward_cuda(records, start, count, TW, TH, TS)
    g = torch.Generator().manual_seed(seed)
    d_out5 = torch.randn(out5.shape, generator=g).to(cuda_device)
    before = tracing.launches()["blend_backward"]
    got = blend_backward(records, start, count, out5, nc, d_out5, TW, TH, TS, state=state)
    torch.cuda.synchronize()
    assert tracing.launches()["blend_backward"] == before + 1
    want = blend_backward_torch(records, start, count, out5, nc, d_out5, TW, TH, TS)
    # transmittance rebuilt by one reciprocal per pair here, by chunk suffix
    # products there, and the pixel sums in another order: each of the ten
    # rows within 1e-3 of its largest entry
    for row in range(10):
        scale = want[row].abs().max().item()
        assert (got[row] - want[row]).abs().max().item() <= 1e-3 * scale + 1e-12, row
    assert not got[10:].any() and got[:10].abs().max() > 0


def long_tile_scene(seed, n, opacity, device, w=400, h=400):
    """`n` small splats whose means fall within ~40 px of the centre of a
    `w` x `h` image (Blender's 400x400), so that its central tiles hold
    thousands of pairs, as the silhouette tiles of the Blender cell do (up
    to ~3,400 at its start state)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.normal(0.0, 0.15, n), rng.normal(0.0, 0.15, n),
                    rng.uniform(4.0, 6.0, n)], axis=1)
    q = rng.normal(size=(n, 4))
    params = dict(
        xyz=xyz,
        f_dc=(rng.random((n, 1, 3)) - 0.5) / 0.28209479177387814,
        f_rest=rng.normal(size=(n, 3, 3)) * 0.1,
        opacity=np.log(1 / (1 / rng.uniform(*opacity, (n, 1)) - 1)),
        scaling=np.log(rng.uniform(0.01, 0.05, (n, 3))),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
    )
    model = from_numpy(params, np.ones(n, bool), 1, 1, device=device)
    return model, make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, w, h, device=device)


LONG = [(11, (0.02, 0.1)),  # deep chains: T_in a product of many chunk products
        (12, (0.3, 0.99))]  # pixels stop within and between chunks


@pytest.mark.cuda
@pytest.mark.parametrize("seed,opacity", LONG)
def test_chunked_kernels_match_plain_on_long_tiles(cuda_device, seed, opacity):
    """B1 and B2 on tiles of >= 3,000 pairs at Blender's 400x400, each tile
    walked in chunks of BLEND_CHUNK pairs, against their plain versions,
    under the gates of the one-block walk: the rounding of T_in as a product
    of chunk products stays inside them (a T_in rounded to bfloat16 does
    not: PERF.md §6)."""
    model, cam = long_tile_scene(seed, 12000, opacity, cuda_device)
    records, start, count, TW, TH = records_for(model, cam)
    assert int(count.max()) >= 3000
    out5, nc, state = blend_forward_cuda(records, start, count, TW, TH, TS)
    want5, want_nc = blend_forward_torch(records, start, count, TW, TH, TS)
    torch.testing.assert_close(out5[[0, 1, 2, 4]], want5[[0, 1, 2, 4]], atol=1e-4, rtol=0)
    zmax = want5[3].abs().max().item()
    torch.testing.assert_close(out5[3], want5[3], atol=1e-5 * zmax + 1e-4, rtol=0)
    assert (nc == want_nc).float().mean().item() >= 0.999
    long_ = count > BLEND_CHUNK
    assert (nc[long_] > BLEND_CHUNK).any()  # pixels blend past the first chunk
    g = torch.Generator().manual_seed(seed)
    d_out5 = torch.randn(out5.shape, generator=g).to(cuda_device)
    got = blend_backward(records, start, count, out5, nc, d_out5, TW, TH, TS, state=state)
    want = blend_backward_torch(records, start, count, out5, nc, d_out5, TW, TH, TS)
    for row in range(10):
        scale = want[row].abs().max().item()
        assert (got[row] - want[row]).abs().max().item() <= 1e-3 * scale + 1e-12, row
    assert not got[10:].any()


def blend_both(records, start, count, TW, TH, chunk, seed=0):
    """(out5, n_contrib, d_records) of the kernels in chunks of `chunk`."""
    plan = blend_plan(count, records.shape[1], chunk)
    out5, nc, state = blend_forward_cuda(records, start, count, TW, TH, TS, plan)
    g = torch.Generator().manual_seed(seed)
    d_out5 = torch.randn(out5.shape, generator=g).to(records.device)
    d_rec = blend_backward(records, start, count, out5, nc, d_out5, TW, TH, TS, state=state)
    return out5, nc, d_rec


@pytest.mark.cuda
def test_chunked_walk_equals_the_whole_walk_on_short_tiles(cuda_device):
    """On a tile of at most BLEND_CHUNK pairs (one work item) B1's planes
    and n_contrib and B2's rows equal bit for bit those of a run whose chunk
    holds every tile whole (the one-block walk of each tile)."""
    model, cam = long_tile_scene(13, 12000, (0.05, 0.5), cuda_device)
    records, start, count, TW, TH = records_for(model, cam)
    short = count <= BLEND_CHUNK
    assert short.any() and (~short).any()
    whole = -(-int(count.max()) // 128) * 128
    (a5, anc, ad), (b5, bnc, bd) = (blend_both(records, start, count, TW, TH, k)
                                    for k in (BLEND_CHUNK, whole))
    assert torch.equal(bits(a5[:, short]), bits(b5[:, short]))
    assert torch.equal(anc[short], bnc[short])
    cols = torch.cat([torch.arange(s, s + c) for s, c in
                      zip(start[short].tolist(), count[short].tolist())]).to(cuda_device)
    assert cols.numel() > 0
    assert torch.equal(bits(ad[:, cols]), bits(bd[:, cols]))
    # the long tiles differ only by rounding
    torch.testing.assert_close(a5[:, ~short], b5[:, ~short], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_chunked_kernels_repeat_bit_for_bit(cuda_device):
    model, cam = long_tile_scene(14, 12000, (0.1, 0.9), cuda_device)
    args = records_for(model, cam)
    (a5, anc, ad), (b5, bnc, bd) = (blend_both(*args, BLEND_CHUNK) for _ in range(2))
    assert torch.equal(bits(a5), bits(b5)) and torch.equal(anc, bnc)
    assert torch.equal(bits(ad), bits(bd))


def plan_lists(plan, T):
    """The first chunk of each tile and the chunk items of a plan buffer."""
    p = plan.plan.tolist()
    o = PLAN_HEADER
    return p[o:o + T], p[o + T:o + T + p[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [(625, 256), (11970, 256), (47628, 384)])
def test_plan_kernel_equals_its_mirror(cuda_device, T, chunk):
    g = torch.Generator().manual_seed(T)
    count = torch.randint(0, 200, (T,), generator=g, dtype=torch.int32)
    count[torch.randperm(T, generator=g)[: T // 20]] = torch.randint(
        257, 3400, (T // 20,), generator=g, dtype=torch.int32)
    count[:3] = 0
    capacity = int(count.sum()) + 1000
    want = blend_plan_torch(count, capacity, chunk)
    before = tracing.launches()["blend_plan"]
    got = blend_plan(count.to(cuda_device), capacity, chunk)
    torch.cuda.synchronize()
    assert tracing.launches()["blend_plan"] == before + 1
    assert plan_lists(got, T) == plan_lists(want, T)
    assert int(got.chunks) == int(want.chunks) and int(got.longest_walk) == chunk


@pytest.mark.cuda
def test_a_render_records_the_blend_work_items(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    model, cam = long_tile_scene(15, 4000, (0.1, 0.9), cuda_device, 96, 64)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]):
        out = render_tiled(cam, model, [0.0, 0.0, 0.0], device=cuda_device)
        torch.cuda.synchronize()
    value = {c["name"]: c["value"] for c in tracing.snapshot(since_ns=t0)["counters"]}
    assert int(out.max_tile_pairs) > BLEND_CHUNK
    assert value["render.blend_longest_walk"] == BLEND_CHUNK
    assert value["render.blend_chunks"] >= -(-value["render.bin_slots"] // BLEND_CHUNK)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [4.0, 40.0])  # mostly in range; mostly out of it
def test_warp_kernels_match_plain(cuda_device, spread):
    g = torch.Generator().manual_seed(int(spread))
    image = torch.rand(3, 75, 101, generator=g).to(cuda_device)
    disp = ((torch.rand(75, 101, generator=g) - 0.5) * spread).to(cuda_device)
    d_out = torch.randn(3, 75, 101, generator=g).to(cuda_device)
    before = tracing.launches()
    out, diff = warp.warp_forward(image, disp)
    d_img = warp.warp_backward(disp, d_out)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert [after[k] - before[k] for k in ("warp_forward", "warp_backward")] == [1, 1]
    want_out, want_diff = warp.warp_forward_torch(image, disp)
    # the same two float32 products (no FMA contraction on either side)
    assert (out - want_out).abs().max().item() <= 1e-6
    assert (diff - want_diff).abs().max().item() <= 1e-6
    # the same fixed-point sum on both sides: equal bit for bit
    assert torch.equal(bits(d_img), bits(warp.warp_backward_torch(disp, d_out)))


def vertex_scene(seed, n, deg, device):
    """A random vertex-stage input: `scene`'s draw at SH degree `deg` (max
    degree 3, all 15 rest coefficients drawn), with rows behind the camera,
    inside the cull and inactive, before a camera turned about two axes (no
    product with it is exact)."""
    rng = np.random.default_rng(seed)
    model, cam = scene(seed, n, 400, 300, device)
    p = model.params
    xyz = p.xyz.clone()
    xyz[: n // 20, 2] = torch.from_numpy(rng.uniform(-3.0, 0.2, n // 20)).float().to(device)
    f_rest = torch.from_numpy(rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.2).to(device)
    active = torch.from_numpy(rng.random(n) > 0.05).to(device)
    params = dict(xyz=xyz, f_dc=p.f_dc, f_rest=f_rest, opacity=p.opacity, scaling=p.scaling,
                  rotation=p.rotation)
    R = np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]])
    R = R @ np.array([[1.0, 0.0, 0.0], [0.0, 0.995, -0.0998], [0.0, 0.0998, 0.995]])
    cam = make_camera(R, np.array([0.05, -0.02, 0.1]), 0.9, 0.7, 400, 300, device=device)
    return GaussianModel(GaussianParams(**params), active, 3, deg), cam


def plain_vertex_stage(model, cam, carrier):
    """project_gaussians on the card (the plain version) from the raw
    leaves, and the leaves it differentiates."""
    leaves = [getattr(model.params, n).clone().requires_grad_(True) for n in PARAM_NAMES]
    xyz, f_dc, f_rest, opacity, scaling, rotation = leaves
    proj = project_gaussians(
        xyz=xyz, scaling=torch.exp(scaling), rotation_raw=rotation,
        opacity=torch.sigmoid(opacity)[..., 0], features=torch.cat([f_dc, f_rest], 1),
        active=model.active, camera=cam, sh_degree=model.active_sh_degree,
        mean2d_carrier=carrier)
    return proj, leaves


# the kernel against project_gaussians on the card: the same float32
# elementwise algebra in the same order, and the camera products and the
# norms rounded as cuBLAS and PyTorch's reductions round them on the card
# as measured (csrc/project.cu), so the fields agree bit for bit there
# (chip_smoke's phase 22 holds that at the cells' sizes). The test holds
# the tolerances of the JAX parity tests, which a library that fused the
# products in another order would still meet: last-bit differences,
# amplified by the homogeneous divide and the pixel scale (mean2d) and by
# the inversion of the 2x2 covariance (conic)
VERTEX_TOL = {
    "mean2d": dict(rtol=1e-5, atol=1e-4),  # pixels
    "depth": dict(rtol=1e-6, atol=1e-6),
    "conic": dict(rtol=1e-4, atol=1e-6),
    "color": dict(rtol=1e-6, atol=1e-6),
    "opacity": dict(rtol=1e-6, atol=1e-7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("with_carrier", [True, False], ids=["carrier", "no_carrier"])
def test_vertex_forward_kernel_matches_plain(cuda_device, deg, with_carrier):
    n = 20_000
    model, cam = vertex_scene(deg, n, deg, cuda_device)
    carrier = (torch.randn(n, 2, generator=torch.Generator().manual_seed(deg)) * 1e-3).to(
        cuda_device) if with_carrier else None
    before = tracing.launches()
    with torch.no_grad():
        got = project_for_render(cam, model, mean2d_carrier=carrier)
        want, _ = plain_vertex_stage(model, cam, carrier)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert after["project_forward"] == before["project_forward"] + 1
    assert after["project_backward"] == before["project_backward"]
    assert torch.equal(got.visible, want.visible)
    assert 0.5 * n < int(got.visible.sum()) < n
    for name, tol in VERTEX_TOL.items():
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **tol, msg=name)
    # radius = ceil(3 sqrt(lambda_max)): a row may differ by 1 only where
    # that value sits within a few ulps of an integer; bin_extent is capped
    # at the radius and may differ with it there
    cov2d = ewa_cov2d(model.params.xyz, compute_cov3d(torch.exp(model.params.scaling),
                                                      model.params.rotation), cam, 0.3,
                      valid=want.visible)
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    r = 3.0 * torch.sqrt(torch.clamp(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1)),
                                     min=0.0))
    differ = got.radius != want.radius
    near = (r - torch.round(r)).abs() <= 8 * torch.finfo(torch.float32).eps * r
    assert torch.all((got.radius - want.radius).abs()[differ] == 1)
    assert torch.all(near[differ]), int(differ.sum())
    assert int(differ.sum()) <= n // 1000
    torch.testing.assert_close(got.bin_extent[~differ], want.bin_extent[~differ], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 3])
@pytest.mark.parametrize("with_carrier", [True, False], ids=["carrier", "no_carrier"])
def test_vertex_backward_kernel_matches_autograd(cuda_device, deg, with_carrier):
    n = 20_000
    model, cam = vertex_scene(10 + deg, n, deg, cuda_device)
    g = torch.Generator().manual_seed(deg + 2 * with_carrier)
    carrier = torch.zeros(n, 2, device=cuda_device) if with_carrier else None
    cots = [torch.randn(shape, generator=g).to(cuda_device)
            for shape in ((n, 2), (n,), (n, 3), (n, 3), (n,))]
    c = carrier.clone().requires_grad_(True) if with_carrier else None
    want_proj, leaves = plain_vertex_stage(model, cam, c)
    outs = [want_proj.mean2d, want_proj.depth, want_proj.conic, want_proj.color,
            want_proj.opacity]
    want = torch.autograd.grad(outs, leaves + ([c] if with_carrier else []), grad_outputs=cots)
    before = tracing.launches()
    got = project_backward(*(getattr(model.params, k) for k in PARAM_NAMES), model.active, cam,
                           deg, 0.3, 0.2, *cots, with_carrier)
    torch.cuda.synchronize()
    assert tracing.launches()["project_backward"] == before["project_backward"] + 1
    plain = project_backward_torch(*(getattr(model.params, k) for k in PARAM_NAMES),
                                   model.active, cam, deg, 0.3, 0.2, *cots, with_carrier)
    # against autograd: the same float32 derivatives in another order of
    # operations (and the forward's cuBLAS products), row by row as on the
    # CPU (tests/test_torch_project.py), 1e-3 of the row's largest entry;
    # against project_backward_torch: the same formulas in the same order,
    # the SH constants' roundings and the transcendentals' implementations
    # aside, 1e-5
    names = PARAM_NAMES + (("carrier",) if with_carrier else ())
    for name, w, k, pl in zip(names, want, got, plain):
        w, k, pl = w.reshape(n, -1), k.reshape(n, -1), pl.reshape(n, -1)
        row = w.abs().amax(1, keepdim=True)
        assert torch.all((k - w).abs() <= 1e-3 * row), (name, ((k - w).abs() / row).max())
        row = pl.abs().amax(1, keepdim=True)
        assert torch.all((k - pl).abs() <= 1e-5 * row), (name, ((k - pl).abs() / row).max())
    if with_carrier:
        assert torch.all(got[6][~want_proj.visible] == 0)
    else:
        assert got[6] is None
    # and what the kernel sees through autograd: the Function's gradients
    model_leaves = [getattr(model.params, n).clone().requires_grad_(True) for n in PARAM_NAMES]
    m2 = GaussianModel(GaussianParams(**dict(zip(PARAM_NAMES, model_leaves))), model.active, 3,
                       deg)
    proj = project_for_render(cam, m2, mean2d_carrier=carrier)
    via = torch.autograd.grad([proj.mean2d, proj.depth, proj.conic, proj.color, proj.opacity],
                              model_leaves, grad_outputs=cots)
    for a, b in zip(via, got):
        assert torch.equal(a, b)


def bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,W,spread", [
    (1, 20, 64, 4.0),  # one channel
    (3, 8, 2500, 40.0),  # 90 KB of shared memory, past the 48 KB default
    (3, 13, 37, 6.0),  # W odd: the scalar path
    (2, 5, 1, 1.0),  # W = 1: no valid pixel
])
def test_warp_backward_shapes_bit_equal(cuda_device, C, H, W, spread):
    g = torch.Generator().manual_seed(W)
    disp = ((torch.rand(H, W, generator=g) - 0.5) * spread).to(cuda_device)
    d_out = torch.randn(C, H, W, generator=g).to(cuda_device)
    d_img = warp.warp_backward(disp, d_out)
    torch.cuda.synchronize()
    assert torch.equal(bits(d_img), bits(warp.warp_backward_torch(disp, d_out)))


@pytest.mark.cuda
def test_warp_backward_stress_rows_bit_equal(cuda_device):
    """Rows that stress the scale and the non-finite rule: zero, huge among
    small, subnormal results, s > 127, +inf, -inf, NaN, +inf meeting -inf,
    0 * inf, and a non-finite value at an invalid pixel."""
    g = torch.Generator().manual_seed(11)
    H, W = 10, 40
    disp = ((torch.rand(H, W, generator=g) - 0.5) * 6).to(cuda_device)
    disp[:, 1:3] = 0.5
    disp[:, 6] = 1.0
    disp[:, 39] = 3.0  # invalid
    d_out = torch.randn(3, H, W, generator=g)
    d_out[:, 0] = 0.0
    d_out[0, 1, 5] = 1e20
    d_out[:, 2] *= 1e-42
    d_out[:, 3] *= 1e-36
    d_out[0, 4, 1] = float("inf")
    d_out[1, 5, 1] = -float("inf")
    d_out[2, 6, 1], d_out[2, 6, 2] = float("inf"), -float("inf")
    d_out[0, 7, 1] = float("nan")
    d_out[1, 8, 6] = float("inf")
    d_out[:, 9, 39] = float("inf")
    d_out = d_out.to(cuda_device)
    d_img = warp.warp_backward(disp, d_out)
    torch.cuda.synchronize()
    want = warp.warp_backward_torch(disp, d_out)
    assert torch.equal(bits(d_img), bits(want))
    assert want.isnan().any() and want.isinf().any() and (want[:, 0] == 0).all()


@pytest.mark.cuda
def test_warp_backward_repeat_launches_identical(cuda_device):
    g = torch.Generator().manual_seed(12)
    disp = ((torch.rand(96, 160, generator=g) - 0.5) * 8).to(cuda_device)
    d_out = torch.randn(3, 96, 160, generator=g).to(cuda_device)
    first = warp.warp_backward(disp, d_out)
    for _ in range(5):
        assert torch.equal(bits(warp.warp_backward(disp, d_out)), bits(first))


def ssim_images(seed, shape, device):
    """A random image and a noisy copy of it in [0, 1], as render and
    ground truth."""
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand(shape, generator=g)
    return (gt + 0.1 * torch.randn(shape, generator=g)).clamp(0, 1).to(device), gt.to(device)


def max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def pinned_conv():
    torch_v, cuda_v = losses.SSIM_CONV_PINNED
    return (f"S1 sums each blur as conv_depthwise2d of PyTorch {torch_v} with CUDA {cuda_v} "
            f"does; this card runs PyTorch {torch.__version__} with CUDA {torch.version.cuda}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 1512, 2016), (1, 3, 400, 400), (2, 3, 300, 400)],
                         ids=["llff", "blender", "batch"])
def test_ssim_plain_blur_runs_conv_depthwise2d(cuda_device, shape):
    """The plain composition's five blurs, which S1's maps equal bit for
    bit, run as five launches of PyTorch's conv_depthwise2d forward kernel
    (not cuDNN's convolutions): S1 follows that kernel's order of sums."""
    from torch.profiler import ProfilerActivity, profile

    x, y = ssim_images(5, shape, cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        losses.ssim_torch(x, y)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    depthwise = sum(n for k, n in kernels.items() if "conv_depthwise2d_forward" in k)
    assert depthwise == 5, (sorted(kernels), pinned_conv())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size_average", [
    ((3, 1512, 2016), True), ((3, 300, 400), True), ((2, 3, 300, 400), True),
    ((2, 3, 300, 400), False)], ids=["llff", "dtu", "batch", "batch_per_image"])
def test_ssim_kernels_match_plain(cuda_device, shape, size_average):
    """S1's maps equal ssim_maps_torch's bit for bit (its blurs sum as the
    plain composition's depthwise convolution does, its algebra in the same
    order) and its mean the plain composition's (summed in another order:
    ~1e-7); S2's gradient against autograd of the plain composition and
    against ssim_backward_torch of S1's maps (S2 blurs separably and sums
    the three blurred terms, which nearly cancel, in its own order: ~3e-6 of
    the largest entry)."""
    x, y = ssim_images(0, shape, cuda_device)
    up = torch.linspace(-1.0, 1.0, 1 if size_average else shape[0], device=cuda_device)
    up = up.reshape(()) if size_average else up
    before = tracing.launches()
    value, maps = losses.ssim_forward(x[None] if x.ndim == 3 else x,
                                      y[None] if y.ndim == 3 else y, size_average, maps=True)
    want_value, want_maps = losses.ssim_maps_torch(x, y, size_average)
    assert float((value - want_value).abs().max()) <= 1e-6
    for got, want in zip(maps, want_maps):
        assert torch.equal(got.reshape(want.shape), want), pinned_conv()
    xg = x.clone().requires_grad_()
    got_value = losses.ssim(xg, y, size_average=size_average)
    (dx,) = torch.autograd.grad(got_value, [xg], grad_outputs=up)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert (after["ssim_forward"] - before["ssim_forward"],
            after["ssim_backward"] - before["ssim_backward"]) == (2, 1)
    assert torch.equal(got_value, value)
    xp = x.clone().requires_grad_()
    (want_dx,) = torch.autograd.grad(losses.ssim_torch(xp, y, size_average=size_average), [xp],
                                     grad_outputs=up)
    assert max_rel(dx, want_dx) <= 1e-4
    maps_t = tuple(m.reshape(x.shape) for m in maps)
    assert max_rel(dx, losses.ssim_backward_torch(x, y, maps_t, up, size_average)) <= 1e-4


@pytest.mark.cuda
def test_ssim_of_a_non_contiguous_view(cuda_device):
    """The top half of each image (benchmark.calibrate's half_batch): the
    kernels take the view's contiguous copy, and the gradient reaches the
    full tensor's top half only."""
    x, y = ssim_images(1, (3, 600, 400), cuda_device)
    xg = x.clone().requires_grad_()
    top = xg[..., :300, :]
    assert not top.is_contiguous()
    (dx,) = torch.autograd.grad(losses.ssim(top, y[..., :300, :]), [xg])
    xc = x[..., :300, :].contiguous().requires_grad_()
    value_c = losses.ssim(xc, y[..., :300, :].contiguous())
    (dx_c,) = torch.autograd.grad(value_c, [xc])
    assert torch.equal(dx[..., :300, :], dx_c)
    assert not dx[..., 300:, :].any()
    with torch.no_grad():
        assert torch.equal(losses.ssim(x[..., :300, :], y[..., :300, :]), value_c)


@pytest.mark.cuda
def test_ssim_kernels_repeat_bit_for_bit(cuda_device):
    x, y = ssim_images(2, (3, 1512, 2016), cuda_device)
    runs = []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        value = losses.ssim(xg, y)
        (dx,) = torch.autograd.grad(value, [xg], grad_outputs=torch.tensor(-0.2, device=x.device))
        per_image = losses.ssim(x[None], y[None], size_average=False)
        runs.append([t.view(torch.int32) for t in (value.detach(), dx, per_image)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_ssim_without_a_gradient_writes_no_maps(cuda_device):
    """Under no_grad (and for an image that needs no gradient) S1 runs
    alone and allocates no map: its scratch is one float per tile."""
    x, y = ssim_images(3, (3, 1512, 2016), cuda_device)
    image_bytes = x.numel() * 4
    xg = x.clone().requires_grad_()
    for grad, img, n_maps in ((False, xg, 0), (True, x, 0), (True, xg, 3)):
        before = tracing.launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(grad):
            value = losses.ssim(img, y)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        after = tracing.launches()
        assert after["ssim_forward"] - before["ssim_forward"] == 1
        assert after["ssim_backward"] == before["ssim_backward"]
        assert n_maps * image_bytes <= extra < (n_maps + 1) * image_bytes, (grad, extra)
        assert value.requires_grad == bool(n_maps)


@pytest.mark.cuda
def test_ssim_records_its_counter_and_backward_range(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    x, y = ssim_images(4, (2, 3, 64, 96), cuda_device)
    xg = x.clone().requires_grad_()
    t0 = __import__("time").time_ns()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.autograd.grad(losses.ssim(xg, y), [xg])
        torch.cuda.synchronize()
    snap = tracing.snapshot(since_ns=t0)
    assert [c["value"] for c in snap["counters"] if c["name"] == "loss.ssim_elems"] == [
        2 * 3 * 64 * 96]
    assert [r["name"] for r in snap["ranges"]].count("step.ssim.backward") == 1


@pytest.mark.cuda
def test_train_step_counts_launches(cuda_device):
    model, cam = scene(4, 200, 96, 64, cuda_device)
    state = init_train_state(model)
    step = make_train_step(
        lambda c, m, bg, mean2d_carrier=None: render_tiled(c, m, bg, device=cuda_device,
                                                           mean2d_carrier=mean2d_carrier),
        Config(), 1.0, binocular=True, use_alpha_weight=False)
    gt = torch.rand(3, 64, 96, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    aw = torch.zeros(64, 96, device=cuda_device)
    before = tracing.launches()
    state, metrics = step(state, cam, gt, aw, 2, 0.2, torch.zeros(3, device=cuda_device))
    torch.cuda.synchronize()
    after = tracing.launches()
    per_step = dict(blend_forward=2, blend_backward=2, warp_forward=1, warp_backward=1,
                    blend_plan=2, blend_chunk=2,
                    project_forward=2, project_backward=2, ssim_forward=1, ssim_backward=1,
                    gather_forward=2, gather_transpose=2, gather_backward=2,
                    **{k: 2 * v for k, v in bin_launches(6 * 4).items()})
    assert after - before == collections.Counter(per_step)
    assert torch.isfinite(metrics.loss) and float(metrics.disparity_loss) > 0


def state_bits(state):
    """Every float buffer of a TrainState as int32 views (NaNs compare)."""
    trees = (state.model.params, state.adam_m, state.adam_v)
    out = [getattr(t, n).view(torch.int32) for t in trees for n in
           ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")]
    return out + [getattr(state, n).view(torch.int32)
                  for n in ("grad_accum", "denom", "max_radii2d")]


@pytest.mark.cuda
def test_train_step_repeats_bit_for_bit(cuda_device):
    """Two runs of 4 binocular steps from one state: every parameter, both
    Adam moments, the densification statistics and the losses equal bit
    for bit (the record gathers' fixed-order backward, cuDNN's deterministic
    convolutions, W2's fixed-point sum)."""
    runs = []
    for _ in range(2):
        model, cam = scene(7, 3000, 256, 192, cuda_device)
        state = init_train_state(model)
        step = make_train_step(
            lambda c, m, bg, mean2d_carrier=None: render_tiled(
                c, m, bg, device=cuda_device, mean2d_carrier=mean2d_carrier),
            Config(), 1.0, binocular=True, use_alpha_weight=False)
        gt = torch.rand(3, 192, 256, generator=torch.Generator().manual_seed(1)).to(cuda_device)
        aw = torch.zeros(192, 256, device=cuda_device)
        losses = []
        for it, trans in zip(range(2, 6), (0.2, -0.3, 0.1, -0.05)):
            state, m = step(state, cam, gt, aw, it, trans, torch.zeros(3, device=cuda_device))
            losses.append((m.loss + m.disparity_loss).view(torch.int32).item())
        runs.append((state_bits(state), losses))
    (a, la), (b, lb) = runs
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_a_range_holds_its_kernels_on_the_device_clock(cuda_device):
    """A range around a matrix product and a synchronize holds the
    product's kernels as the profiler stamps them on the device: the
    ranges' clock is the device events' clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(2048, 2048, device=cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.region("probe.mm"):
            a @ a
            torch.cuda.synchronize()
    probe = [r for r in tracing.snapshot()["ranges"] if r["name"] == "probe.mm"][-1]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    kernels = [e for e in events if not e.is_user_annotation()]
    print(f"{len(kernels)} device events, {len(events) - len(kernels)} device annotations")
    assert kernels
    for e in kernels:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        print(f"{e.name()[:60]}: starts {start - probe['start_ns']} ns after the range, "
              f"ends {probe['end_ns'] - end} ns before its end")
        assert probe["start_ns"] <= start and end <= probe["end_ns"]


def toy_trainer(device, eager=False, n_points=30):
    """A trainer of a 3-view toy scene (`n_points` points, 40x30, the
    cameras turned about two axes, so that the camera products round) after
    16 iterations: its next steps are binocular, and iterations 17-20 are
    one span that ends in a densification. With `eager` its steps run
    eagerly (not replayed as CUDA graphs) from the first."""
    from binocular3dgs_torch.data.dataset import Scene, View
    from binocular3dgs_torch.data.ply import PointCloud
    from binocular3dgs_torch.data.readers import SceneInfo
    from binocular3dgs_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n_points, 3)) * 0.4 + [0, 0, 4]
    def turned(a, b):
        ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
        return (np.array([[ca, 0.0, sa], [0.0, 1.0, 0.0], [-sa, 0.0, ca]])
                @ np.array([[1.0, 0.0, 0.0], [0.0, cb, -sb], [0.0, sb, cb]]))

    views = [View(make_camera(turned(0.07 * (i - 1), 0.05 + 0.03 * i),
                              np.array([tx, 0.01 * i, 0.0]), 0.9, 0.7, 40, 30, device="cpu"),
                  rng.random((30, 40, 3)).astype(np.float32), None, f"v{i}", i, i)
             for i, tx in enumerate((-0.1, 0.0, 0.1))]
    info = SceneInfo(PointCloud(points=pts, colors=rng.random((n_points, 3))), [], [],
                     {"radius": 1.0, "translate": np.zeros(3)}, None)
    cfg = Config()
    cfg.opt.densify_from_iter, cfg.opt.densification_interval = 5, 10
    cfg.opt.densify_grad_threshold = 1e-5
    cfg.train.shift_cam_start = 15
    cfg.train.test_iterations = cfg.train.save_iterations = ()
    trainer = Trainer(cfg, Scene(views, [], 1.0, info), device=device)
    if eager:
        trainer.steps = {b: step.eager for b, step in trainer.steps.items()}
    trainer.train(16)
    return trainer


@pytest.mark.cuda
def test_tracing_adds_no_sync_to_a_span(cuda_device):
    """Under the sync debug mode, one fused span of eager binocular steps
    (17-20, with its read and densification) warns no more often while a
    profiler traces than without one; the traced span records the
    backward's ranges from autograd's device thread. (A replayed step runs
    no backward on the host: `test_graphed_span_syncs_no_more_than_eager`.)"""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    def span_syncs(trainer):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.train(20, first_iteration=17)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return [str(w.message) for w in caught if "synchroniz" in str(w.message)]

    off = span_syncs(toy_trainer(cuda_device, eager=True))
    trainer = toy_trainer(cuda_device, eager=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        main = threading.get_ident()
        on = span_syncs(trainer)
    print(f"sync warnings in the span: {len(off)} untraced, {len(on)} traced")
    assert len(on) <= len(off)
    backward = [r for r in tracing.snapshot()["ranges"] if r["name"] == "render.blend.backward"
                and r["iteration"] in range(17, 21)]
    assert len(backward) == 8 and all(r["thread"] != main for r in backward)


def clone_train_state(state):
    """A copy of every buffer of `state`, as the benchmark's restore makes."""
    return state.with_buffers([t.clone() for t in state.buffers()])


def run_toy_spans(device, eager, traced=False, n_points=30):
    """A toy trainer (graphed, or eager from the first step) run through
    17-25 (two spans: 17-20 ends in a densification), its state then
    swapped for a copy of the state at 16 with the draws reseeded (as the
    benchmark's restore does) and run through 17-25 again, under a profiler
    with `traced`. Returns every buffer as int32 views (`bits`), each
    step's losses (`losses`, int32 views) and counts (`counts`) kept over
    both runs and read after the last, the kernel launches of the two runs
    (`launches`), the counters the second run recorded (`counters`, sorted,
    without the graphs' own) and, graphed, its replays (`replays`)."""
    import random

    from torch.profiler import ProfilerActivity, profile

    trainer = toy_trainer(device, eager=eager, n_points=n_points)
    start, seed = clone_train_state(trainer.state), trainer.cfg.train.seed + 1
    kept, steps = [], dict(trainer.steps)

    def keep(state, *args):
        state, metrics = steps[True](state, *args)
        kept.append(metrics)
        return state, metrics

    trainer.steps = {**steps, True: keep}
    before = tracing.launches()
    trainer.train(25, first_iteration=17)
    trainer.state = clone_train_state(start)
    trainer.rng, trainer.generator = random.Random(seed), torch.Generator().manual_seed(seed)
    replays = None if eager else steps[True].graphs.replays
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext():
        trainer.train(25, first_iteration=17)
    torch.cuda.synchronize()
    out = dict(launches=tracing.launches() - before, bits=state_bits(trainer.state))
    if not eager:
        out["replays"] = steps[True].graphs.replays - replays
    out["counters"] = sorted((c["iteration"] or 0, c["name"], c["value"])
                             for c in tracing.snapshot(since_ns=t0)["counters"]
                             if not c["name"].startswith("step.graph_")) if traced else []
    out["losses"] = torch.stack([torch.stack([m.loss, m.l1, m.disparity_loss, m.alpha_loss])
                                 for m in kept]).view(torch.int32).tolist()
    out["counts"] = [[int(m.n_visible), int(m.num_pairs), int(m.max_tile_pairs)] for m in kept]
    return out


@pytest.mark.cuda
def test_graphed_trainer_equals_the_eager_trainer(cuda_device):
    """The trainer's steps replayed as CUDA graphs and the same steps run
    eagerly, over two spans that cross a densification and a state swapped
    in as the benchmark's restore does: every buffer bit for bit, and every
    step's losses and counts kept by the caller across the spans and read
    after the last (a replay overwrites no earlier step's metrics)."""
    graphed = run_toy_spans(cuda_device, eager=False)
    eager = run_toy_spans(cuda_device, eager=True)
    assert graphed["replays"] == 9
    assert all(torch.equal(a, b) for a, b in zip(graphed["bits"], eager["bits"]))
    assert graphed["losses"] == eager["losses"] and graphed["counts"] == eager["counts"]
    assert len(graphed["losses"]) == 18 and len({tuple(v) for v in graphed["losses"]}) > 9


@pytest.mark.cuda
def test_graphed_trainer_equals_the_eager_trainer_on_long_tiles(cuda_device):
    """The same with 3,000 points in the toy scene's six tiles, which the
    blend walks in chunks: the replays equal the eager steps bit for bit."""
    graphed = run_toy_spans(cuda_device, eager=False, n_points=3000)
    eager = run_toy_spans(cuda_device, eager=True, n_points=3000)
    assert graphed["replays"] == 9
    assert min(c[2] for c in graphed["counts"]) > BLEND_CHUNK
    assert all(torch.equal(a, b) for a, b in zip(graphed["bits"], eager["bits"]))
    assert graphed["losses"] == eager["losses"] and graphed["counts"] == eager["counts"]


@pytest.mark.cuda
def test_graphed_trainer_counts_launches_and_counters_as_eager(cuda_device):
    """`tracing.launches()` counts a replay's captured kernels, and a
    traced replay gives its capture's counters again with this replay's
    device values: both equal the eager trainer's, step for step."""
    graphed = run_toy_spans(cuda_device, eager=False, traced=True)
    eager = run_toy_spans(cuda_device, eager=True, traced=True)
    assert graphed["replays"] == 9
    assert graphed["launches"] == eager["launches"]
    assert graphed["launches"]["blend_backward"] == 2 * 18
    assert graphed["counters"] == eager["counters"]
    names = collections.Counter(c[1] for c in graphed["counters"])
    assert names["render.pairs_wanted"] == names["render.bin_slots"] == 2 * 9
    assert names["step.visible"] == 9 and names["loss.ssim_elems"] == 9


@pytest.mark.cuda
def test_graphed_trainer_repeats_bit_for_bit(cuda_device):
    """Two graphed runs of the same spans: every buffer and every kept
    metric equal bit for bit."""
    a, b = run_toy_spans(cuda_device, eager=False), run_toy_spans(cuda_device, eager=False)
    assert all(torch.equal(x, y) for x, y in zip(a["bits"], b["bits"]))
    assert a["losses"] == b["losses"] and a["counts"] == b["counts"]


@pytest.mark.cuda
def test_a_bias_correction_factor_divides_as_the_card_does(cuda_device):
    """The card divides a float32 tensor by a host number as a multiply by
    the number's reciprocal rounded from double: the factor that
    `bias_corrections` gives, in a 0-d tensor (a graph's input) or as a
    number, has the bits of the division at every step of both cells'
    blocks (the reciprocal taken in float32 would differ at 4006-4007)."""
    import numpy as np

    from binocular3dgs_torch.train.state import bias_corrections

    v = torch.rand(1 << 20, generator=torch.Generator().manual_seed(3)).to(cuda_device) * 1e-6
    for step in [*range(0, 8), *range(4001, 4102), *range(20001, 20010)]:
        b1t_inv, b2t_inv = bias_corrections(step)
        for inv, b in ((b1t_inv, 0.9), (b2t_inv, 0.999)):
            divisor = 1.0 - float(np.float32(b) ** np.float32(step + 1))
            want = (v / divisor).view(torch.int32)
            assert torch.equal((v * torch.tensor(inv, device=cuda_device)).view(torch.int32),
                               want), step
            assert torch.equal((v * inv).view(torch.int32), want), step


@pytest.mark.cuda
def test_a_dead_trainers_graphs_go_before_another_capture(cuda_device):
    """A trainer dropped with its graphs is cyclic garbage (its steps hold
    its render); freeing a graph inside another trainer's capture would
    invalidate that capture. With the collector run at every chance, a
    second trainer still captures and trains."""
    import gc

    first = toy_trainer(cuda_device)
    assert first.steps[True].graphs.captures >= 1
    del first
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        second = toy_trainer(cuda_device)
        second.train(20, first_iteration=17)
    finally:
        gc.set_threshold(*thresholds)
    assert second.steps[True].graphs.replays >= 4


@pytest.mark.cuda
def test_graphed_span_syncs_no_more_than_eager(cuda_device):
    """Staging a replay's inputs (device copies and fills) adds no host
    sync: a graphed span of binocular steps warns no more often under the
    sync debug mode than the eager one; every step of it is a replay."""
    import warnings

    def span_syncs(trainer):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.train(19, first_iteration=17)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return [str(w.message) for w in caught if "synchroniz" in str(w.message)]

    eager = span_syncs(toy_trainer(cuda_device, eager=True))
    trainer = toy_trainer(cuda_device)
    graphs = trainer.steps[True].graphs
    replays, captures = graphs.replays, graphs.captures
    graphed = span_syncs(trainer)
    assert len(graphed) <= len(eager)
    assert (graphs.replays - replays, graphs.captures - captures) == (3, 0)


@pytest.mark.cuda
def test_gather_segment_sum_repeats_and_matches_cpu(cuda_device):
    from binocular3dgs_torch.ops.rasterize import segment_sum_columns

    g = torch.Generator().manual_seed(5)
    d = torch.randn(10, 200_000, generator=g)
    idx = torch.randint(0, 3000, (200_000,), generator=g)
    want = segment_sum_columns(d, idx, 3000)
    first = segment_sum_columns(d.to(cuda_device), idx.to(cuda_device), 3000)
    for _ in range(3):
        again = segment_sum_columns(d.to(cuda_device), idx.to(cuda_device), 3000)
        assert torch.equal(bits(again), bits(first))
    assert ((first.cpu() - want).abs() <= 1e-5 * want.abs().amax(1, keepdim=True)).all()


def binning_inputs(seed, n, W, H, device, extent=(0.5, 24.0), culled=0.3, per_axis=True,
                   crowd=0):
    """Random splats for binning: centres over the image and a 32 px
    margin, extents in `extent` px (per axis, or isotropic), a `culled`
    share with extent 0, depths in [1, 9); the first `crowd` splats small
    and in one tile."""
    g = torch.Generator(device=device).manual_seed(seed)
    size = torch.tensor([W + 64.0, H + 64.0], device=device)
    mean2d = torch.rand(n, 2, generator=g, device=device) * size - 32.0
    ext = extent[0] + torch.rand(n, 2, generator=g, device=device) * (extent[1] - extent[0])
    ext[torch.rand(n, generator=g, device=device) < culled] = 0.0
    depth = torch.rand(n, generator=g, device=device) * 8.0 + 1.0
    if crowd:
        mean2d[:crowd] = torch.tensor([W / 2 + 3.0, H / 2 + 3.0], device=device)
        ext[:crowd] = 2.0
    return mean2d, ext if per_axis else ext[:, 0].contiguous(), depth


# name, rows, W, H, pairs per row, binning_inputs' options
BIN_CASES = [
    ("llff", 2**20, 2016, 1512, 12, dict(culled=0.7)),
    ("blender", 2**18, 400, 400, 12, dict(culled=0.6, extent=(0.5, 40.0))),
    ("overflow", 20_000, 640, 480, 1, dict(extent=(8.0, 120.0))),
    ("all_culled", 5_000, 320, 240, 12, dict(culled=1.0)),
    ("crowded_tile", 20_000, 256, 256, 12, dict(crowd=10_000)),
    ("isotropic", 50_000, 1008, 756, 12, dict(per_axis=False)),
    ("full_res_llff", 2**18, 4032, 3024, 12, dict(culled=0.5)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,W,H,ppg,kw", BIN_CASES, ids=[c[0] for c in BIN_CASES])
def test_binning_kernels_equal_the_plain_binning(cuda_device, name, n, W, H, ppg, kw):
    """Every output of csrc/binning.cu's binning equals bin_gaussians_torch's
    on the card: the pair arrays on the sorted slots, the rest whole; the
    launches are counted."""
    mean2d, ext, depth = binning_inputs(n + len(name), n, W, H, cuda_device, **kw)
    cap = ppg * n
    T = tile_grid(W, H, TS)[0] * tile_grid(W, H, TS)[1]
    before = tracing.launches()
    got = bin_gaussians(mean2d, ext, depth, W, H, TS, cap)
    torch.cuda.synchronize()
    after = tracing.launches()
    want = bin_gaussians_torch(mean2d, ext, depth, W, H, TS, cap)
    assert {k: after[k] - before[k] for k in bin_launches(T)} == bin_launches(T)
    E = int(want.bin_slots)
    for f in ("order", "tile_start", "tile_count", "num_pairs", "rank_offsets", "rank_of",
              "bin_slots"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("pair_gauss", "pair_tile", "sorted_pos"):
        assert torch.equal(getattr(got, f)[:E], getattr(want, f)[:E]), f
    wanted = int(want.num_pairs)
    if name == "overflow":
        assert wanted > 4 * cap and E == cap
    elif name == "all_culled":
        assert wanted == E == 0 and not want.tile_count.any()
    elif name == "crowded_tile":
        assert int(want.tile_count.max()) > 4096  # more than one block of the sort
    elif name == "full_res_llff":
        assert T == 47_628 and E > 0
    else:
        assert 0 < E == wanted < cap


@pytest.mark.cuda
def test_binning_kernels_on_a_band(cuda_device):
    """The band mode's input: centres shifted up by the band's first tile
    row, the image `tile_rows` tile rows high."""
    W, full_h, start, rows = 1008, 756, 20, 8
    mean2d, ext, depth = binning_inputs(11, 50_000, W, full_h, cuda_device)
    mean2d = mean2d - torch.tensor([0.0, start * TS], device=cuda_device)
    got = bin_gaussians(mean2d, ext, depth, W, rows * TS, TS, 12 * 50_000)
    want = bin_gaussians_torch(mean2d, ext, depth, W, rows * TS, TS, 12 * 50_000)
    E = int(want.bin_slots)
    assert 0 < E < int(bin_gaussians_torch(mean2d, ext, depth, W, full_h, TS, 1).num_pairs)
    for f in ("order", "tile_start", "tile_count", "num_pairs", "rank_offsets", "rank_of"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("pair_gauss", "pair_tile", "sorted_pos"):
        assert torch.equal(getattr(got, f)[:E], getattr(want, f)[:E]), f


def spread_index(b, n):
    """The plain gather's column per slot, with the slots past the emitted
    pairs spread over the columns (their cotangents are 0; as one column
    they would make its segment as long as the capacity's unused tail)."""
    P = b.pair_gauss.shape[0]
    spread = torch.arange(P, device=b.pair_gauss.device, dtype=torch.int32) % n
    return torch.where(torch.arange(P, device=spread.device) < b.bin_slots, b.pair_gauss, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,W,H,ppg,kw", [BIN_CASES[0], BIN_CASES[1], BIN_CASES[2]],
                         ids=["llff", "blender", "overflow"])
def test_gather_backward_equals_segment_sum_bit_for_bit(cuda_device, name, n, W, H, ppg, kw):
    mean2d, ext, depth = binning_inputs(n + 7, n, W, H, cuda_device, **kw)
    b = bin_gaussians(mean2d, ext, depth, W, H, TS, ppg * n)
    plain = bin_gaussians_torch(mean2d, ext, depth, W, H, TS, ppg * n)
    P, E = ppg * n, int(b.bin_slots)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    d = torch.randn(10, P, generator=g, device=cuda_device) * 10.0 ** (
        torch.rand(10, P, generator=g, device=cuda_device) * 12.0 - 6.0)
    d[:, E:] = 0.0  # the blend's backward writes 0 outside the tiles' segments
    before = tracing.launches()
    got = gather_backward(d, b)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert [after[k] - before[k] for k in ("gather_transpose", "gather_backward")] == [1, 1]
    rows = segment_sum_columns(d, spread_index(plain, n), n)[:, b.rank_of.long()]
    want = (rows[0:2].T, rows[2:5].T, rows[5], rows[6:9].T, rows[9])
    for k, x, y in zip(("mean2d", "conic", "opacity", "color", "depth"), got, want):
        assert torch.equal(bits(x.contiguous()), bits(y.contiguous())), k


def projected_set(seed, n, active, W, H, device):
    """A projected set as the vertex stage leaves it: `active` visible rows
    (centres over the image, conics of 1-8 px sigmas, extents of 3 sigma,
    opacities, colours, depths), the rest culled (zeros, extent 0)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + torch.rand(*shape, generator=g, device=device) * (hi - lo)

    sig = u(active, 2, lo=1.0, hi=8.0)
    rho = u(active, lo=-0.5, hi=0.5)
    det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho * rho)
    cov = torch.stack([sig[:, 1] ** 2, -rho * sig[:, 0] * sig[:, 1], sig[:, 0] ** 2], 1)
    z = torch.zeros
    fields = dict(mean2d=z(n, 2, device=device), depth=z(n, device=device),
                  conic=z(n, 3, device=device), color=z(n, 3, device=device),
                  opacity=z(n, device=device), radius=z(n, device=device),
                  bin_extent=z(n, 2, device=device))
    fields["mean2d"][:active] = u(active, 2) * torch.tensor([W, H], device=device)
    fields["conic"][:active] = cov / det[:, None]
    fields["opacity"][:active] = u(active, lo=0.05, hi=0.99)
    fields["color"][:active] = u(active, 3)
    fields["depth"][:active] = u(active, lo=1.0, hi=9.0)
    fields["bin_extent"][:active] = 3.0 * sig
    fields["radius"][:active] = torch.ceil(3.0 * sig.amax(1))
    return ProjectedGaussians(visible=fields["radius"] > 0, **fields)


def plain_rasterize(cam, proj, bg, raster):
    """rasterize_projected's composition with the plain binning and gather
    (the blend kernels as the card runs them)."""
    from binocular3dgs_torch.ops.blend_cuda import blend_forward as blend

    ts, (TW, TH) = raster.tile_size, tile_grid(cam.width, cam.height, raster.tile_size)
    N = proj.mean2d.shape[0]
    b = bin_gaussians_torch(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, ts,
                            raster.pairs_per_gaussian * N)
    fields_d = torch.index_select(_build_fields(proj), 1, b.order)
    records = _GatherRecords.apply(fields_d, spread_index(b, N))
    out5, _ = blend(records, b.tile_start, b.tile_count, TW, TH, ts)
    planes = _tiles_to_planes(out5, TW, TH, ts, cam.height, cam.width)
    return planes[0:3] + planes[4][None] * bg[:, None, None], planes[3], 1.0 - planes[4]


@pytest.mark.cuda
@pytest.mark.parametrize("n,active,W,H", [(2**20, 285_523, 2016, 1512),
                                          (2**18, 100_000, 400, 400)], ids=["llff", "blender"])
def test_render_forward_backward_equal_the_plain_composition(cuda_device, n, active, W, H):
    """A render's image, depth and alpha and the gradients of the projected
    fields equal the plain binning and gather's bit for bit at both cells'
    shapes; one render launches each binning kernel as counted, one gather
    forward and backward, and the blend's plan, its two forward kernels and
    its backward once each."""
    proj = projected_set(n + active, n, active, W, H, cuda_device)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H, device=cuda_device)
    raster, bg = RasterConfig(), torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    weights = [torch.rand(shape, generator=g, device=cuda_device) - 0.5
               for shape in ((3, H, W), (H, W), (H, W))]
    names = ("mean2d", "conic", "opacity", "color", "depth")

    def run(render):
        leaves = {k: getattr(proj, k).clone().requires_grad_(True) for k in names}
        out = render(cam, proj._replace(**leaves), bg, raster)
        loss = sum((w * x).sum() for w, x in zip(weights, out))
        return [x.detach() for x in out], torch.autograd.grad(loss, list(leaves.values()))

    before = tracing.launches()
    got_out, got_grad = run(lambda *a: (lambda o: (o.image, o.depth, o.alpha))(
        rasterize_projected(*a)))
    torch.cuda.synchronize()
    after = tracing.launches()
    want_out, want_grad = run(plain_rasterize)
    T = tile_grid(W, H, TS)[0] * tile_grid(W, H, TS)[1]
    assert after - before == collections.Counter({
        **bin_launches(T), "gather_forward": 1, "gather_transpose": 1, "gather_backward": 1,
        "blend_plan": 1, "blend_forward": 1, "blend_chunk": 1, "blend_backward": 1})
    for k, x, y in zip(("image", "depth", "alpha"), got_out, want_out):
        assert torch.equal(bits(x), bits(y)), k
    for k, x, y in zip(names, got_grad, want_grad):
        assert torch.equal(bits(x), bits(y)), k
    assert float(got_out[2].mean()) > 0.1  # the set covers the image


@pytest.mark.cuda
def test_bin_slots_counter_and_binning_launches_recorded(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    model, cam = scene(3, 100, 64, 48, cuda_device)
    xyz = model.params.xyz.clone().requires_grad_(True)
    model = GaussianModel(dataclasses.replace(model.params, xyz=xyz), model.active, model.max_sh_degree,
                          model.active_sh_degree)
    t0 = __import__("time").time_ns()
    with profile(activities=[ProfilerActivity.CUDA]):
        out = render_tiled(cam, model, [0.0, 0.0, 0.0], device=cuda_device)
        torch.autograd.grad(out.image.sum(), [xyz])
        torch.cuda.synchronize()
    snap = tracing.snapshot(since_ns=t0)
    value = {c["name"]: c["value"] for c in snap["counters"]}
    assert value["render.bin_slots"] == min(value["render.pairs_wanted"],
                                            value["render.pair_capacity"]) > 0
    names = {c["name"] for c in snap["counters"]}
    for k in (*bin_launches(12), "gather_forward", "gather_transpose", "gather_backward"):
        if bin_launches(12).get(k, 1):
            assert f"kernel.{k}.launches" in names, k


def textured_pair(h, w, seed=0, shift=5):
    """Two grey uint8 images of blobs, the second shifted right by `shift`."""
    from binocular3dgs_torch.init.image_io import resize_linear_f32

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(1, h // 6, (w + shift) // 6, generator=g)
    field = resize_linear_f32(coarse, (w + shift, h))[0]
    img = ((field > 0.5).float() * 180 + 40).to(torch.uint8)
    return img[:, shift:].contiguous(), img[:, :w].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(120, 160), (378, 504)])
def test_farneback_card_matches_cpu(cuda_device, h, w):
    """The flow on the card against the CPU: median end-point difference
    <= 0.01 px, 99th percentile <= 0.1 px (the tolerance held against
    OpenCV on the CPU)."""
    from binocular3dgs_torch.init.farneback import calc_optical_flow_farneback

    a, b = textured_pair(h, w)
    want = calc_optical_flow_farneback(a, b)
    got = calc_optical_flow_farneback(a.to(cuda_device), b.to(cuda_device)).cpu()
    epe = (got - want).norm(dim=-1)
    assert want[..., 0].abs().median() > 1.0
    assert epe.median() <= 0.01 and torch.quantile(epe.flatten(), 0.99) <= 0.1


@pytest.mark.cuda
def test_growth_scorer_card_matches_cpu(cuda_device):
    """The growth scorer on 20,000 candidates (100 seeds x 200, the LLFF
    growth's shape): scores within 1e-5 of the CPU's."""
    from binocular3dgs_torch.init.pipeline import _make_candidate_scorer

    g = torch.Generator().manual_seed(2)
    img_a = torch.rand(189, 252, 3, generator=g)
    img_b = torch.roll(img_a, 3, dims=1)
    cand = torch.randn(20_000, 3, generator=g) * torch.tensor([1.0, 0.8, 0.5]) \
        + torch.tensor([0.0, 0.0, 5.0])
    w2c_a, w2c_b = torch.eye(4), torch.eye(4)
    w2c_b[0, 3] = 0.05
    focal, center = torch.tensor([200.0, 200.0]), torch.tensor([126.0, 94.5])
    args = (cand, img_a, img_b, w2c_a, w2c_b, focal, center)
    score = _make_candidate_scorer(5)
    want = score(*args)
    got = score(*(x.to(cuda_device) for x in args)).cpu()
    assert (want > 0.5).any()
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.cuda
def test_pdcnet_direct_card_matches_cpu(cuda_device):
    """One PDCNet+ `_direct` at full depth (3 global, 7 local iterations) on
    seeded random weights and 96x128 images (the network sees 256x256), on
    the card against the CPU: flow, log-variance, weight and P_R within
    1e-3 of each map's largest value (TF32 off: the sums' order and cuDNN's
    algorithms differ, nothing else); then the RANSAC homography and the
    perspective warp on the card."""
    from binocular3dgs_torch.init.pdcnet.homography import (
        find_homography_ransac,
        warp_perspective,
    )
    from binocular3dgs_torch.init.pdcnet.inference import PDCNetPlus
    from binocular3dgs_torch.init.pdcnet.model import random_model

    weights = random_model(0).state_dict()
    rng = np.random.default_rng(0)
    src, tgt = ((rng.random((96, 128, 3)) * 255).astype(np.uint8) for _ in range(2))
    out = {}
    for dev in ("cpu", cuda_device):
        net = PDCNetPlus(weights, {"multi_stage_type": "d"}, device=dev)
        assert next(net.model.parameters()).device.type == torch.device(dev).type
        flow, unc = net._direct(src, tgt, (24, 32))
        out[str(dev)] = [flow.cpu()] + [unc[k].cpu()
                                        for k in ("log_var_map", "weight_map", "p_r")]
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()

    H = np.array([[1.02, 0.03, 2.0], [-0.02, 0.98, -1.5], [1e-4, -5e-5, 1.0]])
    pts = rng.uniform([0, 0], [128, 96], (2000, 2))
    p = np.c_[pts, np.ones(len(pts))] @ H.T
    dst = p[:, :2] / p[:, 2:]
    true = dst[:600].copy()
    dst[:600] = rng.uniform([0, 0], [128, 96], (600, 2))  # outliers, kept off their true spot
    dst[:600][np.linalg.norm(dst[:600] - true, axis=1) < 3.0] += 4.0
    Hc, mask = find_homography_ransac(torch.from_numpy(pts).to(cuda_device),
                                      torch.from_numpy(dst).to(cuda_device), 1.0)

    def corners(M):
        c = np.array([[0, 0, 1], [128, 0, 1], [0, 96, 1], [128, 96, 1.0]]) @ M.T
        return c[:, :2] / c[:, 2:]

    assert mask.device.type == "cuda" and np.abs(corners(Hc) - corners(H)).max() <= 1e-3
    img = torch.from_numpy((rng.random((96, 128, 3)) * 255).astype(np.float32))
    want = warp_perspective(img, H, (128, 96))
    got = warp_perspective(img.to(cuda_device), H, (128, 96)).cpu()
    assert (got - want).abs().max() <= 1e-3


CARD_BAND_SCENE = (7, 5_000, 256, 192)  # seed, gaussians, width, height
CARD_BAND_RASTER = RasterConfig(pairs_per_gaussian=64)  # no pair dropped


@pytest.mark.cuda
def test_two_rank_band_render_matches_the_single_render(cuda_device, tmp_path):
    """Two gloo ranks on the card (tests/torch_parallel_worker.py) render
    their bands of 6 tile rows each (B1 launched once on each) and gather
    the image, within the CPU tests' tolerances of the single render. The
    pair capacity holds every pair of the single render (these splats span
    many tiles: at the default 12 per gaussian it drops the deepest)."""
    import os
    import sys

    from binocular3dgs_torch.parallel.multihost import run_processes

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
    run_processes([[sys.executable, worker, "card", str(tmp_path), f"file://{tmp_path}/rdv",
                    "2", str(r)] for r in range(2)], timeout=600)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    model, cam = scene(*CARD_BAND_SCENE, cuda_device)
    with torch.no_grad():
        want = render_tiled(cam, model, [0.0, 0.0, 0.0], raster=CARD_BAND_RASTER,
                            device=cuda_device)
    assert int(want.num_pairs) <= want.pair_capacity
    for got in ranks:
        assert int(got["launches"]) == 1
        assert 0 < got["pairs"][0] <= got["pairs"][1]
        np.testing.assert_allclose(got["image"], want.image.cpu().numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["alpha"], want.alpha.cpu().numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["depth"], want.depth.cpu().numpy(), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got["radii"], want.radii.cpu().numpy())
