"""The port's plain blend (blend_forward_torch) against the Pallas kernel
blend_forward_pallas in interpret mode, on the same (16, P) records and tile
ranges; the wrapper's CPU path, input checks and backward on empty tiles; and
the plain mirror of the kernels' cull box (`_alpha_extent`) against the one
alpha expression `_splat`. The CUDA kernel itself is held against the plain version in test_torch_cuda.py
(on a card) and in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops.binning import bin_gaussians, tile_grid
from binocular3dgs_tpu.ops.blend_pallas import blend_forward_pallas
from binocular3dgs_tpu.ops.rasterize import _build_fields, project_for_render
from binocular3dgs_torch import tracing
from binocular3dgs_torch.ops.blend_cuda import (
    ALPHA_MIN,
    _alpha_extent,
    _cell_mask,
    _pixel_cell,
    _splat,
    blend_forward,
    blend_forward_torch,
)

from test_rasterize_tiled import random_scene
from test_render_dense import make_model
from test_torch_project import camera_pair

W, H, TS, CHUNK = 48, 32, 16, 8
T_MIN = 1e-4


def overdraw_scene():
    """The heavy-overdraw / termination scene of test_blend_pallas."""
    n = 60
    rng = np.random.default_rng(2)
    xyz = np.stack(
        [rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n), np.linspace(2, 8, n)], axis=1
    )
    return make_model(xyz, rng.random((n, 3)), np.full(n, 0.97), np.full((n, 3), 0.8))


SCENES = {
    "random0": lambda: random_scene(seed=0, n=24, spread=0.8),
    "random1": lambda: random_scene(seed=1, n=24, spread=0.8),
    "overdraw": overdraw_scene,
}


def jax_records(m, w=W, h=H):
    """(16, P + CHUNK) records and tile ranges as the JAX pallas path builds them."""
    jcam, _ = camera_pair(w=w, h=h)
    proj = project_for_render(jcam, m)
    cap = 16 * m.capacity
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, w, h, TS, cap)
    fields = _build_fields(proj, proj.mean2d)[:, b.order]
    idx = jnp.concatenate([b.pair_gauss, jnp.zeros(CHUNK, jnp.int32)])
    TW, TH = tile_grid(w, h, TS)
    return fields[:, idx], b.tile_start, b.tile_count, TW, TH


def _kill_margin(rec, start, count, px, py):
    """Smallest |T_before * (1 - alpha) - T_MIN| over a pixel's segment, in
    float64 with the sequential CUDA semantics (alpha skips included)."""
    T, best = 1.0, np.inf
    for k in range(start, start + count):
        mx, my, a, b, c, op = (float(v) for v in rec[:6, k])
        dx, dy = mx - px, my - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = min(0.99, op * np.exp(power))
        if power > 0 or alpha < 1.0 / 255.0:
            continue
        test_T = T * (1.0 - alpha)
        best = min(best, abs(test_T - T_MIN))
        if test_T < T_MIN:
            break
        T = test_T
    return best


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_blend_matches_pallas(scene):
    records, ts_j, tc_j, TW, TH = jax_records(SCENES[scene]())
    out5_p, nc_p = blend_forward_pallas(records, ts_j, tc_j, TW, TH, TS, chunk=CHUNK,
                                        interpret=True)
    rec_np = np.array(records)
    out5, nc = blend_forward_torch(torch.from_numpy(rec_np), torch.from_numpy(np.array(ts_j)),
                                   torch.from_numpy(np.array(tc_j)), TW, TH, TS)
    assert out5.shape == (5, TW * TH, TS * TS) and nc.dtype == torch.int32
    # 3e-5: the Pallas kernel evaluates the exponent as a split-bf16
    # monomial contraction and the transmittance as a log-space scan; the
    # plain version uses the direct float32 products. The depth plane sums
    # alpha-weighted view z (up to ~9 here), so the same relative error is
    # scaled by the largest depth there.
    out5_p = np.asarray(out5_p)
    planes = [0, 1, 2, 4]
    np.testing.assert_allclose(out5.numpy()[planes], out5_p[planes], atol=3e-5)
    np.testing.assert_allclose(out5.numpy()[3], out5_p[3],
                               atol=3e-5 * max(1.0, np.abs(out5_p[3]).max()))
    nc, nc_p = nc.numpy(), np.asarray(nc_p)
    start, count = np.asarray(ts_j), np.asarray(tc_j)
    for t, s in zip(*np.nonzero(nc != nc_p)):
        px, py = (t % TW) * TS + s % TS, (t // TW) * TS + s // TS
        margin = _kill_margin(rec_np, start[t], count[t], px, py)
        print(f"n_contrib differs at tile {t} pixel {s}: {nc[t, s]} vs {nc_p[t, s]}, "
              f"kill margin {margin:.2e}")
        assert margin < 1e-6, f"tile {t} pixel {s} differs away from the 1e-4 cut"
    if scene == "overdraw":  # the termination path really ran
        assert (out5[4].numpy() < 0.02).any()


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_plain_blend_chunk_invariant(chunk):
    """The plain version's pair chunking only bounds its temporaries: any
    chunk gives the default's result. 1e-6: the cumulative products run in
    another grouping; n_contrib is exact away from the cuts."""
    records, ts_j, tc_j, TW, TH = jax_records(SCENES["overdraw"]())
    args = (torch.from_numpy(np.array(records)), torch.from_numpy(np.array(ts_j)),
            torch.from_numpy(np.array(tc_j)), TW, TH, TS)
    out5, nc = blend_forward_torch(*args, chunk=chunk)
    want5, want_nc = blend_forward_torch(*args)
    torch.testing.assert_close(out5[[0, 1, 2, 4]], want5[[0, 1, 2, 4]], atol=1e-6, rtol=0)
    torch.testing.assert_close(out5[3], want5[3], atol=1e-6 * float(want5[3].abs().max()),
                               rtol=0)
    assert torch.equal(nc, want_nc)


def test_wrapper_cpu_is_plain_version():
    records, ts_j, tc_j, TW, TH = jax_records(SCENES["random0"]())
    args = (torch.from_numpy(np.array(records)), torch.from_numpy(np.array(ts_j)),
            torch.from_numpy(np.array(tc_j)), TW, TH, TS)
    before = tracing.launches()["blend_forward"]
    out5, nc = blend_forward(*args)
    want5, want_nc = blend_forward_torch(*args)
    assert torch.equal(out5, want5) and torch.equal(nc, want_nc)
    assert tracing.launches()["blend_forward"] == before  # no kernel launch on the CPU


def test_wrapper_rejects_bad_inputs_and_backward():
    rec = torch.zeros(10, 8)
    start = torch.zeros(4, dtype=torch.int32)
    count = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        blend_forward(rec.double(), start, count, 2, 2, 16)
    with pytest.raises(ValueError):
        blend_forward(rec[:9], start, count, 2, 2, 16)
    with pytest.raises(ValueError):
        blend_forward(rec, start.long(), count, 2, 2, 16)
    with pytest.raises(ValueError):
        blend_forward(rec, start[:3], count, 2, 2, 16)
    out5, _ = blend_forward(rec.requires_grad_(), start, count, 2, 2, 16)
    np.testing.assert_array_equal(out5[4].detach().numpy(), 1.0)  # empty tiles: T = 1
    out5.sum().backward()  # the backward runs (no pairs: zero cotangents)
    assert rec.grad.shape == rec.shape and not rec.grad.any()


def random_splats(seed, n=48):
    """(10, n) float32 records of rotated, elongated splats whose means lie
    anywhere on a 1008x756 image, with opacities at, around and far above the
    1/255 cut; a third of them nearly degenerate (thin and rotated, conic
    condition a*c/det up to ~2e4)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(40.0), n))
    s2 = np.exp(rng.uniform(np.log(0.3), np.log(40.0), n))
    thin = rng.random(n) < 1 / 3
    s1 = np.where(thin, rng.uniform(20.0, 60.0, n), s1)
    s2 = np.where(thin, rng.uniform(0.2, 0.6, n), s2)
    cs, sn = np.cos(theta), np.sin(theta)
    ca = cs * cs * s1**2 + sn * sn * s2**2  # covariance, then its inverse
    cb = cs * sn * (s1**2 - s2**2)
    cc = sn * sn * s1**2 + cs * cs * s2**2
    det = ca * cc - cb * cb
    op = rng.choice([1 / 255, np.nextafter(np.float32(1 / 255), 0), 1.02 / 255, 0.05, 0.5, 0.99,
                     1.0], n)
    rec = np.zeros((10, n), np.float32)
    rec[0] = rng.uniform(0, 1008, n)
    rec[1] = rng.uniform(0, 756, n)
    rec[2], rec[3], rec[4] = cc / det, -cb / det, ca / det
    rec[5] = op
    return torch.from_numpy(rec)


def _pixels_that_blend(rec):
    """For each splat of `rec (10, n)`: (dx, dy) of every integer pixel
    around its mean, out to 1.5x its exact float64 alpha extents plus 3, at
    which `_splat`'s alpha is > 0."""
    out = []
    a, b, c, op = (rec[i].double() for i in (2, 3, 4, 5))
    k = 2 * torch.log(torch.clamp(255 * op, min=1.0))
    det = a * c - b * b
    for i in range(rec.shape[1]):
        hx = int(1.5 * float(torch.sqrt(k[i] * c[i] / det[i]))) + 3
        hy = int(1.5 * float(torch.sqrt(k[i] * a[i] / det[i]))) + 3
        mx, my = float(rec[0, i]), float(rec[1, i])
        xs = torch.arange(int(mx) - hx, int(mx) + hx + 1, dtype=torch.float32)
        ys = torch.arange(int(my) - hy, int(my) + hy + 1, dtype=torch.float32)
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        alpha = _splat(rec[:, i, None, None], px.reshape(1, -1), py.reshape(1, -1))[3][0, :, 0]
        hit = alpha > 0
        out.append((px.reshape(-1)[hit] - mx, py.reshape(-1)[hit] - my))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_alpha_extent_contains_every_blending_pixel(seed):
    """The cull box is conservative: every pixel where the one alpha
    expression gives alpha > 0 lies inside the box, so a kernel that skips
    a pair outside it changes no output bit."""
    rec = random_splats(seed)
    rx, ry = _alpha_extent(rec)
    assert torch.isfinite(rx[rec[5] >= 0.05]).any()  # real boxes are tested, not only inf
    n_hits = 0
    for i, (dx, dy) in enumerate(_pixels_that_blend(rec)):
        n_hits += dx.numel()
        if float(rec[5, i]) < ALPHA_MIN:
            assert dx.numel() == 0 and float(rx[i]) == -1.0
        assert bool((dx.abs() <= rx[i]).all() and (dy.abs() <= ry[i]).all()), i
    assert n_hits > 1000


def test_alpha_extent_is_tight_enough_to_cull():
    """The margins leave the box within 2 pixels plus 3% of the exact
    ellipse's extents for a well-conditioned conic."""
    rec = torch.zeros(10, 3)
    rec[2], rec[4], rec[5] = 1 / 25.0, 1 / 4.0, torch.tensor([0.5, 0.99, 1 / 255 * 2])
    rx, ry = _alpha_extent(rec)
    k = 2 * np.log(255 * rec[5].double().numpy())
    np.testing.assert_array_less(rx.numpy(), np.sqrt(k * 25.0) * 1.03 + 2)
    np.testing.assert_array_less(ry.numpy(), np.sqrt(k * 4.0) * 1.03 + 2)
    np.testing.assert_array_less(np.sqrt(k * 25.0), rx.numpy())


@pytest.mark.parametrize("conic,op,want", [
    ((1.0, 1.0, 1.0), 0.5, "inf"),  # det = 0: a line, no bound
    ((1.0, 0.99999, 1.0), 0.5, "inf"),  # det < 1e-4 a*c: treated as unbounded
    ((-1.0, 0.0, 1.0), 0.5, "inf"),  # not positive definite
    ((float("nan"), 0.0, 1.0), 0.5, "inf"),
    ((1.0, 0.0, float("inf")), 0.5, "inf"),
    ((1.0, 0.0, 1.0), 0.001, "never"),  # opacity below 1/255
    ((1.0, 0.0, 1.0), float("nan"), "nan"),  # splat_eval blends a NaN opacity
    # a NaN power gives alpha 0.99 in splat_eval (fminf) whatever the opacity
    ((float("nan"), 0.0, 1.0), 0.001, "inf"),
    ((1.0, float("-inf"), 1.0), 0.001, "inf"),
])
def test_alpha_extent_edge_cases(conic, op, want):
    rec = torch.zeros(10, 1)
    rec[2:5, 0] = torch.tensor(conic)
    rec[5, 0] = op
    _assert_extent(rec, want)


def _assert_extent(rec, want):
    rx, ry = _alpha_extent(rec)
    for r in (float(rx[0]), float(ry[0])):
        if want == "inf":
            assert r == float("inf")
        elif want == "never":
            assert r == -1.0
        else:
            assert np.isnan(r)


@pytest.mark.parametrize("mean", [(float("nan"), 5.0), (5.0, float("nan")), (float("inf"), 5.0),
                                  (5.0, float("-inf"))])
@pytest.mark.parametrize("op", [0.5, 0.001])
def test_alpha_extent_culls_nothing_for_a_mean_not_finite(mean, op):
    """A mean that is not finite makes the power NaN at every pixel, which
    splat_eval blends at alpha 0.99 whatever the opacity: nothing is culled,
    in any cell."""
    rec = torch.zeros(10, 1)
    rec[0, 0], rec[1, 0] = mean
    rec[2, 0], rec[4, 0], rec[5, 0] = 1.0, 1.0, op
    _assert_extent(rec, "inf")
    assert _cell_mask(rec, torch.tensor(0.0), torch.tensor(0.0)).all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cell_cull_keeps_every_blending_pixel(scene):
    """The kernels' per-cell cull (csrc/blend_common.cuh:cell_mask) on real
    binned records (through its plain mirror `_cell_mask`): a tile is 8
    cells of 8x4 pixels, and a pair is evaluated in the cells that its box
    meets. Every (pair, pixel) with alpha > 0 must fall in such a cell."""
    records, ts_j, tc_j, TW, TH = jax_records(SCENES[scene]())
    rec = torch.from_numpy(np.array(records))
    start, count = np.asarray(ts_j), np.asarray(tc_j)
    s = torch.arange(TS * TS)
    cell = _pixel_cell(s)
    checked = 0
    for t in range(TW * TH):
        idx = torch.arange(int(start[t]), int(start[t]) + int(count[t]))
        if idx.numel() == 0:
            continue
        x0, y0 = (t % TW) * TS, (t // TW) * TS
        px, py = (x0 + s % TS).float()[None], (y0 + s // TS).float()[None]
        alpha = _splat(rec[:, None, idx], px, py)[3][0]  # (S, pairs)
        mask = _cell_mask(rec[:, idx], torch.tensor(float(x0)), torch.tensor(float(y0)))
        evaluated = mask[cell]  # (S, pairs)
        assert not bool(((alpha > 0) & ~evaluated).any()), t
        checked += int((alpha > 0).sum())
    assert checked > 0


def test_cell_layout_and_mask_edges():
    """The cell of each pixel is the 8x4 block the kernels give it (cell c
    at x = 8 (c // 4), y = 4 (c % 4)); `_cell_mask` clears a cell only
    where the box misses it, and an unbounded conic leaves every cell set."""
    s = torch.arange(TS * TS)
    cell = _pixel_cell(s)
    assert torch.bincount(cell).tolist() == [32] * 8
    x, y = s % TS, s // TS
    assert torch.equal(x // 8, cell // 4) and torch.equal(y // 4, cell % 4)

    rec = torch.zeros(10, 3)
    rec[2], rec[4], rec[5] = 1.0, 1.0, 0.5  # a unit conic: box half-width ~4.2 pixels
    rec[0], rec[1] = 3.0, 2.0  # inside cell 0 (x 0-7, y 0-3)
    rec[0, 1], rec[1, 1] = 40.0, 40.0  # far off the tile
    rec[0, 2], rec[1, 2], rec[3, 2] = 40.0, 40.0, 1.0  # det = 0: cull nothing
    mask = _cell_mask(rec, torch.tensor(0.0), torch.tensor(0.0))
    assert mask.shape == (8, 3)
    # cell 1 (y 4-7) lies 2 pixels from the mean, cells 4+ (x >= 8) 5 pixels
    assert torch.nonzero(mask[:, 0]).flatten().tolist() == [0, 1]
    assert not mask[:, 1].any() and mask[:, 2].all()
