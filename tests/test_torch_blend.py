"""The port's plain blend (blend_forward_torch) against the Pallas kernel
blend_forward_pallas in interpret mode, on the same (16, P) records and tile
ranges; and the wrapper's CPU path, input checks and backward on empty tiles. The
CUDA kernel itself is held against the plain version in test_torch_cuda.py
(on a card) and in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops.binning import bin_gaussians, tile_grid
from binocular3dgs_tpu.ops.blend_pallas import blend_forward_pallas
from binocular3dgs_tpu.ops.rasterize import _build_fields, project_for_render
from binocular3dgs_torch.ops import blend_cuda
from binocular3dgs_torch.ops.blend_cuda import blend_forward, blend_forward_torch

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
    before = blend_cuda.blend_forward_launches
    out5, nc = blend_forward(*args)
    want5, want_nc = blend_forward_torch(*args)
    assert torch.equal(out5, want5) and torch.equal(nc, want_nc)
    assert blend_cuda.blend_forward_launches == before  # no kernel launch on the CPU


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
