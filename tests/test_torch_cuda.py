"""Tests that need a CUDA card: the hand-written blend kernel against its
plain PyTorch version, and its launch counter. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import from_numpy
from binocular3dgs_torch.ops import blend_cuda
from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
from binocular3dgs_torch.ops.blend_cuda import blend_forward, blend_forward_torch
from binocular3dgs_torch.ops.rasterize import _build_fields, project_for_render, render_tiled

TS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from binocular3dgs_torch import resolve_device

    return resolve_device("cuda")


def scene(seed, n, w, h, device, opacity=(0.2, 0.95), depth=(3.0, 9.0)):
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
    model = from_numpy(params, np.ones(n, bool), 1, 1, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, w, h, device=device)
    return model, cam


def records_for(model, cam, ppg=16):
    proj = project_for_render(cam, model)
    TW, TH = tile_grid(cam.width, cam.height, TS)
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, TS,
                      ppg * model.capacity)
    records = _build_fields(proj)[:, b.order][:, b.pair_gauss].contiguous()
    return records, b.tile_start, b.tile_count, TW, TH


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opacity", [
    (0, 64, 64, 48, (0.2, 0.95)),
    (1, 400, 200, 150, (0.9, 0.99)),  # heavy overdraw: the termination path
    (2, 300, 50, 38, (0.2, 0.95)),  # size not a multiple of the tile
])
def test_kernel_matches_plain(cuda_device, seed, n, w, h, opacity):
    model, cam = scene(seed, n, w, h, cuda_device, opacity)
    records, start, count, TW, TH = records_for(model, cam)
    before = blend_cuda.blend_forward_launches
    out5, nc = blend_forward(records, start, count, TW, TH, TS)
    torch.cuda.synchronize()
    assert blend_cuda.blend_forward_launches == before + 1
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
    before = blend_cuda.blend_forward_launches
    out = render_tiled(cam, model, [0.0, 0.0, 0.0], device=cuda_device)
    torch.cuda.synchronize()
    assert blend_cuda.blend_forward_launches == before + 1
    assert out.image.shape == (3, 48, 64) and torch.isfinite(out.image).all()
