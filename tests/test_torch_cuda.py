"""Tests that need a CUDA card: the hand-written kernels (blend forward B1,
blend backward B2, warp forward W1 and backward W2) against their plain
PyTorch versions, and their launch counters around a render and a training
step. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import from_numpy
from binocular3dgs_torch.config import Config
from binocular3dgs_torch.ops import blend_cuda, warp
from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
from binocular3dgs_torch.ops.blend_cuda import (
    blend_backward,
    blend_backward_torch,
    blend_forward,
    blend_forward_torch,
)
from binocular3dgs_torch.ops.rasterize import _build_fields, project_for_render, render_tiled
from binocular3dgs_torch.train.state import init_train_state
from binocular3dgs_torch.train.step import make_train_step

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


SCENES = [
    (0, 64, 64, 48, (0.2, 0.95)),
    (1, 400, 200, 150, (0.9, 0.99)),  # heavy overdraw: the termination path
    (2, 300, 50, 38, (0.2, 0.95)),  # size not a multiple of the tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opacity", SCENES)
def test_backward_kernel_matches_plain(cuda_device, seed, n, w, h, opacity):
    model, cam = scene(seed, n, w, h, cuda_device, opacity)
    records, start, count, TW, TH = records_for(model, cam)
    out5, nc = blend_forward_torch(records, start, count, TW, TH, TS)
    g = torch.Generator().manual_seed(seed)
    d_out5 = torch.randn(out5.shape, generator=g).to(cuda_device)
    before = blend_cuda.blend_backward_launches
    got = blend_backward(records, start, count, out5, nc, d_out5, TW, TH, TS)
    torch.cuda.synchronize()
    assert blend_cuda.blend_backward_launches == before + 1
    want = blend_backward_torch(records, start, count, out5, nc, d_out5, TW, TH, TS)
    # transmittance rebuilt by one division per pair here, by chunk suffix
    # products there, and the pixel sums in another order: each of the ten
    # rows within 1e-3 of its largest entry
    for row in range(10):
        scale = want[row].abs().max().item()
        assert (got[row] - want[row]).abs().max().item() <= 1e-3 * scale + 1e-12, row
    assert not got[10:].any() and got[:10].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [4.0, 40.0])  # mostly in range; mostly out of it
def test_warp_kernels_match_plain(cuda_device, spread):
    g = torch.Generator().manual_seed(int(spread))
    image = torch.rand(3, 75, 101, generator=g).to(cuda_device)
    disp = ((torch.rand(75, 101, generator=g) - 0.5) * spread).to(cuda_device)
    d_out = torch.randn(3, 75, 101, generator=g).to(cuda_device)
    before = (warp.warp_forward_launches, warp.warp_backward_launches)
    out, diff = warp.warp_forward(image, disp)
    d_img = warp.warp_backward(disp, d_out)
    torch.cuda.synchronize()
    assert (warp.warp_forward_launches, warp.warp_backward_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    want_out, want_diff = warp.warp_forward_torch(image, disp)
    # the same two float32 products (no FMA contraction on either side)
    assert (out - want_out).abs().max().item() <= 1e-6
    assert (diff - want_diff).abs().max().item() <= 1e-6
    want_d_img = warp.warp_backward_torch(disp, d_out)
    # shared-memory atomics add each column's few taps in a varying order
    assert (d_img - want_d_img).abs().max().item() <= 1e-5 * want_d_img.abs().max().item()


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
    counters = ("blend_forward_launches", "blend_backward_launches")
    before = [getattr(blend_cuda, c) for c in counters] + [warp.warp_forward_launches,
                                                           warp.warp_backward_launches]
    state, metrics = step(state, cam, gt, aw, 2, 0.2, torch.zeros(3, device=cuda_device))
    torch.cuda.synchronize()
    after = [getattr(blend_cuda, c) for c in counters] + [warp.warp_forward_launches,
                                                          warp.warp_backward_launches]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 1, 1]
    assert torch.isfinite(metrics.loss) and float(metrics.disparity_loss) > 0
