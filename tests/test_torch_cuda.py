"""Tests that need a CUDA card: the hand-written kernels (blend forward B1,
blend backward B2, warp forward W1 and backward W2) against their plain
PyTorch versions, and their launch counters around a render and a training
step; a training step that repeats bit for bit; the port's ranges on the
profiler's device clock, and a traced span of the trainer that syncs no
more than an untraced one; the dense init's Farneback
flow and growth scorer, and one PDCNet+ pass, RANSAC and warp, on the card
against the CPU; a band render over two gloo ranks on the card against the
single render. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from binocular3dgs_torch import tracing
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import from_numpy
from binocular3dgs_torch.config import Config, RasterConfig
from binocular3dgs_torch.ops import warp
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
    proj = project_for_render(cam, model)
    TW, TH = tile_grid(cam.width, cam.height, TS)
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, TS,
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
    before = tracing.launches()["blend_forward"]
    out = render_tiled(cam, model, [0.0, 0.0, 0.0], device=cuda_device)
    torch.cuda.synchronize()
    assert tracing.launches()["blend_forward"] == before + 1
    assert out.image.shape == (3, 48, 64) and torch.isfinite(out.image).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opacity,elongated", SCENES)
def test_backward_kernel_matches_plain(cuda_device, seed, n, w, h, opacity, elongated):
    model, cam = scene(seed, n, w, h, cuda_device, opacity, elongated=elongated)
    records, start, count, TW, TH = records_for(model, cam)
    out5, nc = blend_forward_torch(records, start, count, TW, TH, TS)
    g = torch.Generator().manual_seed(seed)
    d_out5 = torch.randn(out5.shape, generator=g).to(cuda_device)
    before = tracing.launches()["blend_backward"]
    got = blend_backward(records, start, count, out5, nc, d_out5, TW, TH, TS)
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
    assert [after[k] - before[k] for k in tracing.KERNELS] == [2, 2, 1, 1]
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


def toy_trainer(device):
    """A trainer of a 3-view toy scene (30 points, 40x30) after 16
    iterations: its next steps are binocular, and iterations 17-20 are one
    span that ends in a densification."""
    from binocular3dgs_torch.data.dataset import Scene, View
    from binocular3dgs_torch.data.ply import PointCloud
    from binocular3dgs_torch.data.readers import SceneInfo
    from binocular3dgs_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(30, 3)) * 0.4 + [0, 0, 4]
    views = [View(make_camera(np.eye(3), np.array([tx, 0.0, 0.0]), 0.9, 0.7, 40, 30,
                              device="cpu"),
                  rng.random((30, 40, 3)).astype(np.float32), None, f"v{i}", i, i)
             for i, tx in enumerate((-0.1, 0.0, 0.1))]
    info = SceneInfo(PointCloud(points=pts, colors=rng.random((30, 3))), [], [],
                     {"radius": 1.0, "translate": np.zeros(3)}, None)
    cfg = Config()
    cfg.opt.densify_from_iter, cfg.opt.densification_interval = 5, 10
    cfg.opt.densify_grad_threshold = 1e-5
    cfg.train.shift_cam_start = 15
    cfg.train.test_iterations = cfg.train.save_iterations = ()
    trainer = Trainer(cfg, Scene(views, [], 1.0, info), device=device)
    trainer.train(16)
    return trainer


@pytest.mark.cuda
def test_tracing_adds_no_sync_to_a_span(cuda_device):
    """Under the sync debug mode, one fused span of binocular steps (17-20,
    with its read and densification) warns no more often while a profiler
    traces than without one; the traced span records the backward's ranges
    from autograd's device thread."""
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

    off = span_syncs(toy_trainer(cuda_device))
    trainer = toy_trainer(cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]):
        main = threading.get_ident()
        on = span_syncs(trainer)
    print(f"sync warnings in the span: {len(off)} untraced, {len(on)} traced")
    assert len(on) <= len(off)
    backward = [r for r in tracing.snapshot()["ranges"] if r["name"] == "render.blend.backward"
                and r["iteration"] in range(17, 21)]
    assert len(backward) == 8 and all(r["thread"] != main for r in backward)


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
