#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (binocular3dgs_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's serving path, its training path, its dense init (with
the Farneback matcher and with PDCNet+) and its band-sharded path at full
width and fails (non-zero exit) if any phase fails:

  1. environment: the card (nvidia-smi name and power limit), torch/CUDA
     versions, TF32 off for matmuls and cuDNN
  2. build: every csrc/*.cu with nvcc into build/libbinocular_kernels.<key>.so
  3. workload: 100k gaussians (SH degree 1) before a 1008x756 camera, made
     with numpy from --seed, 6 pairs per gaussian
  4. kernel parity at full width: the blend kernel against its plain PyTorch
     version on the records of the port's project -> bin -> gather; kernel
     time, plain time, the kernel's bound (from the pair-pixels that blend)
     and the dense walk's; then the same at the overdraw shape (scales in
     [0.02, 0.05], opacities in [0.88, 0.99], pairs_per_gaussian doubled
     until no pair overflows), where most pixels terminate early
  5. main path: 8 views on an arc through render_tiled on the card, with
     the kernel launch counts read around exactly that run (8 blend forward,
     8 vertex forward, no vertex backward); render and
     per-stage times; an end-to-end check against the plain blend and a
     small-input check against the dense oracle
  6. entry point: `cli render` and `cli metrics` in-process on a fabricated
     9-view 1008x756 COLMAP scene (20k points) and a PLY of the phase-3 model
     whose cfg_args.json sets `eval`
  7. backward kernel parity at full width: the blend backward kernel against
     its plain version on phase 4's records, the forward kernel's outputs
     and a seeded cotangent, row by row; kernel time, plain time and bound;
     at both of phase 4's shapes
  8. warp kernel parity at full width: the warp forward and backward kernels
     against their plain versions on phase 5's view-0 render and its
     disparity, for the shift 0.2 and for -0.4 (the opposite sign at the
     trainer's widest shift); the backward kernel bit for bit, and two of
     its launches bit for bit; times and bounds
  9. training main path: the bench.py workload through
     `make_train_step(binocular=True)`, 3 warm-up and 10 timed steps with the
     launch counters read around exactly the timed ones (2 blend forward, 2
     blend backward, 1 warp forward, 1 warp backward, 2 vertex forward, 2
     vertex backward, 1 SSIM forward and 1 SSIM backward per step, and per
     render the binning kernels and the record gather's three); step time,
     per-stage times, peak memory, device busy share and top kernels; one
     step at 5k gaussians and 256x192 on the card against the CPU
 10. entry point: `cli train` (densification and the binocular branch
     reached, checkpoints at 30 and 60) on the phase-6 scene, then `cli
     render` and `cli metrics` on its output; chkpnt60.npz, loaded on the
     card, equals the trainer's final state bit for bit; then the same `cli
     train` without checkpoints or report with the default spans and with
     `--fused_steps 1` in turns (default, 1, 1, default): it/s of each
 11. resume: `cli train --start_checkpoint chkpnt30.npz --iterations 60
     --profile_dir`: the state the resumed trainer steps from equal to
     chkpnt30.npz bit for bit (every buffer, adam_step 30, SH degrees and
     spatial_lr_scale), iteration 60 reached with a finite loss, 2 blend forward,
     2 blend backward, 1 warp forward, 1 warp backward, 2 vertex forward, 2
     vertex backward, 1 SSIM forward and 1 SSIM backward launches per resumed
     step with each render's binning and gather kernels, and the eight
     kernels named in the trace
 12. `cli spiral --n_frames 8 --no_video` of the phase-10 model at 1008x756
     (the scene's poses_bounds.npy): 24 PNGs, 8 blend forward launches,
     something rendered in every frame; ms per frame
 13. `cli metrics --lpips_weights` (random vgg weights from --seed) on the
     phase-6 renders: LPIPS on the card within 1e-4 relative of the CPU's;
     ms per 1008x756 image
 14. viewer: a loopback client sends one 1008x756 request; `serve_step`
     with a `render_tiled` callback on the card returns the bytes of a
     direct render's uint8 image
 15. determinism: the phase-9 step from one state and the same shifts, 1
     and 10 steps, run twice each: parameters, both Adam moments, the
     densification statistics and the loss equal bit for bit; phase 10's
     `cli train` run again: chkpnt60.npz and the logged losses equal
 16. dense init at the LLFF protocol's size: 9 JPEG views at 4032x3024
     rendered by the port from a seeded slab of 200k gaussians on the arc
     cameras; `cli triangulate --resolution 2` (12 Farneback flows at
     504x378, 1000 growth iterations of 100 x 200 candidates): points,
     growth, the pre-growth points' median reprojection error under 2 px,
     flows and scorer on the card; times of the load, each flow, the DLT
     and filters, the growth per iteration and its busy share; then
     `orchestrate.run_scene` with the LLFF protocol cut to 60 iterations
     (triangulate, train at -r 2, render, metrics as `--device cuda`
     processes): train loads the dense PLY it was given
 17. the dense init on the card against the CPU on a 1008x756 copy of that
     scene: resized images equal, Farneback end-point difference median
     <= 0.01 px and 99th percentile <= 0.1 px, pre-growth point sets equal
     within 1e-3 on >= 99% of points, growth scores within 1e-5
 18. PDCNet+ at LLFF's matching size: random weights from --seed as a .pth
     and as the npz both packages read (equal tensors); `_direct` on one
     ordered pair of phase 16's views at 2016x1512 (median of 5 after 1
     warm-up, CUDA events; stage spans of both VGG pyramids, GlobalGOCor,
     LocalGOCor per level, decoders and uncertainty; the profiler's kernels,
     busy share and the local correlation's share; peak memory; the image
     pyramid with cuDNN's deterministic algorithms and without);
     `get_matches_and_confidence` in mode h with cyclic consistency; `cli
     triangulate --matcher pdcnet --pdcnet_weights <npz> --resolution 2`
     on phase 16's scene, the network and the RANSAC on the card only
 19. PDCNet+ on the card against the CPU: mode d with cyclic consistency at
     256x256 (flow, log-variances, weights, P_R, cyclic error within 1e-3
     of each map's largest value); the RANSAC homography of a 100,000-match
     set of a known H at 2016x1512 on both, each within 1e-2 px of it at
     the corners; the perspective warp of a 2016x1512 view within 1e-3
 20. the sharded path on the one card: 2, then 3, `chip_smoke.py
     --sharded_rank` processes over gloo (host-staged collectives) on the
     phase-9 workload, each rank checking: its band render of view 0
     against `render_tiled` (image and alpha 1e-5, depth 1e-4, radii
     equal), B1 launched once; one sharded step against the single step
     (loss 1e-5 relative, adam_m and grad_accum within 1e-3 of their norms),
     launches 2/2/1/1/2/2/1/1 and two bands' binning and gathers; where the
     capacity divides: `shard_gaussians`
     against the replicated render (the same tolerances), 3 `shard_adam`
     steps against 3 replicated ones bit for bit with capacity/ranks moment
     rows, and the replicated run twice bit for bit; then the step median
     (CUDA events), the collectives' calls, MiB and ms per step, kernels
     per step (profiler) and peak memory
 21. `dryrun_multihost(2, 1)` on the card over gloo (both ranks' losses
     equal, within 1e-6 of one rank); one rank over nccl against one over
     gloo, bit for bit (NCCL refuses two ranks on one card)
 22. (run after phase 8) the vertex stage's kernels at the benchmark cells'
     row counts (1,048,576 rows at 2016x1512, 262,144 at 400x400, SH
     degree 1, with the carrier): the forward against project_gaussians on
     the card, bit for bit in every field, the backward against autograd
     and against project_backward_torch; device times with L2
     flushed beside their byte bounds, the plain version's time and device
     operations per call
 23. (run after phase 22) SSIM's kernels at the cells' image sizes (3 x 1512
     x 2016 and 3 x 400 x 400): the plain composition's five blurs run as
     conv_depthwise2d (the PyTorch and CUDA versions that S1's order of sums
     is pinned to beside this card's), S1's three maps equal to
     ssim_maps_torch's bit for bit and its mean the plain composition's, S2
     against autograd of the plain composition and against
     ssim_backward_torch of S1's maps, two launches of each bit for bit;
     device times with L2 flushed beside the bounds of the work SSIM needs,
     the plain version's time and device operations per call
 24. (run after phase 23) binning and the record gather (csrc/binning.cu)
     at the cells' row counts and image sizes (phase 22's rows, projected):
     every output of the binning kernels equal to bin_gaussians_torch's, the
     gathered records to the plain gather's and the gather backward to the
     plain segment sums, bit for bit; the three stages' device times with L2
     flushed beside the bytes they must move, their device operations, the
     plain stages' times and device operations, and the launch gate of one
     render (each binning kernel as bin_launches counts it, one gather
     forward, one gather backward)

It prints a JSON line of per-kernel results, the card's nvidia-smi line, and
last `{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The card's peaks, kernel_bound and the blend kernels' work and constants
# are benchmark/work.py's (imported where used: torch is imported in main).
# warp: W1 reads the disparity and the image once and writes out and diff
# (4 + 12 + 24 B per pixel); W2 reads the disparity and d_out and writes
# d_image (4 + 12 + 12 B per pixel); a few FP32 operations per pixel
WARP_FWD_BYTES_PER_PIXEL, WARP_BWD_BYTES_PER_PIXEL = 40, 28
WARP_NO_LIBRARY = ("none: grid_sample zeroes each out-of-range tap, the warp zeroes the "
                   "whole pixel, so no single PyTorch call computes the same function")
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# the vertex stage's kernels (phase 22) at the benchmark cells' row counts
# (benchmark/configs: capacity rows, active gaussians, image size), SH
# degree 1, with the densification carrier as in a training step's main
# render. Bytes a row: the forward reads xyz 12, f_dc 12, f_rest 36, opacity
# 4, scaling 12, rotation 16, active 1 and the carrier 8, and writes mean2d
# 8, depth 4, conic 12, color 12, opacity 4, radius 4, visible 1 and
# bin_extent 8; the backward reads the leaves (93) and the five cotangents
# (40) and writes the six leaves' gradients and the carrier's (100)
VERTEX_SHAPES = (("llff3", 1_048_576, 285_523, 2016, 1512),
                 ("blender8", 262_144, 100_000, 400, 400))
VERTEX_FWD_BYTES_PER_ROW, VERTEX_BWD_BYTES_PER_ROW = 101 + 53, 133 + 100
VERTEX_NO_TPU_KERNEL = "none: the JAX vertex stage (binocular3dgs_tpu/ops/project.py) is XLA"
# SSIM's kernels (phase 23) at the cells' training images, against the
# work SSIM needs. Per pixel-channel S1 reads the render and the ground
# truth and writes the three derivative maps, S2 reads the maps and both
# images and writes the render's gradient; FP32 instructions (a fused
# multiply-add one) with separable blurs: S1 145 (3 products, 110 taps of
# the separable window over five quantities, 18 for the map, 14 for its
# derivatives), S2 72 (66 taps over three maps, 6 to combine them), as
# benchmark/metrics/train.ssim_roofline.py counts. S1 runs 605 taps, the
# 11x11 window's, to sum as the plain composition's conv_depthwise2d does
SSIM_SHAPES = (("llff3", 1512, 2016), ("blender8", 400, 400))
SSIM_FWD_BYTES, SSIM_BWD_BYTES = 20, 24
SSIM_FWD_INSTR, SSIM_BWD_INSTR = 145, 72
SSIM_NO_TPU_KERNEL = "none: the JAX package's SSIM (binocular3dgs_tpu/ops/losses.py) is XLA"

# binning and the record gather (phase 24): the bytes the three stages must
# move, each input read once and each output written once. Per emitted
# pair: binning's pair_tile, pair_gauss and sorted_pos (12), its record
# (40) and its cotangent read back (40); per row: binning's reads of mean2d,
# the extents and depth (20), its order, rank_offsets and rank_of (12) and
# the gradients of the five fields (40); per emitting row its fields (40)
BIN_BYTES_PER_PAIR, BIN_BYTES_PER_ROW, BIN_BYTES_PER_EMITTING_ROW = 92, 72, 40
BIN_NO_TPU_KERNEL = ("none: the JAX package bins with XLA's sort and gathers with XLA "
                     "(binocular3dgs_tpu/ops/binning.py, rasterize.py)")

W, H, N_GAUSS, PAIRS_PER_GAUSSIAN = 1008, 756, 100_000, 6
# the overdraw shape of phases 4 and 7: make_workload's draw with large,
# nearly opaque splats, so that most pixels terminate early
OVERDRAW_SCALES, OVERDRAW_OPACITY = (0.02, 0.05), (0.88, 0.99)
FOVX, FOVY = 0.9, 0.7
N_VIEWS = 8


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(torch, fn, warmup=3, iters=20):
    """Median device time of fn() over `iters` runs, CUDA events, after
    `warmup` runs."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def kernel_device_ms(torch, fn, name, reps=20):
    """Device time per call of the kernels whose name holds `name` (or any
    of a tuple of names, one call launching each; counted by the first), from
    torch.profiler over `reps` calls after one warm-up: the kernel alone,
    without the wrapper's host time, which an event pair around one short
    call also holds. Before each call a 64 MiB write evicts the 50 MB L2, so
    the kernel reads its inputs from device memory, as its bound assumes.
    The mean is over the launches the profiler recorded (it has dropped
    some in a run, which a division by `reps` would read as a faster
    kernel). None when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    found = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)]
    us = sum(e.self_device_time_total for e in found)
    launches = sum(e.count for e in found if names[0] in e.key)
    if launches != reps:
        log(f"[profiler] {name}: {launches} of {reps} launches recorded")
    return us / 1e3 / launches if us > 0 else None


def kernel_times(torch, fn, name):
    """(ms, event ms): the kernel's device time from the profiler (the
    event time where the profiler sees none) and the CUDA-event median
    around the wrapper call."""
    event_ms = median_ms(torch, fn)
    device_ms = kernel_device_ms(torch, fn, name)
    return (event_ms if device_ms is None else device_ms), event_ms


def draw_trans(torch, gen, dist):
    """The binocular shift as the trainer draws it."""
    u, s = torch.rand(2, generator=gen).tolist()
    return u * dist * (1.0 if s < 0.5 else -1.0)


def rel_norm(got, want):
    return float((got - want).norm() / want.norm()) if want.norm() > 0 else float(got.norm())


def make_workload(seed, n=N_GAUSS, width=W, height=H, scales=(0.005, 0.02), opacity=None):
    """The bench.py workload, drawn in the same order from the same seed:
    xyz in [-2,2]x[-1.5,1.5]x[3,9], SH degree 1 (rest bands zero), opacity
    logits in [-2,1] (or the logits of opacities uniform in `opacity`),
    scales in `scales`, identity rotations, then the (3, H, W) ground-truth
    image of the training step."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], 1)
    f_dc = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    if opacity is None:
        logits = rng.uniform(-2, 1, (n, 1))
    else:
        p = rng.uniform(*opacity, (n, 1))
        logits = np.log(p / (1 - p))
    params = dict(
        xyz=xyz.astype(np.float32),
        f_dc=f_dc,
        f_rest=np.zeros((n, 3, 3), np.float32),
        opacity=logits.astype(np.float32),
        scaling=np.log(rng.uniform(*scales, (n, 3))).astype(np.float32),
        rotation=np.concatenate([np.ones((n, 1)), np.zeros((n, 3))], 1).astype(np.float32),
    )
    gt = rng.random((3, height, width)).astype(np.float32)
    return params, np.ones(n, bool), gt


def arc_poses(n, span=0.08):
    """(R camera-to-world, T world-to-camera) of n cameras on a small arc
    (+-span rad) around the y axis, all facing the workload's slab."""
    poses = []
    for a in np.linspace(-span, span, n):
        c, s = np.cos(a), np.sin(a)
        Rw2c = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])  # looks at (0, 0, 6)
        center = np.array([6.0 * np.sin(a), 0.0, 6.0 * (1.0 - np.cos(a))])
        poses.append((Rw2c.T, -Rw2c @ center))
    return poses


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from binocular3dgs_torch import resolve_device

    device = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN convolutions are on")
    log(f"[1 env] {smi}")
    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; TF32 matmul/cudnn off")
    return device, smi


def phase_build():
    from binocular3dgs_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    cuda_build.load_library()
    log(f"[2 build] {lib} in {time.perf_counter() - t0:.1f} s")


def cell_evaluations(torch, records, tile_start, tile_count, TW, ts):
    """Pair-pixel evaluations that the kernels' per-cell cull leaves before
    any early exit: the pixels of each (pair, 8x4 cell of its tile) whose
    conservative alpha box meets the cell (blend_cuda._cell_mask, the mirror
    of csrc/blend_common.cuh:cell_mask)."""
    from binocular3dgs_torch.ops.blend_cuda import CELL_H, CELL_W, _cell_mask

    dev = records.device
    count = tile_count.long()
    tile = torch.repeat_interleave(torch.arange(count.numel(), device=dev), count)
    pair = torch.repeat_interleave(tile_start.long() - torch.cumsum(count, 0) + count, count) \
        + torch.arange(int(count.sum()), device=dev)
    x0, y0 = (tile % TW * ts).float(), (tile // TW * ts).float()
    return CELL_W * CELL_H * int(_cell_mask(records[:, pair], x0, y0).sum())


def sorted_records(torch, proj, b):
    """The card's records of binning `b` (csrc/binning.cu's gather), the
    slots past the sorted pairs zeroed: the plain blend reads past a tile's
    pairs, where the kernel leaves the slots unwritten."""
    from binocular3dgs_torch.ops.rasterize import gather_records

    with torch.no_grad():
        records = gather_records(proj, b)
    records[:, int(b.bin_slots):] = 0.0
    return records


def bin_records(torch, model, cam, raster, grow=False):
    """(records, tile_start, tile_count, TW, TH, ts, binning, pair capacity)
    of the port's project -> bin -> gather for `cam`. With `grow`,
    pairs_per_gaussian doubles from raster's until no pair overflows."""
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.rasterize import project_for_render

    ts = raster.tile_size
    TW, TH = tile_grid(cam.width, cam.height, ts)
    proj = project_for_render(cam, model, raster=raster)
    ppg = raster.pairs_per_gaussian
    while True:
        cap = ppg * model.capacity
        b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, ts,
                          cap)
        if not grow or int(b.num_pairs) <= cap:
            break
        ppg *= 2
    records = sorted_records(torch, proj, b)
    return records, b.tile_start, b.tile_count, TW, TH, ts, b, cap


def timed_once(torch, fn):
    """(result, device ms) of one call of fn, CUDA events."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def phase_kernel_parity(torch, model, cam, raster, tag="[4 parity]", grow=False):
    """B1 against its plain version at full width, its times and bounds.
    `grow` raises pairs_per_gaussian until nothing overflows (the overdraw
    shape); the plain version is then timed by its one parity call."""
    from benchmark import work
    from binocular3dgs_torch.ops.blend_cuda import (
        blend_forward, blend_forward_cuda, blend_forward_torch,
    )

    records, start, count, TW, TH, ts, b, cap = bin_records(torch, model, cam, raster, grow)
    T = TW * TH
    args = (records, start, count, TW, TH, ts)
    out5, nc, state = blend_forward_cuda(*args)
    torch.cuda.synchronize()
    (want5, want_nc), plain_once_ms = timed_once(torch, lambda: blend_forward_torch(*args))
    rgbT = [0, 1, 2, 4]
    err_rgbT = (out5[rgbT] - want5[rgbT]).abs().max().item()
    err_depth = (out5[3] - want5[3]).abs().max().item()
    depth_tol = 1e-5 * want5[3].abs().max().item() + 1e-4
    nc_equal = (nc == want_nc).double().mean().item()
    num_pairs, valid_pairs = int(b.num_pairs), int(count.sum())
    log(f"{tag} num_pairs {num_pairs} / capacity {cap} ({cap // model.capacity} per gaussian; "
        f"blended {valid_pairs}); max tile pairs {int(count.max())}; mean T_final "
        f"{want5[4].mean().item():.4f}")
    log(f"{tag} max|diff| r,g,b,T_final {err_rgbT:.3e} (tol 1e-4); depth "
        f"{err_depth:.3e} (tol {depth_tol:.3e}); n_contrib equal on {nc_equal:.6f} "
        f"(tol >= 0.999)")
    check(err_rgbT <= 1e-4, f"blend kernel r,g,b,T_final differ by {err_rgbT}")
    check(err_depth <= depth_tol, f"blend kernel depth differs by {err_depth}")
    check(nc_equal >= 0.999, f"blend kernel n_contrib equal on only {nc_equal}")
    check(num_pairs <= cap, f"pair capacity overflow: {num_pairs} > {cap}")

    # B1 is the plan, the whole and local walks, and the walk from T_in
    ms, event_ms = kernel_times(torch, lambda: blend_forward(*args), (
        "blend_forward_kernel", "blend_plan_kernel", "blend_chunk_kernel"))
    plain_ms = plain_once_ms if grow else median_ms(
        torch, lambda: blend_forward_torch(*args), warmup=1, iters=3)
    read, evals, hits, killed = work.forward_work(records, start, count, want_nc, TW, TH, ts)
    culled_evals = cell_evaluations(torch, records, start, count, TW, ts)
    bytes_ = (work.BLEND_BYTES_PER_PAIR * read + work.BLEND_BYTES_PER_TILE * T
              + work.BLEND_BYTES_PER_PIXEL * T * ts * ts)
    bound_ms, bound_by, bytes_ms, ops_ms = work.kernel_bound(
        bytes_, work.BLEND_INSTR_PER_EVAL * hits)
    dense_bound_ms = work.kernel_bound(bytes_, work.BLEND_INSTR_PER_EVAL * evals)[0]
    log(f"{tag} kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events around the "
        f"wrapper), plain {plain_ms:.3f} ms; {killed} of {T * ts * ts} pixels terminate; "
        f"bound: {read} pairs read, {bytes_} B -> {bytes_ms:.4f} ms, {hits} "
        f"hits x {work.BLEND_INSTR_PER_EVAL} FP32 instructions at {work.FP32_INSTR_PER_S:.3g}/s "
        f"-> {ops_ms:.4f} ms; dense bound ({evals} evaluations) {dense_bound_ms:.4f} ms; the cell "
        f"cull leaves {culled_evals} of the {ts * ts * valid_pairs} "
        f"pair-pixel evaluations of a dense walk without early exit")
    check(ms >= bound_ms, f"blend_forward reads {ms} ms, below its bound {bound_ms} ms")
    kernel = dict(
        name="blend_forward",
        route="cuda",
        source="binocular3dgs_torch/csrc/blend_forward.cu",
        replaces="binocular3dgs_tpu/ops/blend_pallas.py:507",
        launches=None,
        max_abs_err=max(err_rgbT, err_depth),
        parity=dict(rgbT_max_abs=err_rgbT, depth_max_abs=err_depth, depth_tol=depth_tol,
                    n_contrib_equal=nc_equal, num_pairs=num_pairs, pair_capacity=cap,
                    pairs_read=read, evaluations=evals, hits=hits, terminated_pixels=killed,
                    cell_cull_evaluations=culled_evals),
        ms=ms,
        event_ms=event_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        dense_bound_ms=dense_bound_ms,
        library_ms=None,
        library_note="none: no single PyTorch call computes the tile blend",
    )
    return kernel, dict(args=args, out5=out5, n_contrib=nc, state=state, valid_pairs=valid_pairs)


def phase_backward_parity(torch, fwd, seed, tag="[7 backward]"):
    from benchmark import work
    from binocular3dgs_torch.ops.blend_cuda import blend_backward, blend_backward_torch

    records, start, count, TW, TH, ts = fwd["args"]
    out5, nc = fwd["out5"], fwd["n_contrib"]
    rng = np.random.default_rng(seed + 7)
    d_out5 = torch.from_numpy(rng.normal(size=tuple(out5.shape)).astype(np.float32)).to(
        out5.device)
    args = (records, start, count, out5, nc, d_out5, TW, TH, ts)
    got = blend_backward(*args, state=fwd["state"])
    torch.cuda.synchronize()
    want = blend_backward_torch(*args)
    names = ("mx", "my", "conic_a", "conic_b", "conic_c", "opacity", "r", "g", "b", "depth")
    rows = {}
    for i, name in enumerate(names):
        err = (got[i] - want[i]).abs().max().item()
        scale = want[i].abs().max().item()
        rows[name] = dict(max_abs=err, max_row=scale)
        check(err <= 1e-3 * scale, f"blend backward row {name} differs by {err} "
                                   f"(tol 1e-3 x {scale})")
    check(not got[10:].any(), "blend backward wrote rows past the 10 live ones")
    log(f"{tag} max|diff| / max|row| per row: " + ", ".join(
        f"{k} {v['max_abs']:.3e}/{v['max_row']:.3e}" for k, v in rows.items()) + " (tol 1e-3)")

    ms, event_ms = kernel_times(torch, lambda: blend_backward(*args, state=fwd["state"]),
                                "blend_backward_kernel")
    plain_ms = median_ms(torch, lambda: blend_backward_torch(*args), warmup=1, iters=3)
    walked, evals, hits = work.backward_work(records, start, count, nc, TW, TH, ts)
    T = TW * TH
    bytes_ = (work.BWD_BYTES_PER_PAIR * walked + work.BWD_BYTES_PER_PIXEL * T * ts * ts
              + work.BWD_BYTES_PER_TILE * T)
    per_eval, per_hit = work.BWD_INSTR_PER_EVAL, work.BWD_INSTR_PER_HIT
    bound_ms, bound_by, bytes_ms, ops_ms = work.kernel_bound(bytes_, (per_eval + per_hit) * hits)
    dense_bound_ms = work.kernel_bound(bytes_, per_eval * evals + per_hit * hits)[0]
    log(f"{tag} kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events), plain "
        f"{plain_ms:.3f} ms; bound: {walked} walked pairs, {bytes_} B -> {bytes_ms:.4f} ms; "
        f"{hits} hits x {per_eval + per_hit} FP32 instructions -> "
        f"{ops_ms:.4f} ms; dense bound ({evals} evaluations x {per_eval} more) "
        f"{dense_bound_ms:.4f} ms")
    check(ms >= bound_ms, f"blend_backward reads {ms} ms, below its bound {bound_ms} ms")
    return dict(
        name="blend_backward",
        route="cuda",
        source="binocular3dgs_torch/csrc/blend_backward.cu",
        replaces="binocular3dgs_tpu/ops/blend_pallas.py:777",
        launches=None,
        max_abs_err=max(v["max_abs"] for v in rows.values()),
        parity=dict(rows=rows, tol="1e-3 x max|row|", walked_pairs=walked, evaluations=evals,
                    hits=hits),
        ms=ms,
        event_ms=event_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        dense_bound_ms=dense_bound_ms,
        library_ms=None,
        library_note="none: no single PyTorch call computes the blend backward",
    )


def phase_warp_parity(torch, view0, seed, trans=0.2, tag="[8 warp]"):
    """W1 and W2 against their plain versions on phase 5's view-0 render
    and the disparity of a binocular shift `trans` (disparity =
    focal_x * -trans / depth); W2 must equal its plain version bit for bit
    and repeat itself bit for bit. Times and bounds of both."""
    from benchmark.work import kernel_bound
    from binocular3dgs_torch.ops import warp

    image, depth, cam = view0
    disparity = cam.focal_x * (-trans) / (depth + 1e-5)
    rng = np.random.default_rng(seed + 8)
    d_out = torch.from_numpy(rng.normal(size=tuple(image.shape)).astype(np.float32)).to(
        image.device)
    out, diff = warp.warp_forward(image, disparity)
    d_img = warp.warp_backward(disparity, d_out)
    d_img_again = warp.warp_backward(disparity, d_out)
    torch.cuda.synchronize()
    want_out, want_diff = warp.warp_forward_torch(image, disparity)
    want_d_img = warp.warp_backward_torch(disparity, d_out)
    err_out = (out - want_out).abs().max().item()
    err_diff = (diff - want_diff).abs().max().item()
    err_d_img = (d_img - want_d_img).abs().max().item()
    d_img_equal = torch.equal(d_img.view(torch.int32), want_d_img.view(torch.int32))
    d_img_repeats = torch.equal(d_img.view(torch.int32), d_img_again.view(torch.int32))
    valid = warp.warp_mask(disparity, cam.height, cam.width).bool()
    valid_share = valid.float().mean().item()
    d_lo, d_hi = disparity.min().item(), disparity.max().item()
    v_lo, v_hi = disparity[valid].min().item(), disparity[valid].max().item()
    log(f"{tag} shift {trans}: disparity {d_lo:.2f}..{d_hi:.2f} px ({v_lo:.2f}..{v_hi:.2f} on "
        f"valid pixels), valid share {valid_share:.4f}; W1 max|diff| out {err_out:.3e} diff "
        f"{err_diff:.3e} (tol 1e-6); W2 d_image bit-equal to the plain version {d_img_equal} "
        f"(max|diff| {err_d_img:.3e}), two launches bit-equal {d_img_repeats}")
    check(err_out <= 1e-6 and err_diff <= 1e-6, f"warp forward differs by {err_out}, {err_diff}")
    check(d_img_equal, f"warp backward is not bit-equal to its plain version ({err_d_img})")
    check(d_img_repeats, "two launches of warp backward differ")
    check(0.05 < valid_share, "the warp's disparity leaves almost no valid pixel")

    pixels = cam.height * cam.width
    parity = dict(out_max_abs=err_out, diff_max_abs=err_diff, d_image_max_abs=err_d_img,
                  d_image_bit_equal=d_img_equal, d_image_repeats=d_img_repeats, shift=trans,
                  valid_share=valid_share, disparity_range=[d_lo, d_hi],
                  valid_disparity_range=[v_lo, v_hi])
    res = []
    for name, fn, plain, bpp, tpu_line, err in (
        ("warp_forward", lambda: warp.warp_forward(image, disparity),
         lambda: warp.warp_forward_torch(image, disparity), WARP_FWD_BYTES_PER_PIXEL,
         "binocular3dgs_tpu/ops/warp_pallas.py:156", max(err_out, err_diff)),
        ("warp_backward", lambda: warp.warp_backward(disparity, d_out),
         lambda: warp.warp_backward_torch(disparity, d_out), WARP_BWD_BYTES_PER_PIXEL,
         "binocular3dgs_tpu/ops/warp_pallas.py:183", err_d_img),
    ):
        ms, event_ms = kernel_times(torch, fn, f"{name}_kernel")
        plain_ms = median_ms(torch, plain)
        bound_ms, bound_by, _, _ = kernel_bound(bpp * pixels, 0)
        log(f"{tag} {name} kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events "
            f"around the wrapper), plain {plain_ms:.4f} ms; bound {bpp * pixels} B -> "
            f"{bound_ms:.4f} ms")
        check(ms >= bound_ms, f"{name} reads {ms} ms, below its bound {bound_ms} ms")
        res.append(dict(
            name=name, route="cuda", source="binocular3dgs_torch/csrc/warp.cu",
            replaces=tpu_line, launches=None, max_abs_err=err, parity=parity,
            ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, library_note=WARP_NO_LIBRARY,
        ))
    return res


def vertex_rows(seed, n, active_n, width, height, device):
    """(model, camera) of `n` capacity rows, the first `active_n` drawn as
    make_workload draws (SH degree 1, rest bands drawn too), the others the
    model's padding (zeros, log-scale -20, the identity quaternion); a
    camera turned about two axes, so that no product with it is exact."""
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy

    rng = np.random.default_rng(seed)
    a = active_n
    q = rng.normal(size=(a, 4))
    params = dict(xyz=np.zeros((n, 3)), f_dc=np.zeros((n, 1, 3)), f_rest=np.zeros((n, 3, 3)),
                  opacity=np.zeros((n, 1)), scaling=np.full((n, 3), -20.0),
                  rotation=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)))
    params["xyz"][:a] = np.stack([rng.uniform(-2, 2, a), rng.uniform(-1.5, 1.5, a),
                                  rng.uniform(3, 9, a)], 1)
    params["f_dc"][:a] = rng.normal(size=(a, 1, 3)) * 0.3
    params["f_rest"][:a] = rng.normal(size=(a, 3, 3)) * 0.1
    params["opacity"][:a] = rng.uniform(-2, 1, (a, 1))
    params["scaling"][:a] = np.log(rng.uniform(0.005, 0.02, (a, 3)))
    params["rotation"][:a] = q / np.linalg.norm(q, axis=1, keepdims=True)
    active = np.zeros(n, bool)
    active[:a] = True
    R = np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]])  # no zeros
    R = R @ np.array([[1.0, 0.0, 0.0], [0.0, 0.995, -0.0998], [0.0, 0.0998, 0.995]])
    return (from_numpy(params, active, 1, 1, device=device),
            make_camera(R, np.array([0.05, -0.02, 0.1]), FOVX, FOVY, width, height,
                        device=device))


def launches_of(torch, fn):
    """Device operations (kernels, copies, sets) of one call of fn, from the
    profiler, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def phase_vertex(torch, seed, device, tag="[22 vertex]"):
    """The vertex stage's kernels at the benchmark cells' row counts: the
    forward against project_gaussians on the card, bit for bit in every
    field, the backward against autograd
    of project_gaussians (1e-3 of each row's largest entry) and against
    project_backward_torch (1e-5); each kernel's device time with L2 flushed
    beside its byte bound, the plain version's time (CUDA events) and its
    device operations per call."""
    from benchmark.work import kernel_bound
    from binocular3dgs_torch.models.gaussians import PARAM_NAMES
    from binocular3dgs_torch.ops.project import (
        ProjectedGaussians, project_backward, project_backward_torch, project_forward,
        project_gaussians,
    )

    fwd, bwd = {}, {}
    for cell, n, active_n, width, height in VERTEX_SHAPES:
        model, cam = vertex_rows(seed + 22, n, active_n, width, height, device)
        leaves = [getattr(model.params, k) for k in PARAM_NAMES]
        carrier = torch.zeros(n, 2, device=device)
        args = (*leaves, model.active, cam, 1, 0.3, 0.2)

        def plain_forward(grad):
            ls = [x.detach().requires_grad_(grad) for x in leaves]
            c = carrier.clone().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                proj = project_gaussians(
                    ls[0], torch.exp(ls[4]), ls[5], torch.sigmoid(ls[3])[..., 0],
                    torch.cat([ls[1], ls[2]], 1), model.active, cam, 1, mean2d_carrier=c)
            return proj, ls + [c]

        got = project_forward(*args, carrier)
        want, inputs = plain_forward(True)
        torch.cuda.synchronize()
        # bit for bit: the kernel rounds the camera products as cuBLAS and
        # the norms as PyTorch's reductions do on the card (csrc/project.cu),
        # which keeps the benchmark's reference comparison at its rounding
        errs = {k: (getattr(got, k).float() - getattr(want, k).float()).abs().max().item()
                for k in ProjectedGaussians._fields}
        equal = {k: (getattr(got, k) == getattr(want, k)).float().mean().item()
                 for k in ProjectedGaussians._fields}
        check(all(v == 1.0 for v in equal.values()),
              f"{tag} {cell} project_forward differs from project_gaussians: share of equal "
              f"values {equal}, max|diff| {errs}")

        gen = torch.Generator().manual_seed(seed + 23)
        cots = [torch.randn(shape, generator=gen).to(device)
                for shape in ((n, 2), (n,), (n, 3), (n, 3), (n,))]
        outs = [want.mean2d, want.depth, want.conic, want.color, want.opacity]
        grads = project_backward(*args, *cots, True)
        torch.cuda.synchronize()
        want_g = torch.autograd.grad(outs, inputs, grad_outputs=cots, retain_graph=True)
        plain_g = project_backward_torch(*args, *cots, True)
        rel_autograd, rel_plain = {}, {}
        for k, g, w, pl in zip(PARAM_NAMES + ("carrier",), grads, want_g, plain_g):
            g, w, pl = g.reshape(n, -1), w.reshape(n, -1), pl.reshape(n, -1)
            rel_autograd[k] = ((g - w).abs() / w.abs().amax(1, keepdim=True)).nan_to_num(
                0.0, posinf=np.inf).max().item()
            rel_plain[k] = ((g - pl).abs() / pl.abs().amax(1, keepdim=True)).nan_to_num(
                0.0, posinf=np.inf).max().item()
            check(rel_autograd[k] <= 1e-3, f"{tag} {cell} project_backward {k} differs from "
                                            f"autograd by {rel_autograd[k]} of its row")
            check(rel_plain[k] <= 1e-5, f"{tag} {cell} project_backward {k} differs from "
                                         f"project_backward_torch by {rel_plain[k]} of its row")
        log(f"{tag} {cell}: {n} rows ({active_n} active, {int(got.visible.sum())} visible) at "
            f"{width}x{height}; forward equal to project_gaussians bit for bit in every field; "
            f"backward max|diff| / row max vs autograd "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel_autograd.items())
            + " (tol 1e-3), vs project_backward_torch "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel_plain.items()) + " (tol 1e-5)")

        for res, name, fn, plain, bpr in (
            (fwd, "project_forward", lambda: project_forward(*args, carrier),
             lambda: plain_forward(False), VERTEX_FWD_BYTES_PER_ROW),
            (bwd, "project_backward", lambda: project_backward(*args, *cots, True),
             lambda: torch.autograd.grad(outs, inputs, grad_outputs=cots, retain_graph=True),
             VERTEX_BWD_BYTES_PER_ROW),
        ):
            ms, event_ms = kernel_times(torch, fn, f"{name}_kernel")
            plain_ms = median_ms(torch, plain, warmup=1, iters=5)
            plain_ops = launches_of(torch, plain)
            bound_ms, bound_by, _, _ = kernel_bound(bpr * n, 0)
            log(f"{tag} {cell} {name} kernel {ms:.4f} ms (profiler, L2 flushed; {event_ms:.4f} "
                f"ms CUDA events around the wrapper), bound {bpr * n} B -> {bound_ms:.4f} ms "
                f"({ms / bound_ms:.2f}x); plain {plain_ms:.4f} ms in {plain_ops} device "
                f"operations")
            check(ms >= bound_ms, f"{name} reads {ms} ms, below its bound {bound_ms} ms")
            res[cell] = dict(rows=n, active=active_n, ms=ms, event_ms=event_ms,
                             bound_ms=bound_ms, bound_by=bound_by, bytes=bpr * n,
                             plain_ms=plain_ms, plain_device_ops=plain_ops)
        res = fwd[cell]
        res["parity"] = dict(max_abs=errs, equal_share=equal)
        bwd[cell]["parity"] = dict(rel_autograd=rel_autograd, rel_plain=rel_plain)
        del model, leaves, carrier, got, want, inputs, grads, want_g, plain_g, outs, cots
        torch.cuda.empty_cache()
    kernels = []
    for name, res in (("project_forward", fwd), ("project_backward", bwd)):
        first = res[VERTEX_SHAPES[0][0]]
        kernels.append(dict(
            name=name, route="cuda", source="binocular3dgs_torch/csrc/project.cu",
            replaces=VERTEX_NO_TPU_KERNEL, launches=None, ms=first["ms"],
            event_ms=first["event_ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
            library_note="none: no single PyTorch call computes the vertex stage", cells=res))
    return kernels


def phase_ssim(torch, seed, device, tag="[23 ssim]"):
    """SSIM's kernels at the cells' image sizes: S1's maps equal to
    ssim_maps_torch's bit for bit (its blurs sum as the plain composition's
    convolution does) and its mean the plain composition's (1e-6: summed in
    another order), S2 against autograd of the plain composition and
    against ssim_backward_torch of S1's maps (1e-4 of the largest entry:
    S2 blurs separably); two launches of each bit for bit; each kernel's
    device time with L2 flushed beside its bound (S1's with its mean
    kernel's), the plain version's time (CUDA events) and its device
    operations per call."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.work import kernel_bound
    from binocular3dgs_torch.ops import losses

    def max_rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    pinned = dict(zip(("torch", "cuda"), losses.SSIM_CONV_PINNED))
    card = dict(torch=torch.__version__, cuda=torch.version.cuda)
    fwd, bwd = {}, {}
    for cell, h, w in SSIM_SHAPES:
        gen = torch.Generator().manual_seed(seed + 23)
        gt = torch.rand(1, 3, h, w, generator=gen)
        x = (gt + 0.1 * torch.randn(1, 3, h, w, generator=gen)).clamp(0, 1).to(device)
        gt = gt.to(device)
        up = torch.tensor(-0.2, device=device)  # -lambda_dssim, as the step's loss gives it
        value, maps = losses.ssim_forward(x, gt, maps=True)
        dx = losses.ssim_backward(x, gt, maps, up)
        value2, maps2 = losses.ssim_forward(x, gt, maps=True)
        dx2 = losses.ssim_backward(x, gt, maps2, up)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip((value, *maps, dx), (value2, *maps2, dx2)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            want_value, want_maps = losses.ssim_maps_torch(x, gt)
            torch.cuda.synchronize()
        depthwise = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "conv_depthwise2d_forward" in e.key)
        log(f"{tag} {cell} the plain blurs: {depthwise} conv_depthwise2d launches (want 5); "
            f"S1's sums pinned to PyTorch {pinned['torch']} with CUDA {pinned['cuda']}, the "
            f"card runs {card['torch']} with {card['cuda']}")
        check(depthwise == 5, f"{tag} {cell} the plain blurs left conv_depthwise2d")
        xp = x.clone().requires_grad_()
        plain_value = losses.ssim_torch(xp, gt)
        (want_dx,) = torch.autograd.grad(plain_value, [xp], grad_outputs=up, retain_graph=True)
        errs = dict(value=abs(float(value - want_value)),
                    maps_equal=[bool(torch.equal(m, wm)) for m, wm in zip(maps, want_maps)],
                    dx_autograd=max_rel(dx, want_dx),
                    dx_plain=max_rel(dx, losses.ssim_backward_torch(x, gt, maps, up)))
        log(f"{tag} {cell} 3x{h}x{w}: S1 mean {float(value):.7f} vs plain "
            f"{float(want_value):.7f} (|diff| {errs['value']:.2e}, tol 1e-6); maps equal to "
            f"ssim_maps_torch's bit for bit {errs['maps_equal']}; S2 vs autograd "
            f"{errs['dx_autograd']:.2e}, vs ssim_backward_torch {errs['dx_plain']:.2e} (tol "
            f"1e-4); two launches of each bit for bit: {repeat}")
        check(errs["value"] <= 1e-6, f"{tag} {cell} S1's mean differs by {errs['value']}")
        check(all(errs["maps_equal"]), f"{tag} {cell} S1's maps differ from ssim_maps_torch's")
        check(max(errs["dx_autograd"], errs["dx_plain"]) <= 1e-4,
              f"{tag} {cell} S2 differs by {errs}")
        check(repeat, f"{tag} {cell} two launches of S1 or S2 differ")

        elems = 3 * h * w
        for res, name, fn, plain, nbytes, instr in (
            (fwd, "ssim_forward", lambda: losses.ssim_forward(x, gt, maps=True),
             lambda: losses.ssim_torch(xp, gt), SSIM_FWD_BYTES, SSIM_FWD_INSTR),
            (bwd, "ssim_backward", lambda: losses.ssim_backward(x, gt, maps, up),
             lambda: torch.autograd.grad(plain_value, [xp], grad_outputs=up, retain_graph=True),
             SSIM_BWD_BYTES, SSIM_BWD_INSTR),
        ):
            ms, event_ms = kernel_times(torch, fn, f"{name}_kernel")
            mean_ms = kernel_device_ms(torch, fn, "ssim_forward_mean_kernel") \
                if name == "ssim_forward" else 0.0
            ms += mean_ms
            plain_ms = median_ms(torch, plain, warmup=1, iters=5)
            plain_ops = launches_of(torch, plain)
            bound_ms, bound_by, bytes_ms, ops_ms = kernel_bound(nbytes * elems, instr * elems)
            log(f"{tag} {cell} {name} kernels {ms:.4f} ms (profiler, L2 flushed; the mean "
                f"kernel's {mean_ms:.4f}; {event_ms:.4f} ms CUDA events around the wrapper), "
                f"bound {nbytes * elems} B -> {bytes_ms:.4f} ms, {instr * elems} instructions "
                f"-> {ops_ms:.4f} ms ({ms / bound_ms:.2f}x the {bound_by} bound); plain "
                f"{plain_ms:.4f} ms in {plain_ops} device operations")
            check(ms >= bound_ms, f"{name} reads {ms} ms, below its bound {bound_ms} ms")
            res[cell] = dict(shape=[3, h, w], ms=ms, mean_kernel_ms=mean_ms, event_ms=event_ms,
                             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes * elems,
                             instructions=instr * elems, plain_ms=plain_ms,
                             plain_device_ops=plain_ops)
        fwd[cell]["parity"] = dict(value=errs["value"], maps_equal=errs["maps_equal"],
                                   repeat=repeat, depthwise_launches=depthwise, pinned=pinned,
                                   card=card)
        bwd[cell]["parity"] = dict(autograd=errs["dx_autograd"], plain=errs["dx_plain"])
        del x, gt, maps, maps2, dx, dx2, xp, plain_value, want_dx, want_maps
        torch.cuda.empty_cache()
    kernels = []
    for name, res in (("ssim_forward", fwd), ("ssim_backward", bwd)):
        first = res[SSIM_SHAPES[0][0]]
        kernels.append(dict(
            name=name, route="cuda", source="binocular3dgs_torch/csrc/ssim.cu",
            replaces=SSIM_NO_TPU_KERNEL, launches=None, ms=first["ms"],
            event_ms=first["event_ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
            library_note="none: no single PyTorch call computes SSIM", cells=res))
    return kernels


def stage_device(torch, fn, reps=5):
    """(device ms per call, device operations per call, the five largest
    operations by device time) of fn() under a CUDA-only profiler with L2
    flushed before each call; the flushes, profiled alone, are taken out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20 // 4, device="cuda")

    def run(body):
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                body()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in evs), sum(e.count for e in evs),
                {e.key: e.self_device_time_total / reps / 1e3 for e in evs})

    us, ops, per_op = run(fn)
    us0, ops0, _ = run(lambda: None)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:5]
    return (us - us0) / 1e3 / reps, (ops - ops0) / reps, [(k[:60], v) for k, v in top]


def phase_binning(torch, seed, device, tag="[24 binning]"):
    """Binning, the record gather and its backward (csrc/binning.cu) at the
    cells' rows and image sizes against the plain stages: every output bit
    for bit, device times with L2 flushed beside the bytes the stages must
    move, device operations, and one render's launch gate."""
    from benchmark.work import kernel_bound
    from binocular3dgs_torch.config import RasterConfig
    from binocular3dgs_torch.ops.binning import (
        bin_gaussians, bin_gaussians_torch, bin_launches, tile_grid,
    )
    from binocular3dgs_torch.ops.rasterize import (
        _build_fields, _GatherRecords, gather_records, project_for_render,
    )

    raster = RasterConfig()
    names = ("mean2d", "conic", "opacity", "color", "depth")
    stages = {"bin": {}, "gather": {}, "gather_backward": {}}
    for cell, n, active_n, width, height in VERTEX_SHAPES:
        model, cam = vertex_rows(seed + 24, n, active_n, width, height, device)
        with torch.no_grad():
            proj = project_for_render(cam, model, raster)
        leaves = {k: getattr(proj, k).clone().requires_grad_(True) for k in names}
        pj = proj._replace(**leaves)
        ts, cap = raster.tile_size, raster.pairs_per_gaussian * n
        TW, TH = tile_grid(width, height, ts)

        def bin_():
            return bin_gaussians(pj.mean2d, pj.bin_extent, pj.depth, width, height, ts, cap)

        def bin_plain():
            return bin_gaussians_torch(pj.mean2d, pj.bin_extent, pj.depth, width, height, ts,
                                       cap)

        launch_counts(reset=True)
        b = bin_()
        records = gather_records(pj, b)
        cot = torch.zeros(10, cap, device=device)
        E = int(b.bin_slots)
        cot[:, :E] = torch.randn(10, E, generator=torch.Generator(device=device).manual_seed(
            seed + 25), device=device)
        grads = torch.autograd.grad(records, list(leaves.values()), cot, retain_graph=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        want_launches = collections.Counter(bin_launches(TW * TH), gather_forward=1,
                                            gather_transpose=1, gather_backward=1)
        check(launches == want_launches, f"{tag} {cell} one render's launches {launches}, "
                                         f"expected {want_launches}")

        bp = bin_plain()
        spread = torch.where(torch.arange(cap, device=device) < E, bp.pair_gauss,
                             torch.arange(cap, device=device, dtype=torch.int32) % n)
        fields_d = torch.index_select(_build_fields(pj), 1, bp.order)
        records_p = _GatherRecords.apply(fields_d, spread)
        grads_p = torch.autograd.grad(records_p, list(leaves.values()), cot, retain_graph=True)
        equal = {f: bool(torch.equal(getattr(b, f), getattr(bp, f))) for f in (
            "order", "tile_start", "tile_count", "num_pairs", "rank_offsets", "rank_of",
            "bin_slots")}
        equal.update({f: bool(torch.equal(getattr(b, f)[:E], getattr(bp, f)[:E]))
                      for f in ("pair_gauss", "pair_tile", "sorted_pos")})
        equal["records"] = bool(torch.equal(records[:, :E], records_p[:, :E]))
        equal.update({f"d_{k}": bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
                      for k, x, y in zip(names, grads, grads_p)})
        emitting = int((b.rank_offsets[1:] > b.rank_offsets[:-1]).sum())
        log(f"{tag} {cell}: {n} rows ({active_n} active, {emitting} emitting) at "
            f"{width}x{height}, {TW * TH} tiles, {int(b.num_pairs)} pairs wanted of {cap} slots "
            f"({E} sorted); equal to the plain stages bit for bit: {equal}; one render's "
            f"launches {launches}")
        check(all(equal.values()), f"{tag} {cell} differs from the plain stages: {equal}")

        def gather():
            with torch.no_grad():
                return gather_records(pj, b)

        def gather_plain():
            with torch.no_grad():
                return _GatherRecords.apply(torch.index_select(_build_fields(pj), 1, bp.order),
                                            spread)

        for stage, fn, plain in (
                ("bin", bin_, bin_plain), ("gather", gather, gather_plain),
                ("gather_backward",
                 lambda: torch.autograd.grad(records, list(leaves.values()), cot,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(records_p, list(leaves.values()), cot,
                                             retain_graph=True))):
            ms, ops, top = stage_device(torch, fn)
            plain_ms, plain_ops, plain_top = stage_device(torch, plain)
            stages[stage][cell] = dict(ms=ms, device_ops=ops, top=top, plain_ms=plain_ms,
                                       plain_device_ops=plain_ops, plain_top=plain_top,
                                       event_ms=median_ms(torch, fn, iters=10))
        bytes_ = (BIN_BYTES_PER_PAIR * E + BIN_BYTES_PER_ROW * n
                  + BIN_BYTES_PER_EMITTING_ROW * emitting)
        bound_ms, bound_by, _, _ = kernel_bound(bytes_, 0)
        total = sum(stages[k][cell]["ms"] for k in stages)
        plain_total = sum(stages[k][cell]["plain_ms"] for k in stages)
        log(f"{tag} {cell}: device ms with L2 flushed (operations) "
            + ", ".join(f"{k} {v[cell]['ms']:.4f} ({v[cell]['device_ops']:.0f}) against the "
                        f"plain {v[cell]['plain_ms']:.4f} ({v[cell]['plain_device_ops']:.0f})"
                        for k, v in stages.items())
            + f"; together {total:.4f} ms against {plain_total:.4f}, bound {bytes_} B -> "
            f"{bound_ms:.4f} ms ({total / bound_ms:.2f}x); largest: "
            + "; ".join(f"{k} {v[cell]['top']}" for k, v in stages.items()))
        check(total >= bound_ms, f"{tag} {cell} reads {total} ms, below its bound {bound_ms}")
        for k in stages:
            stages[k][cell].update(rows=n, pairs=E, tiles=TW * TH)
        stages["bin"][cell].update(bound_ms=bound_ms, bytes=bytes_, together_ms=total,
                                   plain_together_ms=plain_total, parity=equal,
                                   launches=launches)
        del model, proj, pj, leaves, b, bp, records, records_p, grads, grads_p, cot, fields_d
        torch.cuda.empty_cache()
    first = VERTEX_SHAPES[0][0]
    kernels = []
    for name, stage, note in (
            ("bin_emit", "bin", "the binning kernels: " + ", ".join(bin_launches(2**16))),
            ("gather_forward", "gather", "the record gather"),
            ("gather_backward", "gather_backward", "the record gather's backward")):
        res = stages[stage][first]
        kernels.append(dict(
            name=name, stage=note, route="cuda", source="binocular3dgs_torch/csrc/binning.cu",
            replaces=BIN_NO_TPU_KERNEL, launches=None, ms=res["ms"], event_ms=res["event_ms"],
            plain_ms=res["plain_ms"], bound_ms=stages["bin"][first]["bound_ms"] if
            stage == "bin" else None, bound_by="bytes of the three stages together",
            library_ms=None, library_note="none: no one PyTorch call bins or gathers",
            cells=stages[stage]))
    return kernels


def plain_render_image(torch, cam, model, bg, raster):
    """The image of render_tiled with the blend done by its plain PyTorch
    version, from the rasterizer's own stages."""
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.blend_cuda import blend_forward_torch
    from binocular3dgs_torch.ops.rasterize import _tiles_to_planes, project_for_render

    ts = raster.tile_size
    TW, TH = tile_grid(cam.width, cam.height, ts)
    proj = project_for_render(cam, model, raster=raster)
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, ts,
                      raster.pairs_per_gaussian * model.capacity)
    records = sorted_records(torch, proj, b)
    out5, _ = blend_forward_torch(records, b.tile_start, b.tile_count, TW, TH, ts)
    planes = _tiles_to_planes(out5, TW, TH, ts, cam.height, cam.width)
    return planes[0:3] + planes[4][None] * bg[:, None, None]


def phase_main_path(torch, model, device, raster):
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy
    from binocular3dgs_torch.ops import blend_cuda
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.rasterize import (
        _tiles_to_planes, gather_records, project_for_render, render_tiled,
    )
    from binocular3dgs_torch.ops.rasterize_reference import render_dense

    cams = [make_camera(R, T, FOVX, FOVY, W, H, device=device) for R, T in arc_poses(N_VIEWS)]
    bg = torch.zeros(3, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launch_counts(reset=True)
    outs = [render_tiled(cam, model, bg, raster=raster, device=device) for cam in cams]
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts["blend_forward"]
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    log(f"[5 main] {N_VIEWS} renders, blend_forward launches {launches}, project_forward "
        f"{counts['project_forward']}, project_backward {counts['project_backward']}, peak "
        f"memory {peak_mb:.1f} MiB")
    check(launches == N_VIEWS, f"blend_forward launched {launches} times for {N_VIEWS} renders")
    check(counts["project_forward"] == N_VIEWS and counts["project_backward"] == 0,
          f"the vertex stage's kernels launched {counts} for {N_VIEWS} renders")
    for i, out in enumerate(outs):
        check(out.image.shape == (3, H, W), f"view {i} image shape {tuple(out.image.shape)}")
        check(bool(torch.isfinite(out.image).all() & torch.isfinite(out.depth).all()),
              f"view {i} has non-finite values")
        check(int(out.num_pairs) <= out.pair_capacity, f"view {i} overflows the pair capacity")
    coverage = [float(o.alpha.mean()) for o in outs]
    log(f"[5 main] mean alpha per view {[round(c, 4) for c in coverage]}")
    check(min(coverage) > 0.05, "a view renders almost nothing")

    # end to end: the kernel path against the plain blend on the same view
    plain = plain_render_image(torch, cams[0], model, bg, raster)
    e2e = (plain - outs[0].image).abs().max().item()
    log(f"[5 main] view 0, kernel vs plain blend: max|image diff| {e2e:.3e} (tol 1e-4)")
    check(e2e <= 1e-4, f"kernel render differs from the plain render by {e2e}")

    # small input: the tiled render against the dense oracle
    rng = np.random.default_rng(1)
    n = 48
    q = rng.normal(size=(n, 4))
    small = from_numpy(dict(
        xyz=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                      rng.uniform(3, 9, n)], 1),
        f_dc=rng.normal(size=(n, 1, 3)) * 0.5, f_rest=rng.normal(size=(n, 3, 3)) * 0.1,
        opacity=rng.uniform(-1.5, 3.0, (n, 1)), scaling=np.log(rng.uniform(0.05, 0.4, (n, 3))),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
    ), np.ones(n, bool), 1, 1, device=device)
    scam = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, 64, 48, device=device)
    got = render_tiled(scam, small, [0.1, 0.2, 0.3], device=device)
    want = render_dense(scam, small, torch.tensor([0.1, 0.2, 0.3], device=device))
    small_err = (got.image - want.image).abs().max().item()
    log(f"[5 main] 64x48 tiled vs dense oracle: max|image diff| {small_err:.3e} (tol 1e-4)")
    check(small_err <= 1e-4, f"tiled render differs from the dense oracle by {small_err}")

    # times on view 0: the whole render and each stage
    cam = cams[0]
    ts = raster.tile_size
    TW, TH = tile_grid(W, H, ts)
    cap = raster.pairs_per_gaussian * model.capacity
    render_ms = median_ms(torch, lambda: render_tiled(cam, model, bg, raster=raster,
                                                      device=device))
    proj = project_for_render(cam, model, raster=raster)
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts, cap)
    records = gather_records(proj, b)
    out5, _ = blend_cuda.blend_forward(records, b.tile_start, b.tile_count, TW, TH, ts)
    stages = {
        "project": lambda: project_for_render(cam, model, raster=raster),
        "bin": lambda: bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts, cap),
        "gather": lambda: gather_records(proj, b),
        "blend": lambda: blend_cuda.blend_forward(records, b.tile_start, b.tile_count, TW, TH, ts),
        "planes": lambda: _tiles_to_planes(out5, TW, TH, ts, H, W).contiguous(),
    }
    stage_ms = {k: median_ms(torch, fn) for k, fn in stages.items()}
    log(f"[5 main] render median {render_ms:.4f} ms over 20 (after 3 warm-ups); stages "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items()) + " ms")
    busy = device_busy(torch, lambda: render_tiled(cam, model, bg, raster=raster, device=device),
                       "[5 main]", render_ms)
    result = dict(launches=launches, project_launches=counts["project_forward"],
                  render_ms=render_ms, stage_ms=stage_ms, peak_mib=peak_mb,
                  e2e_plain_max_abs=e2e, dense_small_max_abs=small_err, **busy)
    return result, (outs[0].image, outs[0].depth, cams[0])


def device_busy(torch, fn, tag, unprofiled_ms, reps=10):
    """Kernel time per call and the device's busy share, from torch.profiler
    over `reps` calls: of the wall time under the profiler (whose own host
    cost is inside it, so a lower bound) and of `unprofiled_ms`, the
    unprofiled median of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernel_us = sum(e.self_device_time_total for e in kernels)
    if kernel_us <= 0:
        log(f"{tag} profiler saw no device time: busy share not measured")
        return dict(kernel_ms_per_call=None, kernels_per_call=None,
                    device_busy_share_profiled=None,
                    device_busy_share_unprofiled=None, top_kernels_us=None)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    kernel_ms = kernel_us / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    log(f"{tag} profiler: {kernel_ms:.4f} ms of kernels per call ({launches:.1f} kernel "
        f"launches), {wall_ms / reps:.4f} ms wall "
        f"per call, device busy under the profiler {kernel_us / 1e3 / wall_ms:.3f}, against "
        f"the unprofiled median {kernel_ms / unprofiled_ms:.3f}; top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / reps:.1f} us" for e in top))
    return dict(kernel_ms_per_call=kernel_ms, kernels_per_call=launches,
                device_busy_share_profiled=kernel_us / 1e3 / wall_ms,
                device_busy_share_unprofiled=kernel_ms / unprofiled_ms,
                top_kernels_us={e.key[:80]: e.self_device_time_total / reps for e in top})


def write_colmap_scene(root, seed, n_points=20_000):
    """9 PINHOLE views at W x H on an arc, numpy-seeded PNGs, `n_points`
    random points in the workload's slab (create_from_pcd, its 3-NN scales
    and densification do real work on them), and a poses_bounds.npy of the
    same cameras with the depth range of the points, for `cli spiral`."""
    from PIL import Image

    from binocular3dgs_torch.core.transforms import fov2focal
    from binocular3dgs_torch.data import colmap

    os.makedirs(f"{root}/sparse/0", exist_ok=True)
    os.makedirs(f"{root}/images", exist_ok=True)
    rng = np.random.default_rng(seed)
    fx, fy = fov2focal(FOVX, W), fov2focal(FOVY, H)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([fx, fy, W / 2, H / 2]))}
    images = {}
    for i, (R, T) in enumerate(arc_poses(9), start=1):
        images[i] = colmap.ColmapImage(i, colmap.rotmat2qvec(R.T), T, 1, f"im_{i:02d}.png",
                                       np.zeros((0, 2)), np.zeros(0, dtype=np.int64))
        Image.fromarray(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)).save(
            f"{root}/images/im_{i:02d}.png")
    pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 9], (n_points, 3))
    colmap.write_cameras_binary(f"{root}/sparse/0/cameras.bin", cams)
    colmap.write_images_binary(f"{root}/sparse/0/images.bin", images)
    colmap.write_points3d_binary(f"{root}/sparse/0/points3D.bin", pts,
                                 rng.integers(0, 255, (n_points, 3)), np.zeros((n_points, 1)))
    # LLFF rows: [down, right, backwards, centre, (H, W, focal)], near, far
    rows = []
    for R, T in arc_poses(9):
        center = -R @ T
        pose = np.stack([R[:, 1], R[:, 0], -R[:, 2], center, [H, W, fx]], axis=1)
        z = (pts - center) @ R[:, 2]
        rows.append(np.concatenate([pose.ravel(), [z.min(), z.max()]]))
    np.save(f"{root}/poses_bounds.npy", np.asarray(rows))


def phase_entry_point(torch, model, scene, work):
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.config import Config, save_config
    from binocular3dgs_torch.models.gaussians import save_ply

    out = os.path.join(work, "model")
    save_ply(model, os.path.join(out, "point_cloud", "iteration_1", "point_cloud.ply"))
    cfg = Config()
    cfg.model.eval = True  # cli render takes its settings from this file alone
    save_config(cfg, os.path.join(out, "cfg_args.json"))
    launch_counts(reset=True)
    t0 = time.perf_counter()
    check(cli.main(["render", "-m", out, "-s", scene]) == 0, "cli render failed")
    t_render = time.perf_counter() - t0
    counts = launch_counts()
    n_render = counts["blend_forward"]
    for split, n in (("train", 3), ("test", 2)):
        d = os.path.join(out, split, "ours_1", "renders")
        check(os.path.isdir(d) and len(os.listdir(d)) == n, f"expected {n} {split} renders")
    t0 = time.perf_counter()
    check(cli.main(["metrics", "-m", out]) == 0, "cli metrics failed")
    t_metrics = time.perf_counter() - t0
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)["ours_1"]
    check(np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]), f"non-finite metrics {res}")
    log(f"[6 cli] render {t_render:.2f} s ({n_render} kernel launches), metrics "
        f"{t_metrics:.2f} s (host clock, image I/O included); results {res}")
    check(n_render == 5, f"cli render launched the kernel {n_render} times for 5 views")
    check(counts["project_forward"] == 5 and counts["project_backward"] == 0,
          f"cli render launched the vertex stage's kernels {counts} for 5 views")
    return dict(psnr=res["PSNR"], ssim=res["SSIM"], render_s=t_render, metrics_s=t_metrics)


_LAUNCH_BASE = collections.Counter()


def render_launches(renders, backward, width, height, tile_size=16):
    """The launches of the binning and record gather kernels and of the
    blend's work-item kernels beside B1 (its plan and chunk walk)
    in `renders` renders of `width` x `height`, `backward` of them
    differentiated."""
    from binocular3dgs_torch.ops.binning import bin_launches, tile_grid

    TW, TH = tile_grid(width, height, tile_size)
    out = {k: v * renders for k, v in bin_launches(TW * TH).items()}
    return dict(out, gather_forward=renders, gather_transpose=backward, gather_backward=backward,
                blend_plan=renders, blend_chunk=renders)


def launch_counts(reset=False):
    """The kernels' launches (binocular3dgs_torch.tracing) since the last
    call with `reset`: a Counter, which reads 0 for a kernel not launched
    and equals another Counter whatever zeros either holds."""
    from binocular3dgs_torch import tracing

    now = tracing.launches()
    if reset:
        _LAUNCH_BASE.clear()
        _LAUNCH_BASE.update(now)
    return now - _LAUNCH_BASE


def train_setup(torch, seed, device, n=N_GAUSS, width=W, height=H):
    """(step, state, camera, gt, alpha weight, bg, config) of the bench.py
    training workload at `n` gaussians and width x height on `device`."""
    from binocular3dgs_torch.config import Config
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy
    from binocular3dgs_torch.ops.rasterize import render_tiled
    from binocular3dgs_torch.train.state import init_train_state
    from binocular3dgs_torch.train.step import make_train_step

    params, active, gt = make_workload(seed, n, width, height)
    cfg = Config()
    cfg.raster.pairs_per_gaussian = PAIRS_PER_GAUSSIAN

    def render(cam, model, bg, mean2d_carrier=None):
        return render_tiled(cam, model, bg, raster=cfg.raster, device=device,
                            mean2d_carrier=mean2d_carrier)

    step = make_train_step(render, cfg, 1.0, binocular=True, use_alpha_weight=False)
    state = init_train_state(from_numpy(params, active, 1, 1, device=device))
    cam = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, width, height, device=device)
    return (step, state, cam, torch.from_numpy(gt).to(device),
            torch.zeros(height, width, device=device), torch.zeros(3, device=device), cfg)


def train_stages(torch, step, state, cam, gt, aw, bg, it, trans, reps=10):
    """Median CUDA-event ms of the stages of `reps` whole training steps:
    the forward (`compute_losses`: both renders, the warp, the losses), the
    backward (autograd, then opacity decay and the densification
    statistics) and the Adam update, with events recorded at the entry and
    exit of step.py's `compute_losses` and `adam_update`. When the host is
    slower than the card, as here, an event span is the host's time for the
    stage. Returns the stages and the state after the steps."""
    from binocular3dgs_torch.train import step as step_mod

    marks = []

    def timed(fn):
        def wrapper(*a, **k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            out = fn(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return out
        return wrapper

    originals = step_mod.compute_losses, step_mod.adam_update
    step_mod.compute_losses, step_mod.adam_update = (timed(f) for f in originals)
    try:
        spans = []
        for i in range(reps + 1):  # one warm-up
            marks.clear()
            end = torch.cuda.Event(enable_timing=True)
            state, _ = step(state, cam, gt, aw, it + i, trans(), bg)
            end.record()
            if i:
                spans.append((*marks, end))
        torch.cuda.synchronize()
    finally:
        step_mod.compute_losses, step_mod.adam_update = originals
    ms = {name: float(np.median([a.elapsed_time(b) for a, b in pairs]))
          for name, pairs in (
              ("forward_ms", [(m[0], m[1]) for m in spans]),
              ("backward_ms", [(m[1], m[2]) for m in spans]),
              ("adam_ms", [(m[2], m[3]) for m in spans]),
              ("rest_ms", [(m[3], m[4]) for m in spans]))}
    return ms, state


def phase_train(torch, device, seed):
    step, state, cam, gt, aw, bg, cfg = train_setup(torch, seed, device)
    gen = torch.Generator().manual_seed(seed)

    def trans():  # the binocular shift, as the trainer draws it
        return draw_trans(torch, gen, cfg.train.cam_trans_dist)

    it = 2
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, cam, gt, aw, it, trans(), bg)
        it += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launch_counts(reset=True)
    events, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state, m = step(state, cam, gt, aw, it, trans(), bg)
        e.record()
        events.append((s, e))
        metrics.append(m)
        it += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    expected = collections.Counter(
        blend_forward=2 * TRAIN_STEPS, blend_backward=2 * TRAIN_STEPS, warp_forward=TRAIN_STEPS,
        warp_backward=TRAIN_STEPS, project_forward=2 * TRAIN_STEPS,
        project_backward=2 * TRAIN_STEPS, ssim_forward=TRAIN_STEPS, ssim_backward=TRAIN_STEPS,
        **render_launches(2 * TRAIN_STEPS, 2 * TRAIN_STEPS, W, H))
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(m.loss + m.disparity_loss) for m in metrics]
    log(f"[9 train] {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-ups: launches {counts} "
        f"(expected {expected}); step median {float(np.median(step_ms)):.4f} ms (CUDA events), "
        f"{wall_ms:.4f} ms per step on the host clock; peak memory {peak_mb:.1f} MiB; losses "
        f"{[round(x, 5) for x in losses]}")
    check(counts == expected, f"training launches {counts}, expected {expected}")
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    check(all(float(m.disparity_loss) > 0 for m in metrics), "no disparity loss")
    pairs = max(int(m.num_pairs) for m in metrics)
    check(pairs <= metrics[0].pair_capacity, f"pair capacity overflow: {pairs}")
    check(bool(torch.isfinite(state.model.params.xyz).all()), "non-finite parameters")

    step_median = float(np.median(step_ms))
    stages, state = train_stages(torch, step, state, cam, gt, aw, bg, it, trans)
    it += 11
    log("[9 train] stages of 10 more steps (CUDA events at the entry and exit of "
        "compute_losses and adam_update): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))

    def one_step():
        nonlocal state, it
        state, _ = step(state, cam, gt, aw, it, trans(), bg)
        it += 1

    busy = device_busy(torch, one_step, "[9 train]", step_median)
    return dict(step_ms_median=step_median, step_ms=step_ms, host_ms_per_step=wall_ms,
                launches=counts, peak_mib=peak_mb, losses=losses, num_pairs_max=pairs,
                pair_capacity=metrics[0].pair_capacity, stages_ms=stages,
                small_card_vs_cpu=train_card_vs_cpu(torch, seed, device), **busy)


def train_card_vs_cpu(torch, seed, device):
    """One step at 5k gaussians and 256x192 on the card (the kernels) and
    on the CPU (their plain versions), from the same state and shift."""
    runs = {}
    for dev in (device, torch.device("cpu")):
        step, state, cam, gt, aw, bg, _ = train_setup(torch, seed + 9, dev, 5_000, 256, 192)
        state, m = step(state, cam, gt, aw, 2, 0.25, bg)
        runs[dev.type] = (state, m)
    (sg, mg), (sc, mc) = runs["cuda"], runs["cpu"]
    loss_g, loss_c = float(mg.loss + mg.disparity_loss), float(mc.loss + mc.disparity_loss)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    rel = {}
    for n in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        rel[n] = rel_norm(getattr(sg.adam_m, n).cpu(), getattr(sc.adam_m, n))
    rel["carrier_grad_norms"] = rel_norm(sg.grad_accum.cpu(), sc.grad_accum)
    log(f"[9 train] 5k gaussians 256x192, card vs CPU after one step: loss {loss_g:.7f} vs "
        f"{loss_c:.7f} (rel {loss_rel:.2e}, tol 1e-5); |d adam_m| / |adam_m| and carrier grad "
        f"norms: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (tol 1e-3)")
    check(loss_rel <= 1e-5, f"card and CPU losses differ by {loss_rel} (relative)")
    for k, v in rel.items():
        check(v <= 1e-3, f"card and CPU {k} differ by {v} (relative norm)")
    check(float(sc.grad_accum.norm()) > 0, "the small step has no carrier gradient")
    return dict(loss_card=loss_g, loss_cpu=loss_c, loss_rel=loss_rel, rel_norm=rel)


class TrainerProbe:
    """Wraps train/loop.py's Trainer while a `cli train` runs: keeps the
    trainer, its model's (point count, capacity, SH degree), a copy of every
    state buffer and its (adam_step, active and max SH degree,
    spatial_lr_scale) at the start of its first train() call, and the host
    time of each checkpoint write."""

    def __init__(self, torch):
        from binocular3dgs_torch.train import loop

        self.torch, self.loop = torch, loop
        self.trainer, self.at_start, self.save_s = None, None, []
        self.start_buffers, self.start_meta = None, None

    def __enter__(self):
        probe, cls = self, self.loop.Trainer
        self.originals = cls.train, cls.save_checkpoint

        def train(trainer, *a, **k):
            if probe.trainer is None:
                m = trainer.state.model
                probe.trainer = trainer
                probe.at_start = (int(m.count()), m.capacity, m.active_sh_degree)
                probe.start_buffers = {k: v.clone()
                                       for k, v in state_tensors(trainer.state).items()}
                probe.start_meta = state_meta(trainer.state)
            return probe.originals[0](trainer, *a, **k)

        def save_checkpoint(trainer, iteration):
            probe.torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.originals[1](trainer, iteration)
            probe.save_s.append(time.perf_counter() - t0)

        cls.train, cls.save_checkpoint = train, save_checkpoint
        return self

    def __exit__(self, *exc):
        self.loop.Trainer.train, self.loop.Trainer.save_checkpoint = self.originals


def state_tensors(state):
    """name -> tensor of every buffer of a TrainState."""
    from binocular3dgs_torch.models.gaussians import PARAM_NAMES

    out = {"active": state.model.active}
    for prefix, tree in (("params", state.model.params), ("adam_m", state.adam_m),
                         ("adam_v", state.adam_v)):
        out.update({f"{prefix}.{n}": getattr(tree, n) for n in PARAM_NAMES})
    out.update({n: getattr(state, n) for n in ("grad_accum", "denom", "max_radii2d")})
    return out


def state_meta(state):
    """(adam_step, active SH degree, max SH degree, spatial_lr_scale)."""
    m = state.model
    return state.adam_step, m.active_sh_degree, m.max_sh_degree, m.spatial_lr_scale


def differing_buffers(want, got):
    """Names of the buffers of two state_tensors() that differ in dtype,
    shape or any bit (float32 compared as int32 views, so NaNs compare)."""
    import torch

    def bits(v):
        return v.view(torch.int32) if v.dtype == torch.float32 else v

    return [k for k, v in want.items()
            if v.dtype != got[k].dtype or v.shape != got[k].shape
            or not torch.equal(bits(v), bits(got[k]))]


def phase_cli_train(torch, scene, work):
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.train.loop import load_checkpoint

    out = os.path.join(work, "trained")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    # on this random-noise scene at full width no point's mean carrier
    # gradient reaches the reference's 2e-4 in 20 iterations, so the point
    # count would not move; 1e-6 makes densification split and clone
    argv = ["train", "-s", scene, "-m", out, "--eval", "--iterations", "60",
            "--shift_cam_start", "20", "--densify_from_iter", "20",
            "--densification_interval", "20", "--densify_grad_threshold", "1e-6",
            "--test_iterations", "60", "--save_iterations", "60",
            "--checkpoint_iterations", "30", "60"]
    with TrainerProbe(torch) as probe:
        check(cli.main(argv) == 0, "cli train failed")
    t_train = time.perf_counter() - t0
    counts = launch_counts()

    # the last checkpoint against the trainer's final state, bit for bit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded, it = load_checkpoint(os.path.join(out, "chkpnt60.npz"), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    final = probe.trainer.state
    unequal = differing_buffers(state_tensors(final), state_tensors(loaded))
    same_meta = (it, *state_meta(loaded)) == (60, *state_meta(final))
    ckpt_mb = os.path.getsize(os.path.join(out, "chkpnt60.npz")) / 2**20
    log(f"[10 train cli] chkpnt60.npz ({ckpt_mb:.1f} MiB, capacity {loaded.model.capacity}, "
        f"{int(loaded.model.count())} points) loaded on the card in {load_s * 1e3:.1f} ms equals "
        f"the trainer's final state bit for bit: {not unequal and same_meta} "
        f"(buffers differing: {unequal}); checkpoint writes {[round(x, 4) for x in probe.save_s]} s "
        f"(host clock)")
    check(not unequal and same_meta, f"chkpnt60.npz differs from the final state in {unequal}")
    with open(os.path.join(out, "train_log.json")) as f:
        train_log = json.load(f)
    points = [e["points"] for e in train_log]
    disp = [e["disparity_loss"] for e in train_log if e["iteration"] > 20]
    ply = os.path.join(out, "point_cloud", "iteration_60", "point_cloud.ply")
    log(f"[10 train cli] 60 iterations in {t_train:.2f} s (host clock, scene load and the "
        f"iteration-60 report included); points per logged iteration {points}; disparity loss "
        f"after iteration 20 {[round(x, 5) for x in disp]}; launches {counts}")
    check(len(set(points)) > 1, f"densification left the point count at {points[0]}")
    check(disp and all(x > 0 for x in disp), "no disparity loss after shift_cam_start")
    check(os.path.exists(ply), "cli train wrote no PLY")
    t0 = time.perf_counter()
    check(cli.main(["render", "-m", out]) == 0, "cli render of the trained model failed")
    t_render = time.perf_counter() - t0
    for split, n in (("train", 3), ("test", 2)):
        d = os.path.join(out, split, "ours_60", "renders")
        check(os.path.isdir(d) and len(os.listdir(d)) == n, f"expected {n} {split} renders")
    t0 = time.perf_counter()
    check(cli.main(["metrics", "-m", out]) == 0, "cli metrics of the trained model failed")
    t_metrics = time.perf_counter() - t0
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)["ours_60"]
    check(np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]), f"non-finite metrics {res}")
    log(f"[10 train cli] render {t_render:.2f} s, metrics {t_metrics:.2f} s (host clock); "
        f"results {res}")
    return dict(train_s=t_train, render_s=t_render, metrics_s=t_metrics, points=points,
                disparity_loss=disp, launches=counts, psnr=res["PSNR"], ssim=res["SSIM"],
                checkpoint_write_s=probe.save_s, checkpoint_load_s=load_s,
                checkpoint_mib=ckpt_mb,
                pairs_per_gaussian=probe.trainer.raster.pairs_per_gaussian), out


def phase_resume(torch, scene, work, trained, pairs_per_gaussian):
    """cli train resumed from phase 10's chkpnt30.npz to 60 under the
    profiler; no report, so the launch counts are the 30 steps' alone. The
    state at the first resumed step is held bit for bit against the
    checkpoint (chkpnt30 precedes the densification at 40, so its point
    count and capacity alone are those of a fresh start). The
    pair capacity restarts from the flag and grows at the end of the first
    resumed span (31-40) when phase 10's grew."""
    import contextlib
    import io

    from binocular3dgs_torch import cli
    from binocular3dgs_torch.config import load_config
    from binocular3dgs_torch.train.loop import load_checkpoint

    ckpt = os.path.join(trained, "chkpnt30.npz")
    ckpt_state, _ = load_checkpoint(ckpt, "cuda")
    m = ckpt_state.model
    want = (int(m.count()), m.capacity, m.active_sh_degree)
    out, prof = os.path.join(work, "resumed"), os.path.join(work, "profile")
    argv = ["train", "-s", scene, "-m", out, "--eval", "--iterations", "60",
            "--shift_cam_start", "20", "--densify_from_iter", "20",
            "--densification_interval", "20", "--densify_grad_threshold", "1e-6",
            "--test_iterations", "0", "--save_iterations", "60",
            "--start_checkpoint", ckpt, "--profile_dir", prof]
    text = io.StringIO()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    with TrainerProbe(torch) as probe, contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    t_train = time.perf_counter() - t0
    counts = launch_counts()
    check(rc == 0, f"resumed cli train failed:\n{text.getvalue()[-2000:]}")
    with open(os.path.join(out, "train_log.json")) as f:
        train_log = json.load(f)
    steps = 30
    cam0 = probe.trainer.scene.train_views[0].camera
    expected = collections.Counter(
        blend_forward=2 * steps, blend_backward=2 * steps, warp_forward=steps,
        warp_backward=steps, project_forward=2 * steps, project_backward=2 * steps,
        ssim_forward=steps, ssim_backward=steps,
        **render_launches(2 * steps, 2 * steps, cam0.width, cam0.height))
    resumed = f"Resumed from {ckpt} at iteration 30" in text.getvalue()
    grown = [line for line in text.getvalue().splitlines() if "pair capacity grown" in line]
    ppg = probe.trainer.raster.pairs_per_gaussian
    with open(os.path.join(prof, "trace.json")) as f:  # ~5 MB of events per step
        trace = f.read()
    symbols = {k: k in trace for k in (
        "blend_forward_kernel", "blend_backward_kernel", "warp_forward_kernel",
        "warp_backward_kernel", "project_forward_kernel", "project_backward_kernel",
        "ssim_forward_kernel", "ssim_backward_kernel")}
    trace_mib = os.path.getsize(os.path.join(prof, "trace.json")) / 2**20
    # the state the resumed trainer steps from, against the checkpoint
    unequal = differing_buffers(state_tensors(ckpt_state), probe.start_buffers)
    meta = state_meta(ckpt_state)
    restored = not unequal and probe.start_meta == meta and meta[0] == 30
    last = train_log[-1]
    log(f"[11 resume] printed the resume at 30: {resumed}; at the first step (points, capacity, "
        f"SH degree) {probe.at_start} against the checkpoint's {want}; every buffer and "
        f"(adam_step, SH degrees, spatial_lr_scale) {probe.start_meta} equal to chkpnt30.npz's "
        f"{meta} bit for bit: {restored} (buffers differing: {unequal}); {len(train_log)} log "
        f"entries, last iteration {last['iteration']} loss {last['loss']:.6f}, points per logged "
        f"iteration {[e['points'] for e in train_log]}; launches {counts} (expected {expected}); "
        f"{t_train:.2f} s for 30 steps under the profiler (host clock, scene load and trace "
        f"export included), {[round(e['iters_per_sec'], 2) for e in train_log]} it/s; trace "
        f"{trace_mib:.1f} MiB names {symbols}; pair capacity: {grown}, pairs_per_gaussian "
        f"{ppg} (phase 10: {pairs_per_gaussian})")
    check(resumed, "cli train did not print the resume at iteration 30")
    check(probe.at_start == want, f"resumed at {probe.at_start}, checkpoint {want}")
    check(restored, f"the resumed state differs from chkpnt30.npz in {unequal} or "
          f"{probe.start_meta} against {meta}")
    check(last["iteration"] == 60 and np.isfinite(last["loss"]), f"resume ended at {last}")
    check(counts == expected, f"resumed launches {counts}, expected {expected}")
    check(all(symbols.values()), f"the trace misses kernels: {symbols}")
    # the pair capacity restarts from the flag: if phase 10's grew, the
    # resumed run's grows at the end of its first span, where the trainer
    # first reads the pair pressure (later growth depends on the replayed
    # draws)
    cfg = load_config(os.path.join(out, "cfg_args.json"))
    first_end = 30 + probe.trainer._fused_span(31, 60, cfg.train.shift_cam_start + 1)
    check(pairs_per_gaussian == cfg.raster.pairs_per_gaussian
          or (grown and f"[ITER {first_end}]" in grown[0]),
          f"pair capacity after the resume {ppg} ({grown}), phase 10 {pairs_per_gaussian}, "
          f"first span's end {first_end}")
    return dict(train_s=t_train, at_start=probe.at_start, checkpoint=want,
                restored_bit_exact=restored, launches=counts,
                pairs_per_gaussian=ppg, pair_growth=grown,
                iters_per_sec=[e["iters_per_sec"] for e in train_log], loss=last["loss"],
                trace_mib=trace_mib, trace_kernels=symbols)


def phase_spiral(torch, trained, n_frames=8):
    """cli spiral of the phase-10 model; render_tiled wrapped to read each
    frame's alpha share and render time."""
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.ops import rasterize

    original = rasterize.render_tiled
    frames = []

    def render_tiled(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = original(*a, **k)
        e.record()
        frames.append((out, s, e))
        return out

    launch_counts(reset=True)
    rasterize.render_tiled = render_tiled
    try:
        t0 = time.perf_counter()
        rc = cli.main(["spiral", "-m", trained, "--n_frames", str(n_frames), "--no_video"])
        t_spiral = time.perf_counter() - t0
    finally:
        rasterize.render_tiled = original
    counts = launch_counts()
    launches = counts["blend_forward"]
    check(rc == 0, "cli spiral failed")
    d = os.path.join(trained, "spiral", "ours_60")
    pngs = sorted(os.listdir(d)) if os.path.isdir(d) else []
    alpha = [float(o.alpha.mean()) for o, _, _ in frames]
    render_ms = [s.elapsed_time(e) for _, s, e in frames]
    shape = tuple(frames[0][0].image.shape) if frames else None
    log(f"[12 spiral] {len(pngs)} PNGs, blend_forward launches {launches}, frames {shape}, "
        f"alpha share per frame {[round(a, 4) for a in alpha]}; {t_spiral / n_frames * 1e3:.1f} "
        f"ms per frame with the depth colouring and 3 PNG writes (host clock), render "
        f"{float(np.median(render_ms)):.4f} ms median (CUDA events)")
    check(len(pngs) == 3 * n_frames, f"spiral wrote {len(pngs)} PNGs")
    check(launches == n_frames, f"spiral launched blend_forward {launches} times")
    check(counts["project_forward"] == n_frames and counts["project_backward"] == 0,
          f"spiral launched the vertex stage's kernels {counts}")
    check(shape == (3, H, W), f"spiral frames are {shape}")
    check(min(alpha) > 0, f"a spiral frame renders nothing: {alpha}")
    return dict(pngs=len(pngs), launches=launches, alpha_share=alpha,
                ms_per_frame=t_spiral / n_frames * 1e3, render_ms=render_ms)


def phase_lpips(torch, seed, work, model_dir):
    """cli metrics --lpips_weights on phase 6's renders, against the same
    LPIPS on the CPU."""
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.eval.lpips import make_lpips, random_lpips_weights
    from binocular3dgs_torch.eval.metrics import _load_image

    weights = random_lpips_weights("vgg", seed)
    path = os.path.join(work, "lpips_vgg.npz")
    np.savez(path, **weights)
    t0 = time.perf_counter()
    check(cli.main(["metrics", "-m", model_dir, "--lpips_weights", path]) == 0,
          "cli metrics --lpips_weights failed")
    t_metrics = time.perf_counter() - t0
    with open(os.path.join(model_dir, "per_view.json")) as f:
        card = json.load(f)["ours_1"]["LPIPS"]
    d = os.path.join(model_dir, "test", "ours_1")
    cpu_fn, card_fn = make_lpips(weights, device="cpu"), make_lpips(weights, device="cuda")
    rel, cpu, pair = {}, {}, None
    for name, got in sorted(card.items()):
        pair = [torch.from_numpy(_load_image(os.path.join(d, sub, name)))
                for sub in ("renders", "gt")]
        cpu[name] = float(cpu_fn(*pair))
        rel[name] = abs(got - cpu[name]) / abs(cpu[name])
    img = [x.cuda() for x in pair]
    ms = median_ms(torch, lambda: card_fn(*img), warmup=2, iters=5)
    log(f"[13 lpips] card LPIPS {card}, CPU {cpu}; relative difference {rel} (tol 1e-4); "
        f"{ms:.3f} ms per {W}x{H} image pair (CUDA events, median of 5); cli metrics "
        f"{t_metrics:.2f} s (host clock)")
    check(len(card) == 2, f"LPIPS for {len(card)} test views")
    check(all(np.isfinite(v) and v > 0 for v in card.values()), f"LPIPS values {card}")
    check(max(rel.values()) <= 1e-4, f"card LPIPS differs from the CPU's by {rel}")
    return dict(lpips=card, lpips_cpu=cpu, rel_cpu=rel, ms_per_image=ms, metrics_s=t_metrics)


def phase_viewer(torch, model, cam, device):
    """One 1008x756 viewer request over loopback, served by serve_step with
    a render_tiled callback, against a direct render's uint8 image."""
    import socket
    import threading

    from binocular3dgs_torch.ops.rasterize import render_tiled
    from binocular3dgs_torch.render.network_gui import NetworkGUI, viewer_camera

    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        direct = render_tiled(cam, model, bg, device=device).image
    want = (np.clip(direct.permute(1, 2, 0).cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    view, proj = cam.world_view.cpu().numpy().copy(), cam.full_proj.cpu().numpy().copy()
    for m in (view, proj):  # a SIBR client's OpenGL axes
        m[:, 1:3] *= -1
    msg = json.dumps({
        "resolution_x": W, "resolution_y": H, "train": True, "fov_y": FOVY, "fov_x": FOVX,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0, "view_matrix": view.ravel().tolist(),
        "view_projection_matrix": proj.ravel().tolist()}).encode()
    received = {}

    def client():
        with socket.create_connection(("127.0.0.1", gui.port), timeout=60) as c:
            c.sendall(len(msg).to_bytes(4, "little") + msg)
            buf = b""
            while len(buf) < W * H * 3 + 4:
                chunk = c.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
            n = int.from_bytes(buf[W * H * 3:W * H * 3 + 4], "little")
            while len(buf) < W * H * 3 + 4 + n:
                buf += c.recv(n)
            received["img"], received["verify"] = buf[:W * H * 3], buf[W * H * 3 + 4:].decode()

    @torch.no_grad()
    def render_fn(req):
        out = render_tiled(viewer_camera(req, device), model, bg, device=device)
        return out.image.permute(1, 2, 0)

    gui = NetworkGUI(port=0)
    t = threading.Thread(target=client)
    launch_counts(reset=True)
    try:
        t.start()
        for _ in range(1000):
            if gui.try_connect():
                break
            time.sleep(0.01)
        t0 = time.perf_counter()
        gui.serve_step(render_fn, verify="chip_smoke", training_done=False)
        t_serve = time.perf_counter() - t0
        t.join(timeout=60)
    finally:
        gui.close()
    counts = launch_counts()
    launches = counts["blend_forward"]
    equal = received.get("img") == want.tobytes()
    log(f"[14 viewer] served {len(received.get('img', b''))} bytes in {t_serve * 1e3:.1f} ms "
        f"(host clock: request parse, render, copy to the host, send), blend_forward launches "
        f"{launches}; equal to the direct render's uint8 image: {equal}; verify "
        f"{received.get('verify')!r}")
    check(not t.is_alive() and received.get("verify") == "chip_smoke", "viewer client failed")
    check(equal, "the served image differs from the direct render")
    check(launches == 1, f"serve_step launched blend_forward {launches} times")
    check(counts["project_forward"] == 1, f"serve_step launched project_forward {counts}")
    return dict(serve_ms=t_serve * 1e3, launches=launches, bytes_equal=equal)


def phase_determinism(torch, device, seed, scene, work, trained):
    """The card's training repeats bit for bit: the phase-9 binocular step
    from one state and the same shifts, once and 10 times, run twice each
    (parameters, both Adam moments, the densification statistics and the
    loss compared as int32 views), and phase 10's `cli train` run again
    into another directory: its chkpnt60.npz and its logged losses equal
    the first run's."""
    from binocular3dgs_torch import cli

    def steps(n):
        step, state, cam, gt, aw, bg, cfg = train_setup(torch, seed, device)
        gen = torch.Generator().manual_seed(seed)
        losses = []
        for i in range(n):
            trans = draw_trans(torch, gen, cfg.train.cam_trans_dist)
            state, m = step(state, cam, gt, aw, 2 + i, trans, bg)
            losses.append(int((m.loss + m.disparity_loss).view(torch.int32)))
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in state_tensors(state).items()}, losses

    res = {}
    for n in (1, TRAIN_STEPS):
        (a, la), (b, lb) = steps(n), steps(n)
        unequal = differing_buffers(a, b)
        res[f"steps_{n}"] = dict(buffers_differing=unequal, losses_equal=la == lb)
        log(f"[15 determinism] {n} binocular step(s) of the phase-9 workload, run twice from "
            f"one state: buffers differing {unequal}, losses equal {la == lb}")
        check(not unequal and la == lb, f"{n} training steps differ between runs: {unequal}")

    again = os.path.join(work, "trained_again")
    argv = ["train", "-s", scene, "-m", again, "--eval", "--iterations", "60",
            "--shift_cam_start", "20", "--densify_from_iter", "20",
            "--densification_interval", "20", "--densify_grad_threshold", "1e-6",
            "--test_iterations", "60", "--save_iterations", "60",
            "--checkpoint_iterations", "60", "-q", "--device", device.type]
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "the second cli train failed")
    t_again = time.perf_counter() - t0
    first = np.load(os.path.join(trained, "chkpnt60.npz"))
    second = np.load(os.path.join(again, "chkpnt60.npz"))
    keys_differing = sorted(
        k for k in set(first.files) | set(second.files)
        if k not in first.files or k not in second.files or first[k].dtype != second[k].dtype
        or first[k].shape != second[k].shape or first[k].tobytes() != second[k].tobytes())
    logs = []
    for d in (trained, again):
        with open(os.path.join(d, "train_log.json")) as f:
            logs.append([(e["iteration"], e["loss"], e["disparity_loss"], e["points"])
                         for e in json.load(f)])
    log(f"[15 determinism] cli train run again ({t_again:.2f} s): chkpnt60.npz arrays "
        f"differing {keys_differing} of {len(first.files)}; logged (iteration, loss, "
        f"disparity loss, points) equal {logs[0] == logs[1]}")
    check(not keys_differing and logs[0] == logs[1],
          f"two cli train runs differ: {keys_differing}")
    res["cli_train"] = dict(arrays=len(first.files), arrays_differing=keys_differing,
                            log_equal=logs[0] == logs[1], train_s=t_again)
    return res


# dense init (phase 16): LLFF's image size and protocol (orchestrate.PROTOCOLS["LLFF"])
LLFF_W, LLFF_H, LLFF_VIEWS = 4032, 3024, 9
INIT_GAUSSIANS = 200_000
INIT_ARC = 0.05  # rad either side of the optical axis


def init_gaussians(seed, n=INIT_GAUSSIANS):
    """A seeded, textured slab of opaque gaussians filling the arc cameras'
    view at depths 4-9: the scene the dense init's views are rendered from."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-4.5, 4.5, n), rng.uniform(-3.4, 3.4, n),
                    rng.uniform(4, 9, n)], 1)
    return dict(
        xyz=xyz.astype(np.float32),
        f_dc=(rng.normal(size=(n, 1, 3)) * 1.2).astype(np.float32),
        f_rest=np.zeros((n, 3, 3), np.float32),
        opacity=np.full((n, 1), 2.2, np.float32),
        scaling=np.log(rng.uniform(0.008, 0.03, (n, 3))).astype(np.float32),
        rotation=np.concatenate([np.ones((n, 1)), np.zeros((n, 3))], 1).astype(np.float32),
    ), xyz


def write_rendered_scene(torch, device, root, params, xyz, width, height, seed,
                         n_sparse=5000):
    """9 JPEG views at width x height rendered by the port from `params`
    on the arc cameras, and a COLMAP model (PINHOLE, the arc poses, a
    sparse cloud of `n_sparse` of the gaussians' centres)."""
    from PIL import Image

    from binocular3dgs_torch.config import RasterConfig
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.core.transforms import fov2focal
    from binocular3dgs_torch.data import colmap
    from binocular3dgs_torch.models.gaussians import from_numpy
    from binocular3dgs_torch.ops.rasterize import render_tiled

    os.makedirs(f"{root}/sparse/0", exist_ok=True)
    os.makedirs(f"{root}/images", exist_ok=True)
    n = len(xyz)
    model = from_numpy(params, np.ones(n, bool), 1, 0, device=device)
    fx, fy = fov2focal(FOVX, width), fov2focal(FOVY, height)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                   np.array([fx, fy, width / 2, height / 2]))}
    images, ppg, render_ms = {}, 16, []
    for i, (R, T) in enumerate(arc_poses(LLFF_VIEWS, INIT_ARC), start=1):
        cam = make_camera(R, T, FOVX, FOVY, width, height, device=device)
        while True:
            with torch.no_grad():
                out, ms = timed_once(torch, lambda: render_tiled(
                    cam, model, [0.5, 0.5, 0.5], raster=RasterConfig(pairs_per_gaussian=ppg),
                    device=device))
            if int(out.num_pairs) <= out.pair_capacity:
                break
            ppg *= 2
        render_ms.append(ms)
        rgb = (out.image.clamp(0, 1).permute(1, 2, 0) * 255).round().to(torch.uint8)
        Image.fromarray(rgb.cpu().numpy()).save(f"{root}/images/im_{i:02d}.jpg", quality=95)
        images[i] = colmap.ColmapImage(i, colmap.rotmat2qvec(R.T), T, 1, f"im_{i:02d}.jpg",
                                       np.zeros((0, 2)), np.zeros(0, dtype=np.int64))
    rng = np.random.default_rng(seed)
    pick = rng.choice(n, n_sparse, replace=False)
    colmap.write_cameras_binary(f"{root}/sparse/0/cameras.bin", cams)
    colmap.write_images_binary(f"{root}/sparse/0/images.bin", images)
    colmap.write_points3d_binary(f"{root}/sparse/0/points3D.bin", xyz[pick],
                                 rng.integers(0, 255, (n_sparse, 3)), np.zeros((n_sparse, 1)))
    return dict(render_ms=render_ms, pairs_per_gaussian=ppg)


class InitProbe:
    """Wraps the dense init's stages while a triangulate runs: host time of
    the scene load (with the resize), of `triangulate_pairs` and of each
    matcher call (and its number of matches), CUDA-event time of each
    Farneback flow and each PDCNet+ network pass, the DLT's inputs and
    outputs, the growth's time, iterations and point counts, and the
    devices the flows, the network, the RANSAC and the scorer ran on."""

    def __init__(self, torch):
        from binocular3dgs_torch.init import geometry, matchers, pipeline
        from binocular3dgs_torch.init.pdcnet import inference

        self.torch, self.mods = torch, (geometry, matchers, pipeline, inference)
        self.t = dict(load_s=[], pairs_s=[], match_s=[], growth_s=[])
        self.flow_ms, self.dlt, self.growth, self.devices = [], [], [], set()
        self.net_ms, self.matches = [], []
        self.scene = None

    def _host(self, key, fn):
        def wrapped(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.t[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    def _events(self, store, tag, fn):
        """fn timed by CUDA events into `store`, its first output's device
        recorded under `tag`."""
        torch, probe = self.torch, self

        def wrapped(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            store.append((s, e))
            probe.devices.add((tag, (out[0] if isinstance(out, tuple) else out).device.type))
            return out
        return wrapped

    def __enter__(self):
        geometry, matchers, pipeline, inference = self.mods
        torch, probe = self.torch, self
        self.saved = [(geometry, "triangulate_points_dlt"),
                      (matchers, "calc_optical_flow_farneback"),
                      (matchers.FarnebackMatcher, "get_matches_and_confidence"),
                      (matchers.PDCNetPlusMatcher, "get_matches_and_confidence"),
                      (inference.PDCNetPlus, "_forward"), (inference, "find_homography_ransac"),
                      (pipeline, "load_scene_for_init"), (pipeline, "triangulate_pairs"),
                      (pipeline, "grow_points_llff"), (pipeline, "_make_candidate_scorer")]
        self.saved = [(o, n, getattr(o, n)) for o, n in self.saved]
        orig = {n: f for _, n, f in self.saved}

        def dlt(P0, P1, uv0, uv1):
            pts = orig["triangulate_points_dlt"](P0, P1, uv0, uv1)
            probe.dlt.append((P0, P1, uv0, uv1, pts))
            return pts

        def matched(name):
            def run(*a, **k):
                out = orig[name](*a, **k)
                probe.matches.append(len(out["kp_source"]))
                return out
            return probe._host("match_s", run)

        def ransac(src, dst, *a, **k):
            probe.devices.add(("ransac", torch.as_tensor(src).device.type))
            return orig["find_homography_ransac"](src, dst, *a, **k)

        def grow(points, colors, images, K, c2ws, train_indices, cfg, *a, **k):
            out = probe._host("growth_s", orig["grow_points_llff"])(
                points, colors, images, K, c2ws, train_indices, cfg, *a, **k)
            probe.growth.append((np.array(points), len(out[0]), cfg.growth_iterations))
            return out

        def load(*a, **k):
            probe.scene = probe._host("load_s", orig["load_scene_for_init"])(*a, **k)
            return probe.scene

        def scorer(h):
            score = orig["_make_candidate_scorer"](h)

            def run(cand, *a):
                probe.devices.add(("scorer", cand.device.type))
                return score(cand, *a)
            return run

        geometry.triangulate_points_dlt = dlt
        matchers.calc_optical_flow_farneback = self._events(
            self.flow_ms, "flow", orig["calc_optical_flow_farneback"])
        inference.PDCNetPlus._forward = self._events(self.net_ms, "network", orig["_forward"])
        inference.find_homography_ransac = ransac
        for cls, (o, n, f) in ((matchers.FarnebackMatcher, self.saved[2]),
                               (matchers.PDCNetPlusMatcher, self.saved[3])):
            orig[cls.__name__] = f
            setattr(cls, n, matched(cls.__name__))
        pipeline.load_scene_for_init = load
        pipeline.triangulate_pairs = self._host("pairs_s", orig["triangulate_pairs"])
        pipeline.grow_points_llff = grow
        pipeline._make_candidate_scorer = scorer
        return self

    def __exit__(self, *exc):
        for o, n, f in self.saved:
            setattr(o, n, f)


def reprojection_errors(dlt_calls, thresh, W, H):
    """As `triangulate_pairs` filters each DLT call's points: the
    reference-view reprojection errors of the points it keeps (both views'
    errors under `thresh`, both projections inside the image), and the share
    of the DLT's points kept."""
    kept_err, n_all = [], 0
    for P0, P1, uv0, uv1, pts in dlt_calls:
        errs, inside = [], []
        for P, uv in ((P0, uv0), (P1, uv1)):
            pi = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ P.T
            proj = pi[:, :2] / pi[:, 2:3]
            errs.append(np.linalg.norm(proj - uv, axis=-1))
            inside.append((proj[:, 0] >= 0) & (proj[:, 0] <= W - 1) & (proj[:, 1] >= 0)
                          & (proj[:, 1] <= H - 1))
        keep = (errs[0] < thresh) & (errs[1] < thresh) & inside[0] & inside[1]
        kept_err.append(errs[0][keep])
        n_all += len(pts)
    kept = np.concatenate(kept_err) if kept_err else np.zeros(0)
    return kept, len(kept) / max(n_all, 1)


def growth_busy(torch, device, points, colors, images, K, c2ws, train_idx, iterations=100):
    """Kernel ms per growth iteration from torch.profiler over `iterations`
    iterations from the pre-growth cloud, and the profiled wall ms per
    iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from binocular3dgs_torch.init.pipeline import TriangulateConfig, grow_points_llff

    cfg = TriangulateConfig(growth_iterations=iterations)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grow_points_llff(points, colors, images, K, c2ws, train_idx, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return kernel_us / 1e3 / iterations, wall * 1e3 / iterations


def phase_dense_init(torch, device, seed, work):
    """`cli triangulate --resolution 2` of a 9-view 4032x3024 JPEG scene
    rendered by the port (LLFF's image size; its protocol's resolution, 3
    train views, 6 ordered pairs, 12 flows at 504x378, 1000 growth
    iterations of 100 x 200 candidates), then `run_scene` with the LLFF
    protocol cut to 60 iterations: triangulate, train at -r 2, render and
    metrics, each a `binocular3dgs_torch.cli` process on the card."""
    import dataclasses

    from binocular3dgs_torch import cli, orchestrate
    from binocular3dgs_torch.data.ply import fetch_point_cloud
    from binocular3dgs_torch.init.pipeline import TriangulateConfig

    params, xyz = init_gaussians(seed)
    data = os.path.join(work, "llff")
    scene = os.path.join(data, "slab")
    t0 = time.perf_counter()
    made = write_rendered_scene(torch, device, scene, params, xyz, LLFF_W, LLFF_H, seed)
    t_scene = time.perf_counter() - t0
    log(f"[16 dense init] scene: {LLFF_VIEWS} views {LLFF_W}x{LLFF_H} JPEG of "
        f"{INIT_GAUSSIANS} gaussians in {t_scene:.1f} s (render "
        f"{float(np.median(made['render_ms'])):.1f} ms a view, pairs_per_gaussian "
        f"{made['pairs_per_gaussian']})")

    out = os.path.join(work, "kp")
    launch_counts(reset=True)
    with InitProbe(torch) as probe:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["triangulate", "-s", scene, "--output_path", out, "--resolution", "2",
                       "--device", device.type])
        torch.cuda.synchronize()
        t_tri = time.perf_counter() - t0
    counts = launch_counts()
    check(rc == 0, "cli triangulate failed")
    cfg = TriangulateConfig()
    ply = fetch_point_cloud(os.path.join(out, "slab_keypoints_to_3d.ply"))
    flow_ms = [s.elapsed_time(e) for s, e in probe.flow_ms]
    (pre, n_after, iters), = probe.growth
    kept_err, kept_share = reprojection_errors(probe.dlt, cfg.reproj_thresh, LLFF_W // 2,
                                               LLFF_H // 2)
    t = {k: sum(v) for k, v in probe.t.items()}
    dlt_filters_s = t["pairs_s"] - t["match_s"]
    growth_ms = t["growth_s"] * 1e3 / iters

    # the card's busy share over the growth: kernel time per iteration from
    # the profiler over 100 iterations from the same pre-growth cloud
    from binocular3dgs_torch.init.pipeline import select_train_indices

    images, K, c2ws, _ = probe.scene
    train_idx = select_train_indices(len(images), "LLFF", 3)
    pre_colors = np.full((len(pre), 3), 128, np.uint8)
    kernel_ms, prof_ms = growth_busy(torch, device, pre, pre_colors, images, K, c2ws,
                                     train_idx)
    med_err = float(np.median(kept_err)) if len(kept_err) else float("inf")
    res = dict(
        triangulate_s=t_tri, load_resize_s=t["load_s"], match_s=t["match_s"],
        farneback_ms=flow_ms, flows=len(flow_ms), dlt_filters_s=dlt_filters_s,
        growth_s=t["growth_s"], growth_iterations=iters, growth_ms_per_iteration=growth_ms,
        growth_kernel_ms_per_iteration=kernel_ms, growth_profiled_ms_per_iteration=prof_ms,
        growth_busy_share=kernel_ms / growth_ms, points_before_growth=len(pre),
        points_after_growth=n_after, ply_points=len(ply.points),
        reprojection_median_px=med_err, dlt_kept_share=kept_share,
        devices=sorted(probe.devices), launches=counts, scene_s=t_scene, **made)
    log(f"[16 dense init] cli triangulate --resolution 2: {t_tri:.2f} s (host clock); load and "
        f"resize {t['load_s']:.2f} s; {len(flow_ms)} Farneback flows at {LLFF_W // 8}x{LLFF_H // 8}, "
        f"{float(np.median(flow_ms)):.2f} ms median ({min(flow_ms):.2f}-{max(flow_ms):.2f}, CUDA "
        f"events); matching {t['match_s']:.2f} s; DLT and filters {dlt_filters_s:.2f} s; growth "
        f"{iters} iterations {t['growth_s']:.2f} s, {growth_ms:.3f} ms an iteration, kernels "
        f"{kernel_ms:.3f} ms an iteration (profiler, {prof_ms:.3f} ms profiled), busy share "
        f"{kernel_ms / growth_ms:.3f}; points {len(pre)} -> {n_after} ({len(ply.points)} in the "
        f"PLY); median reference-view reprojection error of the pre-growth points {med_err:.4f} "
        f"px ({kept_share:.3f} of the DLT points kept); devices {sorted(probe.devices)}; "
        f"kernel launches {counts}")
    check(len(flow_ms) == 12, f"{len(flow_ms)} flows, expected 12 (6 ordered pairs, both ways)")
    check(len(ply.points) > 0, "the dense PLY has no points")
    check(n_after > len(pre) and len(ply.points) == n_after, f"growth {len(pre)} -> {n_after}")
    check(med_err < cfg.reproj_thresh, f"median reprojection error {med_err} px")
    check(probe.devices == {("flow", device.type), ("scorer", device.type)},
          f"dense init ran on {probe.devices}")

    # run_scene: the LLFF protocol cut to 60 iterations, with the working
    # directory and out_path such that train finds the dense PLY where
    # triangulate writes it (orchestrate.py's docstring)
    proto = dataclasses.replace(orchestrate.PROTOCOLS["LLFF"], scenes=["slab"], iterations=60)
    calls = []
    original_cli = orchestrate._cli

    def recorded(args, env=None):
        calls.append([str(a) for a in args])
        return original_cli(args, env)

    cwd = os.getcwd()
    pythonpath = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + pythonpath if pythonpath else "")
    orchestrate._cli = recorded
    os.chdir(data)
    try:
        t0 = time.perf_counter()
        ok = orchestrate.run_scene("slab", data, ".", proto, device=device.type)
        t_run = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        orchestrate._cli = original_cli
        if pythonpath is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = pythonpath
    dense = os.path.join(data, "keypoints_to_3d", "LLFF", "slab_keypoints_to_3d.ply")
    model = os.path.join(data, "slab_3views")
    with open(dense, "rb") as f, open(os.path.join(model, "input.ply"), "rb") as g:
        loaded_dense = f.read() == g.read()
    with open(os.path.join(model, "results.json")) as f:
        metrics = json.load(f)["ours_60"]
    stages = [c[0] for c in calls]
    on_card = all(c[c.index("--device") + 1] == device.type for c in calls)
    res["run_scene"] = dict(ok=ok, wall_s=t_run, stages=stages, train_loaded_dense_ply=loaded_dense,
                            dense_points=len(fetch_point_cloud(dense).points), metrics=metrics,
                            device_cuda=on_card)
    log(f"[16 dense init] run_scene (LLFF protocol, 60 iterations) {t_run:.1f} s (host clock, 4 "
        f"processes): ok {ok}, stages {stages}, train loaded the dense PLY "
        f"({res['run_scene']['dense_points']} points) {loaded_dense}, --device {device.type} in "
        f"every stage {on_card}; metrics {metrics}")
    check(ok and stages == ["triangulate", "train", "render", "metrics"], f"run_scene {stages}")
    check(loaded_dense, "train did not load the dense PLY run_scene wrote")
    check(on_card, f"a stage ran without --device cuda: {calls}")
    check(np.isfinite(metrics["PSNR"]) and np.isfinite(metrics["SSIM"]), f"metrics {metrics}")
    return res, params, xyz


def nearest_share(torch, device, a, b, tol):
    """Share of the points of `a` (N, 3) with a point of `b` within `tol`."""
    A = torch.as_tensor(a, device=device)
    B = torch.as_tensor(b, device=device)
    near = [torch.cdist(A[i:i + 4096], B).amin(1) <= tol for i in range(0, len(A), 4096)]
    return float(torch.cat(near).double().mean())


def phase_init_card_vs_cpu(torch, device, seed, work, params, xyz):
    """The dense init on the card against the CPU, on a 4x smaller copy of
    phase 16's scene (1008x756; matching at 126x94): the Farneback flows of
    the 6 ordered pairs, the pre-growth point sets, and the scores of the
    first growth iterations from the card's pre-growth cloud."""
    from binocular3dgs_torch.init import pipeline
    from binocular3dgs_torch.init.farneback import calc_optical_flow_farneback
    from binocular3dgs_torch.init.matchers import FarnebackMatcher

    scene = os.path.join(work, "llff_small", "slab")
    write_rendered_scene(torch, device, scene, params, xyz, LLFF_W // 4, LLFF_H // 4, seed)
    cfg = pipeline.TriangulateConfig(growth_iterations=0)
    devices = {"card": device, "cpu": torch.device("cpu")}
    loaded = {k: pipeline.load_scene_for_init(scene, "images", 2, d) for k, d in devices.items()}
    images = loaded["card"][0]
    same_images = all(np.array_equal(a, b) for a, b in zip(images, loaded["cpu"][0]))
    _, K, c2ws, _ = loaded["card"]
    idx = pipeline.select_train_indices(len(images), "LLFF", 3)
    matchers = {k: FarnebackMatcher(device=d) for k, d in devices.items()}
    size = (images[0].shape[1] // 4, images[0].shape[0] // 4)
    epe = []
    for r in idx:
        for s in idx:
            if r == s:
                continue
            flows = []
            for d, m in matchers.items():
                a, b = m._gray(images[r], size), m._gray(images[s], size)
                flows.append(calc_optical_flow_farneback(a, b).cpu())
            epe.append((flows[0] - flows[1]).norm(dim=-1).flatten())
    epe = torch.cat(epe)
    epe_med, epe_p99, epe_max = (float(epe.median()), float(torch.quantile(epe, 0.99)),
                                 float(epe.max()))
    pts = {k: pipeline.triangulate_pairs(images, K, c2ws, idx, m, cfg)[0]
           for k, m in matchers.items()}
    tol = 1e-3
    share = min(nearest_share(torch, device, pts["card"], pts["cpu"], tol),
                nearest_share(torch, device, pts["cpu"], pts["card"], tol))

    # growth scores: the same candidates scored on both devices
    scores = {}
    original = pipeline._make_candidate_scorer
    for k, d in devices.items():
        rec = scores[k] = []

        def make(h, rec=rec):
            score = original(h)

            def run(*a):
                out = score(*a)
                rec.append(out.cpu())
                return out
            return run

        pipeline._make_candidate_scorer = make
        try:
            pipeline.grow_points_llff(pts["card"], np.full((len(pts["card"]), 3), 128, np.uint8),
                                      images, K, c2ws, idx,
                                      pipeline.TriangulateConfig(growth_iterations=5), device=d)
        finally:
            pipeline._make_candidate_scorer = original
    compared, score_err = 0, 0.0
    for a, b in zip(scores["card"], scores["cpu"]):
        score_err = max(score_err, float((a - b).abs().max()))
        compared += 1
        if not torch.equal(a >= 0.95, b >= 0.95):
            break  # a decision at the threshold differs: later candidates differ
    log(f"[17 init card vs CPU] {LLFF_W // 4}x{LLFF_H // 4} scene, resolution 2: images equal "
        f"{same_images}; "
        f"Farneback end-point difference over the 6 ordered pairs at {size[0]}x{size[1]}: median "
        f"{epe_med:.3g}, 99th percentile {epe_p99:.3g}, max {epe_max:.3g} px (tol median 0.01, "
        f"p99 0.1); pre-growth points {len(pts['card'])} (card) / {len(pts['cpu'])} (CPU), share "
        f"with a partner within {tol} {share:.5f} (tol 0.99); growth scores of {compared} "
        f"iterations x {len(scores['card'][0])} candidates within {score_err:.3g} (tol 1e-5)")
    check(same_images, "the card's resized images differ from the CPU's")
    check(epe_med <= 0.01 and epe_p99 <= 0.1, f"card and CPU flows differ: {epe_med}, {epe_p99}")
    check(share >= 0.99 and abs(len(pts["card"]) - len(pts["cpu"])) <= 0.01 * len(pts["cpu"]),
          f"card and CPU point sets differ: {share}")
    check(compared >= 1 and score_err <= 1e-5, f"growth scores differ by {score_err}")
    return dict(images_equal=same_images, flow_epe_median=epe_med, flow_epe_p99=epe_p99,
                flow_epe_max=epe_max, points_card=len(pts["card"]), points_cpu=len(pts["cpu"]),
                point_share_within_tol=share, point_tol=tol, growth_iterations_compared=compared,
                growth_score_max_diff=score_err)


# PDCNet+ (phases 18-19): the matcher of the paper, at LLFF's matching size
PDCNET_STAGES = ("vgg_pyramid", "vgg_pyramid_256", "global_gocor", "local_gocor_L3",
                 "local_gocor_L2", "local_gocor_L1", "decoders", "uncertainty")
PDCNET_REPS = 5
PDCNET_TOL = 1e-3  # card against CPU, of each map's largest value (PERF.md)
RANSAC_TOL_PX = 1e-2  # exact inliers at 2016x1512: corners against the true H


class PDCNetProbe:
    """Stage spans of a PDCNetModel's forward through forward hooks: CUDA
    events around each stage module (summed per stage over the calls) and
    profiler ranges `pdcnet::<stage>`; the local correlation and its
    transpose (gocor.py, model.py) run inside ranges
    `pdcnet::local_correlation[_transpose]`."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.events, self.local_calls, self.handles, self.open = [], 0, [], {}

    def stage(self, name):
        if name.startswith(("vgg", "global")):
            return name
        if name == "local_corr":
            return f"local_gocor_L{3 - self.local_calls % 3}"
        return "uncertainty" if "uncertainty" in name else "decoders"

    def __enter__(self):
        from torch.profiler import record_function

        from binocular3dgs_torch.init.pdcnet import gocor
        from binocular3dgs_torch.init.pdcnet import model as model_mod

        torch, probe = self.torch, self
        names = {"pyramid": "vgg_pyramid", "pyramid_256": "vgg_pyramid_256",
                 "corr": "global_gocor"}
        for name, mod in self.model.named_children():
            label = names.get(name, name)

            def pre(m, args, label=label):
                stage = probe.stage(label)
                s = torch.cuda.Event(enable_timing=True)
                s.record()
                rf = record_function(f"pdcnet::{stage}")
                rf.__enter__()
                probe.open[id(m)] = (stage, s, rf)

            def post(m, args, out, label=label):
                stage, s, rf = probe.open.pop(id(m))
                rf.__exit__(None, None, None)
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                probe.events.append((stage, s, e))
                if label == "local_corr":
                    probe.local_calls += 1

            self.handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

        def ranged(fn, name):
            def run(*a, **k):
                with record_function(f"pdcnet::{name}"):
                    return fn(*a, **k)
            return run

        self.saved = [(gocor, "local_correlation"), (gocor, "local_correlation_transpose"),
                      (model_mod, "local_correlation")]
        self.saved = [(o, n, getattr(o, n)) for o, n in self.saved]
        for o, n, f in self.saved:
            setattr(o, n, ranged(f, n))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for o, n, f in self.saved:
            setattr(o, n, f)

    def spans_ms(self, calls):
        """Per-stage event ms per forward over the last `calls` forwards."""
        self.torch.cuda.synchronize()
        out = {k: 0.0 for k in PDCNET_STAGES}
        for stage, s, e in self.events:
            out[stage] += s.elapsed_time(e) / calls
        self.events = []
        return out


def pdcnet_weights(torch, seed, work):
    """Random PDCNet+ weights from --seed as a `.pth` (torch.save of the
    state_dict) and as the npz both packages read; both must load to equal
    tensors."""
    from binocular3dgs_torch.init.pdcnet import convert
    from binocular3dgs_torch.init.pdcnet.model import random_model

    sd = random_model(seed).state_dict()
    pth, npz = os.path.join(work, "pdcnet_random.pth"), os.path.join(work, "pdcnet_random.npz")
    torch.save(sd, pth)
    convert.save_npz(sd, npz)
    a, b = convert.load_checkpoint(pth), convert.load_checkpoint(npz)
    only_pth = {k for k in set(a) - set(b) if not k.endswith("num_batches_tracked")}
    equal = not only_pth and set(b) <= set(a) and all(torch.equal(a[k], b[k]) for k in b)
    check(equal, f"the .pth and the npz load differently ({sorted(only_pth)[:3]})")
    return pth, npz, dict(tensors=len(b), parameters=int(sum(v.numel() for v in b.values())),
                          pth_and_npz_equal=equal)


def profile_direct(torch, run):
    """One call of `run` under torch.profiler: kernel ms, the wall ms under
    the profiler, the top kernels, and the kernel ms of each `pdcnet::`
    range read off the device timeline: each kernel counts once, for the
    innermost range whose device-side annotation holds its start (so a
    range's time excludes the ranges nested in it). None when the profiler
    records no annotations. (The CPU rows' inclusive device time counted
    some kernels twice in a run where earlier phases had profiled.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ann = [(e.name[len("pdcnet::"):], e.time_range.start, e.time_range.end) for e in device
           if getattr(e, "is_user_annotation", False) and e.name.startswith("pdcnet::")]
    ranges = None
    if ann:
        names = np.array([n for n, _, _ in ann])
        a0, a1 = np.array([a for _, a, _ in ann]), np.array([b for _, _, b in ann])
        k = np.array([(e.time_range.start, e.time_range.end) for e in device
                      if not getattr(e, "is_user_annotation", False)], dtype=np.float64)
        holds = (k[:, :1] >= a0[None]) & (k[:, :1] < a1[None])
        length = np.where(holds, (a1 - a0)[None], np.inf)
        inner, held = length.argmin(1), np.isfinite(length.min(1))
        ranges = {str(n): float((k[:, 1] - k[:, 0])[held & (names[inner] == n)].sum() / 1e3)
                  for n in sorted(set(names))}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(kernel_ms=kernel_ms, profiled_wall_ms=wall_ms, range_kernel_ms=ranges,
                launches=int(sum(e.count for e in kernels)),
                top_kernels_ms=[[e.key[:160], e.count, e.self_device_time_total / 1e3]
                                for e in top])


def vgg_determinism_ms(torch, net, images, reps=3):
    """The image VGG pyramid on `images` (ImageNet-normalized, on the card):
    median CUDA-event ms of `reps` after a warm-up, with cuDNN restricted to
    deterministic algorithms (as `resolve_device` sets it) and with them
    free and its benchmark search on; the flags restored."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    out = {}
    try:
        for name, det in (("deterministic", True), ("free", False)):
            cudnn.deterministic, cudnn.benchmark = det, not det
            with torch.inference_mode():
                out[name] = median_ms(torch, lambda: [net.model.pyramid(x) for x in images],
                                      warmup=1, iters=reps)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return out


def phase_pdcnet(torch, device, seed, work):
    """PDCNet+ at LLFF's matching size: random weights as .pth and npz;
    `_direct` on one ordered pair of phase 16's views at 2016x1512 (CUDA
    events, median of 5 after 1 warm-up; stage spans, the profiler's
    kernels, the local correlation's share, busy share, peak memory);
    `get_matches_and_confidence` in mode h with cyclic consistency; then
    `cli triangulate --matcher pdcnet --pdcnet_weights <npz> --resolution 2`
    in-process on phase 16's scene, the network on the card only."""
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.data.ply import fetch_point_cloud
    from binocular3dgs_torch.init import pipeline
    from binocular3dgs_torch.init.pdcnet.inference import PDCNetPlus, _preprocess_shapes
    from binocular3dgs_torch.init.pdcnet.layers import resize_area

    pth, npz, weights = pdcnet_weights(torch, seed, work)
    scene = os.path.join(work, "llff", "slab")
    images, _, _, _ = pipeline.load_scene_for_init(scene, "images", 2, device)
    idx = pipeline.select_train_indices(len(images), "LLFF", 3)
    ref, src = images[idx[0]], images[idx[1]]
    h, w = ref.shape[:2]
    out_hw = (h // 4, w // 4)
    net = PDCNetPlus(npz, device=device)
    check(next(net.model.parameters()).device.type == "cuda", "the network is not on the card")

    def direct():
        return net._direct(src, ref, out_hw)

    with PDCNetProbe(torch, net.model) as probe:
        direct()
        probe.spans_ms(1)
        event_ms, host_ms = [], []
        for _ in range(PDCNET_REPS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.record()
            flow, unc = direct()
            e.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(s.elapsed_time(e))
        spans = probe.spans_ms(PDCNET_REPS)
        torch.cuda.reset_peak_memory_stats()
        direct()
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        prof = profile_direct(torch, direct)
        probe.spans_ms(1)
    ph, pw = _preprocess_shapes(h, w)
    vgg_in = [(resize_area(net._image(im)[None].permute(0, 3, 1, 2), (ph, pw)) / 255.0
               - net._mean) / net._std for im in (src, ref)]
    vgg_ms = vgg_determinism_ms(torch, net, vgg_in)
    direct_ms = float(np.median(event_ms))
    ranges = prof["range_kernel_ms"] or {}
    corr_ms = (sum(ranges.get(k, 0.0) for k in ("local_correlation",
                                                "local_correlation_transpose"))
               if ranges else None)
    p_r = unc["p_r"]
    kernel_ms = prof["kernel_ms"]
    res = dict(weights=weights, image_hw=[h, w], network_hw=list(_preprocess_shapes(h, w)),
               output_hw=list(out_hw), direct_ms=direct_ms, direct_ms_all=event_ms,
               direct_host_ms=float(np.median(host_ms)), stage_span_ms=spans,
               peak_memory_mib=peak_mib, **prof, local_correlation_kernel_ms=corr_ms,
               local_correlation_share=corr_ms / kernel_ms if corr_ms is not None else None,
               busy_share_unprofiled=prof["kernel_ms"] / direct_ms,
               busy_share_profiled=prof["kernel_ms"] / prof["profiled_wall_ms"],
               vgg_pyramid_ms_cudnn=vgg_ms,
               p_r_mean=float(p_r.mean()), p_r_above_0_1=float((p_r >= 0.1).float().mean()))
    log(f"[18 pdcnet] random weights ({weights['tensors']} tensors, {weights['parameters']} "
        f"parameters) as .pth and npz load equal; _direct at {w}x{h} (network "
        f"{res['network_hw'][1]}x{res['network_hw'][0]}, out "
        f"{out_hw[1]}x{out_hw[0]}): {direct_ms:.1f} ms median of {PDCNET_REPS} (CUDA events; "
        f"{min(event_ms):.1f}-{max(event_ms):.1f}; host {res['direct_host_ms']:.1f}); stage "
        "spans " + ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
        + f" ms; kernels {kernel_ms:.1f} ms in {prof['launches']} launches (profiler, "
        f"{prof['profiled_wall_ms']:.1f} ms wall under it), busy share "
        f"{res['busy_share_unprofiled']:.3f} unprofiled / {res['busy_share_profiled']:.3f} "
        f"profiled; local correlation and transpose {corr_ms} ms of kernels, share "
        f"{res['local_correlation_share']}; kernel ms per range (innermost, device timeline) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranges.items())
        + f" ms; the image VGG pyramid on both images {vgg_ms['deterministic']:.1f} ms with "
        f"cuDNN's deterministic algorithms, {vgg_ms['free']:.1f} ms with its benchmark search"
        + f"; peak memory {peak_mib:.0f} MiB; top kernels "
        + "; ".join(f"{k[:90]} x{n} {v:.2f} ms" for k, n, v in prof["top_kernels_ms"])
        + f"; P_R mean {res['p_r_mean']:.3f}, share >= 0.1 {res['p_r_above_0_1']:.3f}")
    check(torch.isfinite(flow).all() and flow.std() > 0, "the flow is not finite or constant")
    check(all(torch.isfinite(unc[k]).all() for k in ("log_var_map", "weight_map", "p_r")),
          "an uncertainty map is not finite")

    # mode h with cyclic consistency: the matcher's call for one ordered pair
    forwards = []
    original = net._forward
    net._forward = lambda *a: forwards.append(1) or original(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = net.get_matches_and_confidence(ref, src)
    torch.cuda.synchronize()
    t_match = time.perf_counter() - t0
    del net._forward
    res["matches_mode_h"] = dict(s=t_match, network_passes=len(forwards),
                                 matches=len(pred["kp_source"]))
    log(f"[18 pdcnet] get_matches_and_confidence (mode h, cyclic consistency) {t_match:.2f} s "
        f"(host clock), {len(forwards)} network passes, {len(pred['kp_source'])} matches")
    check(len(pred["kp_source"]) > 0, "no matches from the mode-h matcher")

    out = os.path.join(work, "kp_pdcnet")
    with InitProbe(torch) as iprobe:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["triangulate", "-s", scene, "--output_path", out, "--resolution", "2",
                       "--matcher", "pdcnet", "--pdcnet_weights", npz, "--device", device.type])
        torch.cuda.synchronize()
        t_tri = time.perf_counter() - t0
    check(rc == 0, "cli triangulate --matcher pdcnet failed")
    ply = fetch_point_cloud(os.path.join(out, "slab_keypoints_to_3d.ply"))
    t = {k: sum(v) for k, v in iprobe.t.items()}
    net_ms = [s.elapsed_time(e) for s, e in iprobe.net_ms]
    growth = iprobe.growth[0] if iprobe.growth else (np.zeros((0, 3)), 0, 0)
    res["triangulate"] = dict(
        s=t_tri, load_resize_s=t["load_s"], match_s=t["match_s"],
        dlt_filters_s=t["pairs_s"] - t["match_s"], growth_s=t["growth_s"],
        network_passes=len(net_ms),
        network_ms_median=float(np.median(net_ms)) if net_ms else None,
        network_ms_sum=float(sum(net_ms)), matches_per_pair=iprobe.matches,
        dlt_points=int(sum(len(d[4]) for d in iprobe.dlt)), points_before_growth=len(growth[0]),
        ply_points=len(ply.points), devices=sorted(iprobe.devices))
    tri = res["triangulate"]
    log(f"[18 pdcnet] cli triangulate --matcher pdcnet --resolution 2: {t_tri:.2f} s (host "
        f"clock); load and resize {t['load_s']:.2f} s; matching {t['match_s']:.2f} s for "
        f"{len(iprobe.matches)} pairs ({len(net_ms)} network passes, "
        f"{tri['network_ms_sum'] / 1e3:.2f} s of them by CUDA events, median "
        f"{tri['network_ms_median']} ms); matches per pair {iprobe.matches}; DLT and filters "
        f"{tri['dlt_filters_s']:.2f} s ({tri['dlt_points']} DLT points, {len(growth[0])} kept); "
        f"growth {t['growth_s']:.2f} s; {len(ply.points)} points written; devices "
        f"{sorted(iprobe.devices)}")
    check(len(iprobe.matches) == 6 and len(net_ms) >= 12,
          f"{len(iprobe.matches)} matcher calls, {len(net_ms)} network passes")
    check({d for k, d in iprobe.devices if k in ("network", "ransac")} <= {"cuda"}
          and ("network", "cuda") in iprobe.devices, f"PDCNet+ ran on {iprobe.devices}")
    return res, npz


def pdcnet_match_set(seed, n, w, h, outliers=0.4):
    """n matches of a known homography at a w x h image (exact inliers,
    outliers displaced by at least 3 px), float32."""
    rng = np.random.default_rng(seed)
    H = np.array([[1.03, 0.02, 15.0], [-0.015, 0.99, -9.0], [2e-6, -1e-6, 1.0]])
    src = rng.uniform([0, 0], [w, h], (n, 2))
    p = np.c_[src, np.ones(n)] @ H.T
    dst = p[:, :2] / p[:, 2:]
    bad = rng.choice(n, int(outliers * n), replace=False)
    true = dst[bad].copy()
    dst[bad] = rng.uniform([0, 0], [w, h], (len(bad), 2))
    near = np.linalg.norm(dst[bad] - true, axis=1) < 3.0
    dst[bad[near]] += 4.0
    return src.astype(np.float32), dst.astype(np.float32), H


def phase_pdcnet_card_vs_cpu(torch, device, seed, work, npz):
    """PDCNet+ on the card against the CPU with the same weights: mode d
    with cyclic consistency at 256x256 (a crop of phase 16's views); the
    RANSAC homography on a 100,000-match set of a known H at 2016x1512 on
    both (each within RANSAC_TOL_PX of the true H at the corners); the
    perspective warp of a 2016x1512 view on both."""
    from binocular3dgs_torch.init import pipeline
    from binocular3dgs_torch.init.pdcnet.homography import (
        find_homography_ransac,
        warp_perspective,
    )
    from binocular3dgs_torch.init.pdcnet.inference import PDCNetPlus

    scene = os.path.join(work, "llff", "slab")
    images, _, _, _ = pipeline.load_scene_for_init(scene, "images", 2, device)
    idx = pipeline.select_train_indices(len(images), "LLFF", 3)
    h, w = images[0].shape[:2]
    y0, x0 = h // 2 - 128, w // 2 - 128
    ref, src = (images[i][y0:y0 + 256, x0:x0 + 256] for i in idx[:2])
    maps = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        net = PDCNetPlus(npz, {"multi_stage_type": "d"}, device=dev)
        flow, unc = net.estimate_flow_and_confidence_map(src, ref)
        maps[name] = {"flow": flow.cpu(), **{k: unc[k].cpu() for k in (
            "log_var_map", "weight_map", "p_r", "cyclic_consistency_error")}}
    rel = {k: float((maps["card"][k] - v).abs().max() / v.abs().max())
           for k, v in maps["cpu"].items()}

    m_src, m_dst, H_true = pdcnet_match_set(seed, 100_000, w, h)
    corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1.0]])

    def corner_err(H_):
        a, b = corners @ H_.T, corners @ H_true.T
        return float(np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max())

    ransac = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        s_, d_ = torch.from_numpy(m_src).to(dev), torch.from_numpy(m_dst).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H_, inl = find_homography_ransac(s_, d_, 1.0)
        torch.cuda.synchronize()
        ransac[name] = dict(s=time.perf_counter() - t0, corner_err_px=corner_err(H_),
                            inliers=int(inl.sum()), device=inl.device.type)

    img = torch.from_numpy(images[idx[1]]).float()
    img_card = img.to(device)
    want = warp_perspective(img, H_true, (w, h))
    got = warp_perspective(img_card, H_true, (w, h))
    warp_ms = median_ms(torch, lambda: warp_perspective(img_card, H_true, (w, h)),
                        warmup=1, iters=5)
    warp_err = float((got.cpu() - want).abs().max())
    res = dict(map_max_rel_diff=rel, tol=PDCNET_TOL, ransac=ransac, ransac_tol_px=RANSAC_TOL_PX,
               warp_max_abs_diff=warp_err, warp_ms=warp_ms, warp_hw=[h, w])
    log(f"[19 pdcnet card vs CPU] 256x256 mode d with cyclic consistency: max difference over "
        f"each map's largest value " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (tol {PDCNET_TOL}); RANSAC on 100,000 matches at {w}x{h} (40% outliers): "
        + "; ".join(f"{k} {v['s']:.2f} s, corners {v['corner_err_px']:.3g} px from the true H, "
                    f"{v['inliers']} inliers" for k, v in ransac.items())
        + f" (tol {RANSAC_TOL_PX} px); warp_perspective {w}x{h} card {warp_ms:.2f} ms (CUDA "
        f"events), max difference to the CPU {warp_err:.3g} (tol 1e-3)")
    check(all(v <= PDCNET_TOL for v in rel.values()), f"card and CPU maps differ: {rel}")
    check(ransac["card"]["device"] == "cuda", "the RANSAC did not run on the card")
    check(all(v["corner_err_px"] <= RANSAC_TOL_PX for v in ransac.values()),
          f"RANSAC off the true H: {ransac}")
    check(warp_err <= 1e-3, f"warp_perspective card and CPU differ by {warp_err}")
    return res


# the sharded path (phases 20-21): ranks share the one card over gloo, whose
# collectives run on host copies (parallel/sharding.py, "Transport")
SHARDED_RANKS = (2, 3)
SHARDED_TRANSPORT = "gloo"
SHARDED_STEPS = 3  # the shard_adam and determinism runs


def sharded_rank(args):
    """One rank of phase 20 (`chip_smoke.py --sharded_rank R --world N
    --init_method URL --out DIR`): the phase-9 workload through the
    band-sharded render and train step on the card, each gate checked here;
    the rank's results go to DIR/rank<R>.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from binocular3dgs_torch import resolve_device
    from binocular3dgs_torch.ops import cuda_build

    cuda_build.load_library()  # the library phase 2 built
    torch.cuda.set_device(0)
    device = resolve_device("cuda")
    dist.init_process_group(SHARDED_TRANSPORT, init_method=args.init_method,
                            world_size=args.world, rank=args.sharded_rank)
    try:
        res = sharded_rank_checks(torch, device, args.seed)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{args.sharded_rank}.json"), "w") as f:
        json.dump(res, f)


def sharded_rank_checks(torch, device, seed):
    from binocular3dgs_torch.ops.binning import tile_grid
    from binocular3dgs_torch.ops.rasterize import render_tiled
    from binocular3dgs_torch.parallel.sharding import (
        gather_opt_state, make_mesh, make_sharded_render, make_sharded_train_step,
    )

    mesh = make_mesh(device)
    world, rank = mesh.size, mesh.rank
    tag = f"[20 sharded {world}/{rank}]"
    step1, state, cam, gt, aw, bg, cfg = train_setup(torch, seed, device)
    cap = state.model.capacity
    res = dict(rank=rank, world=world, transport=mesh.backend, staged=mesh.staged)

    def fresh_state():
        return train_setup(torch, seed, device)[1]

    def outputs_against(out, ref):
        diff = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
                for k in ("image", "depth", "alpha")}
        same = {k: float((getattr(out, k) == getattr(ref, k)).float().mean())
                for k in ("image", "depth", "alpha")}
        return diff, same, bool(torch.equal(out.radii, ref.radii))

    # the band render of view 0 against the single render; B1 once per rank
    render = make_sharded_render(mesh, W, H, cfg.raster)
    with torch.no_grad():
        torch.cuda.synchronize()
        launch_counts(reset=True)
        out = render(cam, state.model, bg)
        torch.cuda.synchronize()
        launches = launch_counts()
        ref = render_tiled(cam, state.model, bg, raster=cfg.raster, device=device)
    diff, same, radii_equal = outputs_against(out, ref)
    res["render"] = dict(max_abs=diff, equal_share=same, radii_equal=radii_equal,
                         launches=launches, band_pairs_max=int(out.num_pairs),
                         band_pair_capacity=out.pair_capacity, pairs_single=int(ref.num_pairs))
    log(f"{tag} band render of view 0 vs render_tiled: max|diff| {diff}, share of equal "
        f"values {same}, radii equal {radii_equal} (tol image/alpha 1e-5, depth 1e-4); "
        f"launches {launches}; largest band {int(out.num_pairs)} pairs of "
        f"{out.pair_capacity}, single render {int(ref.num_pairs)}")
    check(diff["image"] <= 1e-5 and diff["alpha"] <= 1e-5 and diff["depth"] <= 1e-4
          and radii_equal, f"{tag} the band render differs from the single render: {diff}")
    check(launches["blend_forward"] == 1 and launches["project_forward"] == 1,
          f"{tag} band render launches {launches}")
    check(int(out.num_pairs) <= out.pair_capacity, f"{tag} a band overflows its pair capacity")

    # one sharded step against the single-process step from the same state
    trans = draw_trans(torch, torch.Generator().manual_seed(seed), cfg.train.cam_trans_dist)
    s1, m1 = step1(state, cam, gt, aw, 2, trans, bg)
    sharded = make_sharded_train_step(cfg, mesh, W, H, 1.0, binocular=True)
    torch.cuda.synchronize()
    launch_counts(reset=True)
    s2, m2 = sharded(fresh_state(), cam, gt, aw, 2, trans, bg)
    torch.cuda.synchronize()
    launches = launch_counts()
    loss1, loss2 = float(m1.loss + m1.disparity_loss), float(m2.loss + m2.disparity_loss)
    rel = {n: rel_norm(getattr(s2.adam_m, n), getattr(s1.adam_m, n))
           for n in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")}
    rel["grad_accum"] = rel_norm(s2.grad_accum, s1.grad_accum)
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    TW, TH = tile_grid(W, H, cfg.raster.tile_size)
    band_h = -(-TH // world) * cfg.raster.tile_size
    expected = collections.Counter(
        blend_forward=2, blend_backward=2, warp_forward=1, warp_backward=1, project_forward=2,
        project_backward=2, ssim_forward=1, ssim_backward=1, **render_launches(2, 2, W, band_h))
    res["step"] = dict(loss_sharded=loss2, loss_single=loss1, loss_rel=loss_rel, rel_norm=rel,
                       launches=launches)
    log(f"{tag} one sharded step vs the single step: loss {loss2:.7f} vs {loss1:.7f} (rel "
        f"{loss_rel:.2e}, tol 1e-5); |d adam_m|/|adam_m| and grad_accum "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (tol 1e-3); launches {launches} (expected {expected})")
    check(loss_rel <= 1e-5, f"{tag} sharded and single losses differ by {loss_rel}")
    for k, v in rel.items():
        check(v <= 1e-3, f"{tag} sharded and single {k} differ by {v} (relative norm)")
    check(launches == expected, f"{tag} sharded step launches {launches}, expected {expected}")
    del s1, s2, state

    if cap % world == 0:
        # shard_gaussians against the replicated sharded render
        model = fresh_state().model
        render_g = make_sharded_render(mesh, W, H, cfg.raster, shard_gaussians=True)
        with torch.no_grad():
            diff, same, radii_equal = outputs_against(render_g(cam, model, bg),
                                                      render(cam, model, bg))
        res["shard_gaussians"] = dict(max_abs=diff, equal_share=same, radii_equal=radii_equal)
        log(f"{tag} shard_gaussians vs the replicated vertex stage: max|diff| {diff}, share "
            f"of equal values {same}, radii equal {radii_equal} (tol image/alpha 1e-5, "
            f"depth 1e-4)")
        check(diff["image"] <= 1e-5 and diff["alpha"] <= 1e-5 and diff["depth"] <= 1e-4
              and radii_equal, f"{tag} shard_gaussians changes the render: {diff}")

        # shard_adam against the replicated Adam, and the replicated step twice
        runs = []
        for shard_adam in (False, False, True):
            step = make_sharded_train_step(cfg, mesh, W, H, 1.0, binocular=True,
                                           shard_adam=shard_adam)
            st, gen, losses = fresh_state(), torch.Generator().manual_seed(seed), []
            for it in range(2, 2 + SHARDED_STEPS):
                st, m = step(st, cam, gt, aw, it,
                             draw_trans(torch, gen, cfg.train.cam_trans_dist), bg)
                losses.append(int((m.loss + m.disparity_loss).view(torch.int32)))
            runs.append((st, losses))
        rows = sorted({getattr(t, n).shape[0] for t in (runs[2][0].adam_m, runs[2][0].adam_v)
                       for n in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")})
        again = differing_buffers(state_tensors(runs[0][0]), state_tensors(runs[1][0]))
        adam = differing_buffers(state_tensors(runs[0][0]),
                                 state_tensors(gather_opt_state(runs[2][0], mesh)))
        res["shard_adam"] = dict(moment_rows=rows, buffers_differing=adam,
                                 losses_equal=runs[0][1] == runs[2][1])
        res["determinism"] = dict(buffers_differing=again, losses_equal=runs[0][1] == runs[1][1])
        log(f"{tag} {SHARDED_STEPS} steps: shard_adam (moment rows {rows}, capacity {cap}) vs "
            f"replicated: buffers differing {adam}, losses equal {runs[0][1] == runs[2][1]}; "
            f"replicated run twice: buffers differing {again}, losses equal "
            f"{runs[0][1] == runs[1][1]}")
        check(rows == [cap // world], f"{tag} sharded moments hold {rows} rows")
        check(not adam and runs[0][1] == runs[2][1], f"{tag} shard_adam differs in {adam}")
        check(not again and runs[0][1] == runs[1][1],
              f"{tag} the sharded step does not repeat: {again}")
        del runs

    # times: the step (CUDA events), its collectives (timed mode), kernels
    st, gen = fresh_state(), torch.Generator().manual_seed(seed)
    it = 2

    def one_step():
        nonlocal st, it
        st, _ = sharded(st, cam, gt, aw, it, draw_trans(torch, gen, cfg.train.cam_trans_dist),
                        bg)
        it += 1

    for _ in range(TRAIN_WARMUP):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        one_step()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    step_ms = [s.elapsed_time(e) for s, e in events]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = []  # (result bytes, host ms) of every collective, the card synchronised around it
    run = mesh._run

    def timed_run(op, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(op, x)
        torch.cuda.synchronize()
        calls.append((out.numel() * out.element_size(), (time.perf_counter() - t0) * 1e3))
        return out

    mesh._run = timed_run
    for _ in range(TRAIN_STEPS):
        one_step()
    mesh._run = run
    coll = dict(calls=len(calls) / TRAIN_STEPS,
                mib=sum(b for b, _ in calls) / TRAIN_STEPS / 2**20,
                ms=sum(t for _, t in calls) / TRAIN_STEPS)
    step_median = float(np.median(step_ms))
    log(f"{tag} step median {step_median:.4f} ms over {TRAIN_STEPS} (CUDA events), "
        f"{host_ms:.4f} ms per step on the host clock; collectives per step {coll['calls']:.0f} "
        f"calls, {coll['mib']:.2f} MiB of results, {coll['ms']:.4f} ms (host clock, card "
        f"synchronised around each); peak memory {peak_mib:.1f} MiB")
    busy = device_busy(torch, one_step, tag, step_median)
    res["timing"] = dict(step_ms_median=step_median, step_ms=step_ms, host_ms_per_step=host_ms,
                         collectives_per_step=coll, peak_mib=peak_mib, **busy)
    return res


def phase_sharded(torch, seed, work):
    """Phase 20: the band-sharded path on the one card, SHARDED_RANKS ranks
    at a time, each a `chip_smoke.py --sharded_rank` process (its gates are
    checked in the rank, which fails the phase)."""
    from binocular3dgs_torch.parallel.multihost import run_processes

    results = {}
    for world in SHARDED_RANKS:
        out = os.path.join(work, f"sharded_{world}")
        os.makedirs(out)
        cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--world",
               str(world), "--init_method", f"file://{out}/rendezvous", "--out", out]
        t0 = time.perf_counter()
        try:
            stdouts = run_processes([cmd + ["--sharded_rank", str(r)] for r in range(world)],
                                    timeout=420)
        except RuntimeError as e:
            fail(f"[20 sharded] {world} ranks: {e}")
        seconds = time.perf_counter() - t0
        for text in stdouts:
            print(text, end="", flush=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"[20 sharded] {world} ranks on one card over {SHARDED_TRANSPORT} (host-staged "
            f"{ranks[0]['staged']}): all gates held, {seconds:.1f} s with the processes' start")
        results[f"ranks_{world}"] = dict(seconds=seconds, ranks=ranks)
    return results


def phase_multihost(torch):
    """Phase 21: `dryrun_multihost` with 2 "hosts" of 1 rank on the card
    over gloo; then the nccl path at world size 1 (NCCL refuses two ranks on
    one card) against gloo at world size 1, equal bit for bit."""
    from binocular3dgs_torch.parallel.multihost import dryrun_multihost, run_processes

    t0 = time.perf_counter()
    loss = dryrun_multihost(2, 1, backend=SHARDED_TRANSPORT, device="cuda", timeout=300)
    seconds = time.perf_counter() - t0
    worker = [sys.executable, "-m", "binocular3dgs_torch.parallel.multihost", "--device", "cuda",
              "--world_size", "1", "--rank", "0", "--height", "48"]
    try:
        outs = run_processes([worker + ["--backend", b] for b in ("nccl", "gloo")], timeout=300)
    except RuntimeError as e:
        fail(f"[21 multihost] world size 1: {e}")
    nccl, gloo = (float(o.strip().splitlines()[-1].split("loss=")[1]) for o in outs)
    log(f"[21 multihost] 2 processes x 1 rank on the card over {SHARDED_TRANSPORT}: loss "
        f"{loss!r}, equal on both ranks and within 1e-6 of one rank ({seconds:.1f} s); one rank "
        f"over nccl {nccl!r}, over gloo {gloo!r}")
    check(np.isfinite(loss), f"non-finite dry-run loss {loss}")
    check(nccl == gloo, f"one rank over nccl ({nccl!r}) and gloo ({gloo!r}) differ")
    check(abs(nccl - loss) < 1e-6, f"one rank {nccl!r} and two ranks {loss!r} differ")
    return dict(loss=loss, seconds=seconds, nccl_world1=nccl, gloo_world1=gloo)


def phase_span_cost(torch, scene, work):
    """The cost of the trainer's host reads: phase 10's `cli train` (60
    iterations) with the default spans and with `--fused_steps 1` (a read
    after every step), in turns default, 1, 1, default; iterations per
    second of `Trainer.train` (host clock, the card synchronised at its
    end). No checkpoints and no report, so the train() span is the steps,
    densification and the PLY save at 60."""
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.train import loop

    runs = []
    for fused in (0, 1, 1, 0):
        out = os.path.join(work, f"spans_{len(runs)}")
        argv = ["train", "-s", scene, "-m", out, "--eval", "--iterations", "60",
                "--shift_cam_start", "20", "--densify_from_iter", "20",
                "--densification_interval", "20", "--densify_grad_threshold", "1e-6",
                "--fused_steps", str(fused), "-q"]
        timed, original = {}, loop.Trainer.train

        def train(trainer, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = original(trainer, *a, **k)
            torch.cuda.synchronize()
            timed["s"], timed["trainer"] = time.perf_counter() - t0, trainer
            return state

        loop.Trainer.train = train
        try:
            check(cli.main(argv) == 0, f"cli train --fused_steps {fused} failed")
        finally:
            loop.Trainer.train = original
        runs.append(dict(fused_steps=fused, seconds=timed["s"], it_per_s=60 / timed["s"],
                         pairs_per_gaussian=timed["trainer"].raster.pairs_per_gaussian,
                         state={k: v.clone() for k, v in
                                state_tensors(timed["trainer"].state).items()}))
        shutil.rmtree(out, ignore_errors=True)
    differing = differing_buffers(runs[0]["state"], runs[1]["state"])
    for r in runs:
        del r["state"]
    ips = {f: [r["it_per_s"] for r in runs if r["fused_steps"] == f] for f in (0, 1)}
    log(f"[10 spans] cli train, 60 iterations: it/s with the default spans {ips[0]}, with "
        f"--fused_steps 1 {ips[1]} (host clock around Trainer.train); final states differing "
        f"{differing} (pairs_per_gaussian {[r['pairs_per_gaussian'] for r in runs]})")
    return dict(runs=runs, buffers_differing=differing)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 20, started by phase_sharded
    ap.add_argument("--sharded_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init_method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_rank is not None:
        sharded_rank(args)
        return
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)

    device, smi = phase_environment(torch)
    phase_build()

    from binocular3dgs_torch.config import Config, RasterConfig
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy

    params, active, _ = make_workload(args.seed)
    model = from_numpy(params, active, max_sh_degree=1, active_sh_degree=1, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H, device=device)
    raster = RasterConfig(pairs_per_gaussian=PAIRS_PER_GAUSSIAN)
    log(f"[3 workload] {N_GAUSS} gaussians, {W}x{H}, pairs_per_gaussian "
        f"{PAIRS_PER_GAUSSIAN}, seed {args.seed}")

    b1, fwd = phase_kernel_parity(torch, model, cam, raster)
    od_params, _, _ = make_workload(args.seed, scales=OVERDRAW_SCALES, opacity=OVERDRAW_OPACITY)
    od_model = from_numpy(od_params, active, max_sh_degree=1, active_sh_degree=1, device=device)
    b1["overdraw"], fwd_od = phase_kernel_parity(torch, od_model, cam, raster,
                                                 tag="[4 overdraw]", grow=True)
    with torch.no_grad():  # serving
        main_path, view0 = phase_main_path(torch, model, device, raster)
    b2 = phase_backward_parity(torch, fwd, args.seed)
    b2["overdraw"] = phase_backward_parity(torch, fwd_od, args.seed, tag="[7 overdraw]")
    del fwd_od, od_model
    w1, w2 = phase_warp_parity(torch, view0, args.seed)
    # the opposite sign at the trainer's widest shift
    w1["opposite_shift"], w2["opposite_shift"] = phase_warp_parity(
        torch, view0, args.seed, trans=-Config().train.cam_trans_dist, tag="[8 warp opposite]")
    p1, p2 = phase_vertex(torch, args.seed, device)
    s1, s2 = phase_ssim(torch, args.seed, device)
    bins = phase_binning(torch, args.seed, device)
    train = phase_train(torch, device, args.seed)
    b1["launches_serving"] = main_path["launches"]
    p1["launches_serving"] = main_path["project_launches"]
    kernels = (b1, b2, w1, w2, p1, p2, s1, s2, *bins)
    for k in kernels:
        k["launches"] = train["launches"][k["name"]]

    work = os.path.join(REPO, "build", "chip_smoke_scene")
    shutil.rmtree(work, ignore_errors=True)
    try:
        scene = os.path.join(work, "scene")
        write_colmap_scene(scene, args.seed)
        cli_res = phase_entry_point(torch, model, scene, work)
        cli_train, trained = phase_cli_train(torch, scene, work)
        spans = phase_span_cost(torch, scene, work)
        resume = phase_resume(torch, scene, work, trained, cli_train["pairs_per_gaussian"])
        spiral = phase_spiral(torch, trained)
        lpips = phase_lpips(torch, args.seed, work, os.path.join(work, "model"))
        viewer = phase_viewer(torch, model, cam, device)
        determinism = phase_determinism(torch, device, args.seed, scene, work, trained)
        dense_init, init_params, init_xyz = phase_dense_init(torch, device, args.seed, work)
        init_card_vs_cpu = phase_init_card_vs_cpu(torch, device, args.seed, work, init_params,
                                                  init_xyz)
        pdcnet, pdcnet_npz = phase_pdcnet(torch, device, args.seed, work)
        pdcnet_card_vs_cpu = phase_pdcnet_card_vs_cpu(torch, device, args.seed, work, pdcnet_npz)
        sharded = phase_sharded(torch, args.seed, work)
        multihost = phase_multihost(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in kernels:  # per rank, in one sharded step (each rank held alike)
        k["launches_sharded_step"] = [r["step"]["launches"][k["name"]]
                                      for r in sharded[f"ranks_{SHARDED_RANKS[0]}"]["ranks"]]
    b1["launches_spiral"] = spiral["launches"]
    for k in kernels:
        k["launches_resumed"] = resume["launches"][k["name"]]

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels), "main_path": main_path, "train": train,
                      "cli": cli_res, "cli_train": cli_train, "resume": resume,
                      "spiral": spiral, "lpips": lpips, "viewer": viewer,
                      "determinism": determinism, "dense_init": dense_init,
                      "init_card_vs_cpu": init_card_vs_cpu, "pdcnet": pdcnet,
                      "pdcnet_card_vs_cpu": pdcnet_card_vs_cpu, "sharded": sharded,
                      "multihost": multihost, "spans": spans, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
