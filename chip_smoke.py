#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (binocular3dgs_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's serving path and its training path at full width and
fails (non-zero exit) if any phase fails:

  1. environment: the card (nvidia-smi name and power limit), torch/CUDA
     versions, TF32 off for matmuls and cuDNN
  2. build: every csrc/*.cu with nvcc into build/libbinocular_kernels.<key>.so
  3. workload: 100k gaussians (SH degree 1) before a 1008x756 camera, made
     with numpy from --seed, 6 pairs per gaussian
  4. kernel parity at full width: the blend kernel against its plain PyTorch
     version on the records of the port's project -> bin -> gather; kernel
     time, plain time and the kernel's bound
  5. main path: 8 views on an arc through render_tiled on the card, with
     the kernel launch counts read around exactly that run; render and
     per-stage times; an end-to-end check against the plain blend and a
     small-input check against the dense oracle
  6. entry point: `cli render` and `cli metrics` in-process on a fabricated
     9-view 1008x756 COLMAP scene (20k points) and a PLY of the phase-3 model
     whose cfg_args.json sets `eval`
  7. backward kernel parity at full width: the blend backward kernel against
     its plain version on phase 4's records, the forward kernel's outputs
     and a seeded cotangent, row by row; kernel time, plain time and bound
  8. warp kernel parity at full width: the warp forward and backward kernels
     against their plain versions on phase 5's view-0 render and its
     disparity; times and bounds
  9. training main path: the bench.py workload through
     `make_train_step(binocular=True)`, 3 warm-up and 10 timed steps with the
     launch counters read around exactly the timed ones (2 blend forward, 2
     blend backward, 1 warp forward, 1 warp backward per step); step time,
     per-stage times, peak memory, device busy share and top kernels; one
     step at 5k gaussians and 256x192 on the card against the CPU
 10. entry point: `cli train` (densification and the binocular branch
     reached) on the phase-6 scene, then `cli render` and `cli metrics` on
     its output

It prints a JSON line of per-kernel results, the card's nvidia-smi line, and
last `{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and FP32 rate outside the tensor cores. The 67 TFLOP/s counts a
# fused multiply-add as two operations; the kernels build with --fmad=false,
# so each multiply, add or compare is one instruction and the rate they can
# reach is half of it.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
# per pair-pixel evaluation of the blend: one expf (counted as one
# instruction) and ~15 FP32 multiply/add/compare instructions
BLEND_INSTR_PER_EVAL = 16
# bytes per valid pair read (10 float32 fields), per tile (start, count),
# per pixel written (5 float32 planes + 1 int32)
BLEND_BYTES_PER_PAIR, BLEND_BYTES_PER_TILE, BLEND_BYTES_PER_PIXEL = 40, 8, 24
# blend backward, counted from csrc/blend_backward.cu: the alpha of every
# pair below a pixel's n_contrib (as the forward's), and for each pair that
# blended there ~45 FP32 instructions of cotangent algebra plus the ~10
# additions that sum its ten terms over the tile's pixels
BWD_INSTR_PER_EVAL, BWD_INSTR_PER_HIT = 16, 55
# bytes: 40 read + 40 written per walked pair, per pixel 28 read (T_final,
# five cotangent planes, n_contrib), per tile 8
BWD_BYTES_PER_PAIR, BWD_BYTES_PER_PIXEL = 80, 28
# warp: W1 reads the disparity and the image once and writes out and diff
# (4 + 12 + 24 B per pixel); W2 reads the disparity and d_out and writes
# d_image (4 + 12 + 12 B per pixel); a few FP32 operations per pixel
WARP_FWD_BYTES_PER_PIXEL, WARP_BWD_BYTES_PER_PIXEL = 40, 28
WARP_NO_LIBRARY = ("none: grid_sample zeroes each out-of-range tap, the warp zeroes the "
                   "whole pixel, so no single PyTorch call computes the same function")
TRAIN_WARMUP, TRAIN_STEPS = 3, 10

W, H, N_GAUSS, PAIRS_PER_GAUSSIAN = 1008, 756, 100_000, 6
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
    """Device time per call of the kernels whose name holds `name`, from
    torch.profiler over `reps` calls after one warm-up: the kernel alone,
    without the wrapper's host time, which an event pair around one short
    call also holds. Before each call a 64 MiB write evicts the 50 MB L2, so
    the kernel reads its inputs from device memory, as its bound assumes.
    None when the profiler sees no device time."""
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
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / 1e3 / reps if us > 0 else None


def kernel_times(torch, fn, name):
    """(ms, event ms): the kernel's device time from the profiler (the
    event time where the profiler sees none) and the CUDA-event median
    around the wrapper call."""
    event_ms = median_ms(torch, fn)
    device_ms = kernel_device_ms(torch, fn, name)
    return (event_ms if device_ms is None else device_ms), event_ms


def make_workload(seed, n=N_GAUSS, width=W, height=H):
    """The bench.py workload, drawn in the same order from the same seed:
    xyz in [-2,2]x[-1.5,1.5]x[3,9], SH degree 1 (rest bands zero), opacity
    logits in [-2,1], scales in [0.005,0.02], identity rotations, then the
    (3, H, W) ground-truth image of the training step."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], 1)
    params = dict(
        xyz=xyz.astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        f_rest=np.zeros((n, 3, 3), np.float32),
        opacity=rng.uniform(-2, 1, (n, 1)).astype(np.float32),
        scaling=np.log(rng.uniform(0.005, 0.02, (n, 3))).astype(np.float32),
        rotation=np.concatenate([np.ones((n, 1)), np.zeros((n, 3))], 1).astype(np.float32),
    )
    gt = rng.random((3, height, width)).astype(np.float32)
    return params, np.ones(n, bool), gt


def arc_poses(n):
    """(R camera-to-world, T world-to-camera) of n cameras on a small arc
    around the y axis, all facing the workload's slab."""
    poses = []
    for a in np.linspace(-0.08, 0.08, n):
        c, s = np.cos(a), np.sin(a)
        Rw2c = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])  # looks at (0, 0, 6)
        center = np.array([6.0 * np.sin(a), 0.0, 6.0 * (1.0 - np.cos(a))])
        poses.append((Rw2c.T, -Rw2c @ center))
    return poses


def needed_evaluations(torch, records, tile_start, tile_count, n_contrib, TW, TH, ts, chunk=32):
    """Pair-pixel evaluations the blend's data needs: each pixel evaluates
    its tile's pairs up to and including the one that terminates it (the
    first pair past its last blended one with alpha > 0), or all of them."""
    from binocular3dgs_torch.ops.blend_cuda import _splat, _tile_pixel_coords

    px, py = _tile_pixel_coords(TW, TH, ts, records.device)
    start, count = tile_start.long(), tile_count.long()
    nc = n_contrib.long()
    big = torch.iinfo(torch.int64).max
    first_kill = torch.full_like(nc, big)
    for c0 in range(0, int(count.max()), chunk):
        k = c0 + torch.arange(chunk, device=records.device)
        valid = k[None, :] < count[:, None]
        rec = records[:6, torch.clamp(start[:, None] + k[None, :], max=records.shape[1] - 1)]
        alpha = _splat(rec, px, py)[3]
        hit = (alpha > 0) & valid[:, None, :] & (k >= nc[..., None])
        first_kill = torch.minimum(first_kill, torch.where(hit, k, big).amin(-1))
    evals = torch.where(first_kill < big, first_kill + 1, count[:, None])
    return int(evals.sum())


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


def phase_kernel_parity(torch, model, cam, raster):
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.blend_cuda import blend_forward, blend_forward_torch
    from binocular3dgs_torch.ops.rasterize import _build_fields, project_for_render

    ts = raster.tile_size
    TW, TH = tile_grid(W, H, ts)
    T = TW * TH
    proj = project_for_render(cam, model, raster=raster)
    cap = raster.pairs_per_gaussian * model.capacity
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts, cap)
    records = _build_fields(proj)[:, b.order][:, b.pair_gauss].contiguous()
    args = (records, b.tile_start, b.tile_count, TW, TH, ts)

    out5, nc = blend_forward(*args)
    torch.cuda.synchronize()
    want5, want_nc = blend_forward_torch(*args)
    rgbT = [0, 1, 2, 4]
    err_rgbT = (out5[rgbT] - want5[rgbT]).abs().max().item()
    err_depth = (out5[3] - want5[3]).abs().max().item()
    depth_tol = 1e-5 * want5[3].abs().max().item() + 1e-4
    nc_equal = (nc == want_nc).double().mean().item()
    num_pairs, valid_pairs = int(b.num_pairs), int(b.tile_count.sum())
    log(f"[4 parity] num_pairs {num_pairs} / capacity {cap} (blended {valid_pairs}); "
        f"max tile pairs {int(b.tile_count.max())}")
    log(f"[4 parity] max|diff| r,g,b,T_final {err_rgbT:.3e} (tol 1e-4); depth "
        f"{err_depth:.3e} (tol {depth_tol:.3e}); n_contrib equal on {nc_equal:.6f} "
        f"(tol >= 0.999)")
    check(err_rgbT <= 1e-4, f"blend kernel r,g,b,T_final differ by {err_rgbT}")
    check(err_depth <= depth_tol, f"blend kernel depth differs by {err_depth}")
    check(nc_equal >= 0.999, f"blend kernel n_contrib equal on only {nc_equal}")
    check(num_pairs <= cap, f"pair capacity overflow: {num_pairs} > {cap}")

    ms, event_ms = kernel_times(torch, lambda: blend_forward(*args), "blend_forward_kernel")
    plain_ms = median_ms(torch, lambda: blend_forward_torch(*args), warmup=1, iters=3)
    evals = needed_evaluations(torch, records, b.tile_start, b.tile_count, want_nc, TW, TH, ts)
    bytes_ = (BLEND_BYTES_PER_PAIR * valid_pairs + BLEND_BYTES_PER_TILE * T
              + BLEND_BYTES_PER_PIXEL * T * ts * ts)
    instr = BLEND_INSTR_PER_EVAL * evals
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, instr / FP32_INSTR_PER_S * 1e3
    log(f"[4 parity] kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events around the "
        f"wrapper), plain {plain_ms:.3f} ms; bound: {bytes_} B -> "
        f"{bytes_ms:.4f} ms, {evals} evaluations x {BLEND_INSTR_PER_EVAL} FP32 instructions "
        f"at {FP32_INSTR_PER_S:.3g}/s -> {ops_ms:.4f} ms")
    kernel = dict(
        name="blend_forward",
        route="cuda",
        source="binocular3dgs_torch/csrc/blend_forward.cu",
        replaces="binocular3dgs_tpu/ops/blend_pallas.py:507",
        launches=None,
        max_abs_err=max(err_rgbT, err_depth),
        parity=dict(rgbT_max_abs=err_rgbT, depth_max_abs=err_depth, depth_tol=depth_tol,
                    n_contrib_equal=nc_equal, num_pairs=num_pairs, pair_capacity=cap,
                    evaluations=evals),
        ms=ms,
        event_ms=event_ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
        library_note="none: no single PyTorch call computes the tile blend",
    )
    return kernel, dict(args=args, out5=out5, n_contrib=nc, valid_pairs=valid_pairs)


def kernel_bound(bytes_, instr):
    """(bound ms, what bounds it) from bytes moved and FP32 instructions."""
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, instr / FP32_INSTR_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_ms, ops_ms


def backward_work(torch, records, tile_start, tile_count, n_contrib, TW, TH, ts, chunk=32):
    """(walked pairs, evaluations, hits) of the blend backward on this data:
    each tile walks its pairs below its largest n_contrib; each pixel
    evaluates the alpha of the pairs below its own n_contrib, and a hit is
    one whose alpha is > 0 there (a pair it blended)."""
    from binocular3dgs_torch.ops.blend_cuda import _splat, _tile_pixel_coords

    px, py = _tile_pixel_coords(TW, TH, ts, records.device)
    start, nc = tile_start.long(), n_contrib.long()
    n_walk = torch.minimum(nc.amax(1), tile_count.long())
    hits = 0
    for c0 in range(0, int(n_walk.max()), chunk):
        k = c0 + torch.arange(chunk, device=records.device)
        idx = torch.clamp(start[:, None] + k[None, :], max=records.shape[1] - 1)
        alpha = _splat(records[:6, idx], px, py)[3]
        hits += int(((alpha > 0) & (k[None, None, :] < nc[..., None])).sum())
    return int(n_walk.sum()), int(nc.sum()), hits


def phase_backward_parity(torch, fwd, seed):
    from binocular3dgs_torch.ops.blend_cuda import blend_backward, blend_backward_torch

    records, start, count, TW, TH, ts = fwd["args"]
    out5, nc = fwd["out5"], fwd["n_contrib"]
    rng = np.random.default_rng(seed + 7)
    d_out5 = torch.from_numpy(rng.normal(size=tuple(out5.shape)).astype(np.float32)).to(
        out5.device)
    args = (records, start, count, out5, nc, d_out5, TW, TH, ts)
    got = blend_backward(*args)
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
    log("[7 backward] max|diff| / max|row| per row: " + ", ".join(
        f"{k} {v['max_abs']:.3e}/{v['max_row']:.3e}" for k, v in rows.items()) + " (tol 1e-3)")

    ms, event_ms = kernel_times(torch, lambda: blend_backward(*args), "blend_backward_kernel")
    plain_ms = median_ms(torch, lambda: blend_backward_torch(*args), warmup=1, iters=3)
    walked, evals, hits = backward_work(torch, records, start, count, nc, TW, TH, ts)
    T = TW * TH
    bytes_ = BWD_BYTES_PER_PAIR * walked + BWD_BYTES_PER_PIXEL * T * ts * ts + 8 * T
    instr = BWD_INSTR_PER_EVAL * evals + BWD_INSTR_PER_HIT * hits
    bound_ms, bound_by, bytes_ms, ops_ms = kernel_bound(bytes_, instr)
    log(f"[7 backward] kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events), plain "
        f"{plain_ms:.3f} ms; bound: {walked} walked "
        f"pairs, {bytes_} B -> {bytes_ms:.4f} ms; {evals} evaluations x {BWD_INSTR_PER_EVAL} + "
        f"{hits} hits x {BWD_INSTR_PER_HIT} FP32 instructions -> {ops_ms:.4f} ms")
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
        library_ms=None,
        library_note="none: no single PyTorch call computes the blend backward",
    )


def phase_warp_parity(torch, view0, seed):
    from binocular3dgs_torch.ops import warp

    image, depth, cam = view0
    disparity = cam.focal_x * (-0.2) / (depth + 1e-5)
    rng = np.random.default_rng(seed + 8)
    d_out = torch.from_numpy(rng.normal(size=tuple(image.shape)).astype(np.float32)).to(
        image.device)
    out, diff = warp.warp_forward(image, disparity)
    d_img = warp.warp_backward(disparity, d_out)
    torch.cuda.synchronize()
    want_out, want_diff = warp.warp_forward_torch(image, disparity)
    want_d_img = warp.warp_backward_torch(disparity, d_out)
    err_out = (out - want_out).abs().max().item()
    err_diff = (diff - want_diff).abs().max().item()
    err_d_img = (d_img - want_d_img).abs().max().item()
    d_img_tol = 1e-5 * want_d_img.abs().max().item()
    valid = warp.warp_mask(disparity, cam.height, cam.width).mean().item()
    log(f"[8 warp] disparity {disparity.min().item():.2f}..{disparity.max().item():.2f} px, "
        f"valid share {valid:.4f}; W1 max|diff| out {err_out:.3e} diff {err_diff:.3e} "
        f"(tol 1e-6); W2 d_image {err_d_img:.3e} (tol {d_img_tol:.3e}: shared-memory atomics "
        f"add each column's taps in a varying order)")
    check(err_out <= 1e-6 and err_diff <= 1e-6, f"warp forward differs by {err_out}, {err_diff}")
    check(err_d_img <= d_img_tol, f"warp backward differs by {err_d_img}")
    check(0.05 < valid, "the warp's disparity leaves almost no valid pixel")

    pixels = cam.height * cam.width
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
        log(f"[8 warp] {name} kernel {ms:.4f} ms (profiler; {event_ms:.4f} ms CUDA events "
            f"around the wrapper), plain {plain_ms:.4f} ms; bound {bpp * pixels} B -> "
            f"{bound_ms:.4f} ms")
        res.append(dict(
            name=name, route="cuda", source="binocular3dgs_torch/csrc/warp.cu",
            replaces=tpu_line, launches=None, max_abs_err=err,
            parity=dict(out_max_abs=err_out, diff_max_abs=err_diff, d_image_max_abs=err_d_img,
                        d_image_tol=d_img_tol, valid_share=valid),
            ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, library_note=WARP_NO_LIBRARY,
        ))
    return res


def plain_render_image(torch, cam, model, bg, raster):
    """The image of render_tiled with the blend done by its plain PyTorch
    version, from the rasterizer's own stages."""
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.blend_cuda import blend_forward_torch
    from binocular3dgs_torch.ops.rasterize import (
        _build_fields, _tiles_to_planes, project_for_render,
    )

    ts = raster.tile_size
    TW, TH = tile_grid(cam.width, cam.height, ts)
    proj = project_for_render(cam, model, raster=raster)
    b = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, cam.width, cam.height, ts,
                      raster.pairs_per_gaussian * model.capacity)
    records = _build_fields(proj)[:, b.order][:, b.pair_gauss]
    out5, _ = blend_forward_torch(records, b.tile_start, b.tile_count, TW, TH, ts)
    planes = _tiles_to_planes(out5, TW, TH, ts, cam.height, cam.width)
    return planes[0:3] + planes[4][None] * bg[:, None, None]


def phase_main_path(torch, model, device, raster):
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy
    from binocular3dgs_torch.ops import blend_cuda
    from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid
    from binocular3dgs_torch.ops.rasterize import (
        _build_fields, _tiles_to_planes, project_for_render, render_tiled,
    )
    from binocular3dgs_torch.ops.rasterize_reference import render_dense

    cams = [make_camera(R, T, FOVX, FOVY, W, H, device=device) for R, T in arc_poses(N_VIEWS)]
    bg = torch.zeros(3, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    blend_cuda.blend_forward_launches = 0
    outs = [render_tiled(cam, model, bg, raster=raster, device=device) for cam in cams]
    torch.cuda.synchronize()
    launches = blend_cuda.blend_forward_launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    log(f"[5 main] {N_VIEWS} renders, blend_forward launches {launches}, peak memory "
        f"{peak_mb:.1f} MiB")
    check(launches == N_VIEWS, f"blend_forward launched {launches} times for {N_VIEWS} renders")
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
    records = _build_fields(proj)[:, b.order][:, b.pair_gauss]
    out5, _ = blend_cuda.blend_forward(records, b.tile_start, b.tile_count, TW, TH, ts)
    stages = {
        "project": lambda: project_for_render(cam, model, raster=raster),
        "bin": lambda: bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts, cap),
        "gather": lambda: _build_fields(proj)[:, b.order][:, b.pair_gauss],
        "blend": lambda: blend_cuda.blend_forward(records, b.tile_start, b.tile_count, TW, TH, ts),
        "planes": lambda: _tiles_to_planes(out5, TW, TH, ts, H, W).contiguous(),
    }
    stage_ms = {k: median_ms(torch, fn) for k, fn in stages.items()}
    log(f"[5 main] render median {render_ms:.4f} ms over 20 (after 3 warm-ups); stages "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items()) + " ms")
    busy = device_busy(torch, lambda: render_tiled(cam, model, bg, raster=raster, device=device),
                       "[5 main]", render_ms)
    result = dict(launches=launches, render_ms=render_ms, stage_ms=stage_ms, peak_mib=peak_mb,
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
        return dict(kernel_ms_per_call=None, device_busy_share_profiled=None,
                    device_busy_share_unprofiled=None, top_kernels_us=None)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    kernel_ms = kernel_us / 1e3 / reps
    log(f"{tag} profiler: {kernel_ms:.4f} ms of kernels per call, {wall_ms / reps:.4f} ms wall "
        f"per call, device busy under the profiler {kernel_us / 1e3 / wall_ms:.3f}, against "
        f"the unprofiled median {kernel_ms / unprofiled_ms:.3f}; top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / reps:.1f} us" for e in top))
    return dict(kernel_ms_per_call=kernel_ms,
                device_busy_share_profiled=kernel_us / 1e3 / wall_ms,
                device_busy_share_unprofiled=kernel_ms / unprofiled_ms,
                top_kernels_us={e.key[:80]: e.self_device_time_total / reps for e in top})


def write_colmap_scene(root, seed, n_points=20_000):
    """9 PINHOLE views at W x H on an arc, numpy-seeded PNGs, `n_points`
    random points in the workload's slab (create_from_pcd, its 3-NN scales
    and densification do real work on them)."""
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


def phase_entry_point(torch, model, scene, work):
    from binocular3dgs_torch import cli
    from binocular3dgs_torch.config import Config, save_config
    from binocular3dgs_torch.models.gaussians import save_ply
    from binocular3dgs_torch.ops import blend_cuda

    out = os.path.join(work, "model")
    save_ply(model, os.path.join(out, "point_cloud", "iteration_1", "point_cloud.ply"))
    cfg = Config()
    cfg.model.eval = True  # cli render takes its settings from this file alone
    save_config(cfg, os.path.join(out, "cfg_args.json"))
    before = blend_cuda.blend_forward_launches
    t0 = time.perf_counter()
    check(cli.main(["render", "-m", out, "-s", scene]) == 0, "cli render failed")
    t_render = time.perf_counter() - t0
    n_render = blend_cuda.blend_forward_launches - before
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
    return dict(psnr=res["PSNR"], ssim=res["SSIM"], render_s=t_render, metrics_s=t_metrics)


def launch_counts(reset=False):
    """The four kernels' launch counters; with `reset`, set them to 0."""
    from binocular3dgs_torch.ops import blend_cuda, warp

    counters = ((blend_cuda, "blend_forward"), (blend_cuda, "blend_backward"),
                (warp, "warp_forward"), (warp, "warp_backward"))
    if reset:
        for mod, name in counters:
            setattr(mod, f"{name}_launches", 0)
    return {name: getattr(mod, f"{name}_launches") for mod, name in counters}


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
        u, s = torch.rand(2, generator=gen).tolist()
        return u * cfg.train.cam_trans_dist * (1.0 if s < 0.5 else -1.0)

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

    expected = dict(blend_forward=2 * TRAIN_STEPS, blend_backward=2 * TRAIN_STEPS,
                    warp_forward=TRAIN_STEPS, warp_backward=TRAIN_STEPS)
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
        g, c = getattr(sg.adam_m, n).cpu(), getattr(sc.adam_m, n)
        rel[n] = float((g - c).norm() / c.norm()) if c.norm() > 0 else float(g.norm())
    rel["carrier_grad_norms"] = float((sg.grad_accum.cpu() - sc.grad_accum).norm()
                                      / sc.grad_accum.norm())
    log(f"[9 train] 5k gaussians 256x192, card vs CPU after one step: loss {loss_g:.7f} vs "
        f"{loss_c:.7f} (rel {loss_rel:.2e}, tol 1e-5); |d adam_m| / |adam_m| and carrier grad "
        f"norms: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (tol 1e-3)")
    check(loss_rel <= 1e-5, f"card and CPU losses differ by {loss_rel} (relative)")
    for k, v in rel.items():
        check(v <= 1e-3, f"card and CPU {k} differ by {v} (relative norm)")
    check(float(sc.grad_accum.norm()) > 0, "the small step has no carrier gradient")
    return dict(loss_card=loss_g, loss_cpu=loss_c, loss_rel=loss_rel, rel_norm=rel)


def phase_cli_train(scene, work):
    from binocular3dgs_torch import cli

    out = os.path.join(work, "trained")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    # on this random-noise scene at full width no point's mean carrier
    # gradient reaches the reference's 2e-4 in 20 iterations, so the point
    # count would not move; 1e-6 makes densification split and clone
    argv = ["train", "-s", scene, "-m", out, "--eval", "--iterations", "60",
            "--shift_cam_start", "20", "--densify_from_iter", "20",
            "--densification_interval", "20", "--densify_grad_threshold", "1e-6",
            "--test_iterations", "60", "--save_iterations", "60"]
    check(cli.main(argv) == 0, "cli train failed")
    t_train = time.perf_counter() - t0
    counts = launch_counts()
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
                disparity_loss=disp, launches=counts, psnr=res["PSNR"], ssim=res["SSIM"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)

    device, smi = phase_environment(torch)
    phase_build()

    from binocular3dgs_torch.config import RasterConfig
    from binocular3dgs_torch.core.camera import make_camera
    from binocular3dgs_torch.models.gaussians import from_numpy

    params, active, _ = make_workload(args.seed)
    model = from_numpy(params, active, max_sh_degree=1, active_sh_degree=1, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H, device=device)
    raster = RasterConfig(pairs_per_gaussian=PAIRS_PER_GAUSSIAN)
    log(f"[3 workload] {N_GAUSS} gaussians, {W}x{H}, pairs_per_gaussian "
        f"{PAIRS_PER_GAUSSIAN}, seed {args.seed}")

    b1, fwd = phase_kernel_parity(torch, model, cam, raster)
    with torch.no_grad():  # serving
        main_path, view0 = phase_main_path(torch, model, device, raster)
    b2 = phase_backward_parity(torch, fwd, args.seed)
    w1, w2 = phase_warp_parity(torch, view0, args.seed)
    train = phase_train(torch, device, args.seed)
    b1["launches_serving"] = main_path["launches"]
    for k in (b1, b2, w1, w2):
        k["launches"] = train["launches"][k["name"]]

    work = os.path.join(REPO, "build", "chip_smoke_scene")
    shutil.rmtree(work, ignore_errors=True)
    try:
        scene = os.path.join(work, "scene")
        write_colmap_scene(scene, args.seed)
        cli_res = phase_entry_point(torch, model, scene, work)
        cli_train = phase_cli_train(scene, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [b1, b2, w1, w2], "main_path": main_path, "train": train,
                      "cli": cli_res, "cli_train": cli_train, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
