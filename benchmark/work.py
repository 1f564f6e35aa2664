"""The yardstick's arithmetic: the card's peaks, a kernel's bound, the blend
kernels' work on given data, and the useful FP32 operations of one
binocular training iteration.

The bound and the blend work are frozen copies of `chip_smoke.py`'s
(`kernel_bound`, `forward_work`, `backward_work` and their constants), with
the plain splat taken from this folder's reference, so that the work is
counted from the data and not from the kernel under test.
"""

from __future__ import annotations

import torch

from . import reference as ref

# NVIDIA H100 SXM published peaks at the 700 W limit: HBM bandwidth and the
# FP32 rate outside the tensor cores, which counts a multiply-add as two.
# The blend kernels build without contraction, so each of their FP32
# multiply, add or compare instructions is one operation at half the rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2

# blend forward, per pair-pixel that blends: one expf and ~15 FP32
# instructions; bytes per pair read (10 float32), per tile (start, count),
# per pixel written (5 float32 planes + 1 int32)
BLEND_INSTR_PER_EVAL = 16
BLEND_BYTES_PER_PAIR, BLEND_BYTES_PER_TILE, BLEND_BYTES_PER_PIXEL = 40, 8, 24
# blend backward, per pair-pixel that blended: its alpha (16), ~45 FP32
# instructions of cotangent algebra and ~10 additions of its ten terms over
# the tile; bytes: 40 read + 40 written per walked pair, 28 read per pixel
# (T_final, five cotangent planes, n_contrib), 8 per tile
BWD_INSTR_PER_EVAL, BWD_INSTR_PER_HIT = 16, 55
BWD_BYTES_PER_PAIR, BWD_BYTES_PER_PIXEL, BWD_BYTES_PER_TILE = 80, 28, 8

# The useful FP32 operations of a training iteration beside the blends,
# counted from the reference's code (a multiply-add counts as two):
# the vertex stage per visible gaussian per differentiated render: ~335
# forward (covariance ~81, EWA ~111, projection ~66, conic and radius ~20,
# extents ~15, SH degree 1 and its direction ~42) and twice that backward
PROJECT_FLOPS = 1005
# SSIM: the window is the outer product of two 1-D Gaussians, so a blur is
# two passes of 11 taps (2 x 11 operations per output each); of its five
# blurs of 3 channels the two of the ground truth alone (blur(y),
# blur(y * y)) are fixed per view and no iteration needs them: the three
# that depend on the render (blur(x), blur(x * x), blur(x * y)) forward and
# their input gradients backward
SSIM_CONV_FLOPS_PER_PIXEL = (3 + 3) * 3 * 2 * (2 * ref.SSIM_WINDOW)
# per pixel of the image, forward and backward: SSIM's elementwise map
# (~60 per channel), L1 (15), the composite with the background of both
# renders (24), the disparity (7), W1 (11), W2 (12) and the disparity
# cotangent (6), the masked L1 (21), the smoothness term (50)
PIXEL_FLOPS = 180 + 15 + 24 + 7 + 11 + 12 + 6 + 21 + 50
# Adam per parameter value (moments 7, bias corrections, square root,
# division and step 9), and per active gaussian the opacity decay (5) and
# the densification statistics (10)
ADAM_FLOPS_PER_VALUE = 16
GAUSSIAN_FLOPS = 15


def kernel_bound(bytes_, instr):
    """(bound ms, what bounds it, bytes ms, operations ms) from bytes moved
    and FP32 instructions."""
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, instr / FP32_INSTR_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_ms, ops_ms


@torch.no_grad()
def forward_work(records, tile_start, tile_count, n_contrib, TW, TH, ts, chunk=32):
    """(pairs read, dense evaluations, hits, terminated pixels) of the blend
    forward on this data. A dense walk evaluates each pixel's pairs up to
    and including the one that terminates it (the first pair past its last
    blended one with alpha > 0), or all of them; a tile needs its pairs read
    up to its pixels' last such evaluation; the hits are the evaluations
    whose alpha is > 0: the pairs a pixel blended and the terminating one."""
    px, py = ref.tile_pixels(TW, TH, ts, records.device)
    start, count = tile_start.long(), tile_count.long()
    nc = n_contrib.long()
    big = torch.iinfo(torch.int64).max
    first_kill = torch.full_like(nc, big)
    blended = 0
    for c0 in range(0, int(count.max()), chunk):
        k = c0 + torch.arange(chunk, device=records.device)
        valid = k[None, :] < count[:, None]
        rec = records[:6, torch.clamp(start[:, None] + k[None, :], max=records.shape[1] - 1)]
        live = (ref.splat(rec, px, py)[3] > 0) & valid[:, None, :]
        blended += int((live & (k < nc[..., None])).sum())
        first_kill = torch.minimum(first_kill,
                                   torch.where(live & (k >= nc[..., None]), k, big).amin(-1))
    evals = torch.where(first_kill < big, first_kill + 1, count[:, None])
    killed = int((first_kill < big).sum())
    return int(evals.amax(1).sum()), int(evals.sum()), blended + killed, killed


@torch.no_grad()
def backward_work(records, tile_start, tile_count, n_contrib, TW, TH, ts, chunk=32):
    """(walked pairs, evaluations, hits) of the blend backward on this data:
    each tile walks its pairs below its largest n_contrib; a dense walk
    evaluates at each pixel the alpha of the pairs below its own n_contrib,
    and a hit is one whose alpha is > 0 there (a pair it blended)."""
    px, py = ref.tile_pixels(TW, TH, ts, records.device)
    start, nc = tile_start.long(), n_contrib.long()
    n_walk = torch.minimum(nc.amax(1), tile_count.long())
    hits = 0
    for c0 in range(0, int(n_walk.max()), chunk):
        k = c0 + torch.arange(chunk, device=records.device)
        idx = torch.clamp(start[:, None] + k[None, :], max=records.shape[1] - 1)
        alpha = ref.splat(records[:6, idx], px, py)[3]
        hits += int(((alpha > 0) & (k[None, None, :] < nc[..., None])).sum())
    return int(n_walk.sum()), int(nc.sum()), hits


def blend_backward_bound_ms(out: dict) -> float:
    """B2's bound, in ms, for the backward of one reference render `out`."""
    TW, TH, ts = out["grid"]
    walked, _, hits = backward_work(out["records"], out["tile_start"], out["tile_count"],
                                    out["n_contrib"], TW, TH, ts)
    T = TW * TH
    bytes_ = BWD_BYTES_PER_PAIR * walked + BWD_BYTES_PER_PIXEL * T * ts * ts \
        + BWD_BYTES_PER_TILE * T
    return kernel_bound(bytes_, (BWD_INSTR_PER_EVAL + BWD_INSTR_PER_HIT) * hits)[0]


def render_flops(out: dict) -> int:
    """The useful FP32 operations of one differentiated render `out` of the
    reference: B1's and B2's hits and the vertex stage's visible rows."""
    TW, TH, ts = out["grid"]
    args = (out["records"], out["tile_start"], out["tile_count"], out["n_contrib"], TW, TH, ts)
    fwd_hits = forward_work(*args)[2]
    bwd_hits = backward_work(*args)[2]
    return (BLEND_INSTR_PER_EVAL * fwd_hits
            + (BWD_INSTR_PER_EVAL + BWD_INSTR_PER_HIT) * bwd_hits
            + PROJECT_FLOPS * int(out["visible"].sum()))


def iteration_flops(view_render_flops: list, width: int, height: int, active: int,
                    values_per_gaussian: int) -> float:
    """The useful FP32 operations of one binocular iteration, in
    expectation over the views (drawn uniformly): two renders of the view
    (the shifted one counted as its view's), SSIM, the per-pixel losses and
    the warp, and the optimiser over the active gaussians. A blend
    instruction (a multiply, an add or a compare) is one operation."""
    renders = 2 * sum(view_render_flops) / len(view_render_flops)
    pixels = width * height
    return (renders + (SSIM_CONV_FLOPS_PER_PIXEL + PIXEL_FLOPS) * pixels
            + active * (ADAM_FLOPS_PER_VALUE * values_per_gaussian + GAUSSIAN_FLOPS))
