"""Tile binning: depth-ordered (tile, gaussian) pair emission + one key sort.

Counterpart of `binocular3dgs_tpu/ops/binning.py` with the same contract and
integer outputs:

  * gaussians are depth-ordered once (a stable argsort over N); within a
    tile, ascending gaussian *rank* is ascending depth, so depth drops out of
    the pair key
  * each emitting rank owns the pair slots [rank_offsets[g],
    rank_offsets[g+1]) of its clamped tile rectangle (CUDA getRect), row
    major; a slot finds its rank with one searchsorted over the N-sized
    prefix sums
  * the slots below the pair capacity sorted by (tile, rank); the slots past
    the capacity are dropped (the deepest ranks' last)
  * per-tile [start, count) ranges of the sorted pairs

`bin_gaussians_torch` is the plain version: one `torch.sort` over int64
`(tile << gbits) | rank` keys of every slot of the capacity, the slots past
the emitted pairs given the sentinel key `num_tiles << gbits`, sorting
behind all real pairs, and the tile ranges by a searchsorted of num_tiles
queries. int64 leaves room for any capacity and tile count, so the JAX
package's split between a packed int32 path and a fallback is not needed.
It runs on any device and is what the CPU runs.

`bin_gaussians` runs it on the CPU and, for CUDA tensors, the hand-written
kernels of csrc/binning.cu, which walk the emitted pairs only (a stable
radix sort by tile of the emission order, which is rank-major) and read
their count from the device; on a card it launches them or raises. Their
outputs equal the plain version's on every slot below `bin_slots`; the
card leaves `pair_gauss`, `pair_tile` and `sorted_pos` unwritten from
`bin_slots` on, where the plain version holds its sentinel tail (the
blend reads each tile's segment only).

`pair_gauss` is in DEPTH-RANK space: callers gather per-gaussian data with
`reordered[pair_gauss]` where `reordered = original[order]`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_build import launch

INT32_MAX = 2**31 - 1
SORT_RADIX_BITS = 8  # csrc/binning.cu: one pass of the sort per 8 bits of the tile id
SORT_TILE = 4096  # csrc/binning.cu: pairs per block of the sort


class TileBinning(NamedTuple):
    pair_gauss: torch.Tensor  # (P,) int32 depth-rank of the gaussian per sorted pair
    pair_tile: torch.Tensor  # (P,) int32 tile id per sorted pair (num_tiles = invalid)
    tile_start: torch.Tensor  # (T,) int32 first pair index of each tile
    tile_count: torch.Tensor  # (T,) int32 number of pairs of each tile
    num_pairs: torch.Tensor  # () int32 total wanted pairs (before truncation)
    order: torch.Tensor  # (N,) int32 depth order: original index of rank i
    rank_offsets: torch.Tensor  # (N+1,) int32 emission offset per depth rank (saturated)
    sorted_pos: torch.Tensor  # (P,) int32 sorted position of each emission slot < bin_slots
    bin_slots: torch.Tensor  # () int32 slots sorted and gathered: min(num_pairs, P)
    rank_of: torch.Tensor  # (N,) int32 depth rank of each gaussian (order's inverse)


def tile_grid(width: int, height: int, tile_size: int) -> tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)  # (TW, TH)


def tile_rect(mean2d, radius, tile_size: int, TW: int, TH: int):
    """CUDA getRect: clamped [tmin, tmax) tile bbox per gaussian.

    `radius` is (N,) isotropic or (N, 2) per-axis extents. Returns
    (tmin_x, tmin_y, tmax_x, tmax_y), each (N,) int32. Clamping happens in
    float before the integer conversion, so out-of-range values saturate.
    """
    px, py = mean2d[:, 0], mean2d[:, 1]
    if radius.ndim == 2:
        rx, ry = radius[:, 0], radius[:, 1]
    else:
        rx = ry = radius

    def clip(v, hi):
        return torch.clamp(torch.floor(v), 0, hi).to(torch.int32)

    return (
        clip((px - rx) / tile_size, TW),
        clip((py - ry) / tile_size, TH),
        clip((px + rx + tile_size - 1) / tile_size, TW),
        clip((py + ry + tile_size - 1) / tile_size, TH),
    )


def _bits(n: int) -> int:
    """Bit width needed for values in [0, n]."""
    return max(int(n).bit_length(), 1)


@torch.no_grad()
def bin_gaussians_torch(
    mean2d: torch.Tensor,  # (N, 2) pixel coords
    radius: torch.Tensor,  # (N,) isotropic or (N, 2) per-axis extents; 0 => culled
    depth: torch.Tensor,  # (N,)
    width: int,
    height: int,
    tile_size: int,
    pair_capacity: int,
) -> TileBinning:
    dev = mean2d.device
    TW, TH = tile_grid(width, height, tile_size)
    num_tiles = TW * TH
    n = mean2d.shape[0]
    r_ok = radius.amin(dim=1) > 0 if radius.ndim == 2 else radius > 0

    order = torch.argsort(torch.where(r_ok, depth, torch.inf), stable=True)
    mean2d, radius, r_ok = mean2d[order], radius[order], r_ok[order]

    tmin_x, tmin_y, tmax_x, tmax_y = tile_rect(mean2d, radius, tile_size, TW, TH)
    span_x = torch.clamp(tmax_x - tmin_x, min=0)
    span_y = torch.clamp(tmax_y - tmin_y, min=0)
    count = torch.where(r_ok, span_x.long() * span_y.long(), 0)
    cum_end = torch.cumsum(count, dim=0)  # int64
    num_pairs = cum_end[-1]
    offsets = cum_end - count

    # slot -> emitting rank: the first rank whose segment ends past the slot
    p_idx = torch.arange(pair_capacity, device=dev, dtype=torch.int64)
    valid = p_idx < num_pairs
    g = torch.clamp(torch.searchsorted(cum_end, p_idx, right=True), max=n - 1)
    sx = torch.clamp(span_x[g].long(), min=1)
    j = p_idx - offsets[g]
    tile = (tmin_y[g].long() + j // sx) * TW + tmin_x[g].long() + j % sx

    bg = _bits(n - 1)
    key = torch.where(valid, (tile << bg) | g, num_tiles << bg)
    key_s, perm = torch.sort(key, stable=True)
    tile_s = (key_s >> bg).to(torch.int32)
    gauss_s = torch.where(tile_s < num_tiles, key_s & ((1 << bg) - 1), 0).to(torch.int32)

    tile_ids = torch.arange(num_tiles + 1, device=dev, dtype=torch.int32)
    starts = torch.searchsorted(tile_s, tile_ids, out_int32=True)
    slot = torch.arange(pair_capacity, device=dev, dtype=torch.int32)
    order32 = order.to(torch.int32)
    return TileBinning(
        pair_gauss=gauss_s,
        pair_tile=tile_s,
        tile_start=starts[:-1].contiguous(),
        tile_count=(starts[1:] - starts[:-1]).contiguous(),
        num_pairs=torch.clamp(num_pairs, max=INT32_MAX).to(torch.int32),
        order=order32,
        rank_offsets=torch.clamp(torch.cat([cum_end.new_zeros(1), cum_end]),
                                 max=INT32_MAX).to(torch.int32),
        sorted_pos=torch.empty_like(slot).index_put_((perm,), slot),
        bin_slots=torch.clamp(num_pairs, max=pair_capacity).to(torch.int32),
        rank_of=torch.empty_like(order32).index_put_(
            (order,), torch.arange(n, device=dev, dtype=torch.int32)),
    )


def sort_passes(num_tiles: int) -> int:
    """Passes of csrc/binning.cu's radix sort: 8 bits of the largest tile
    id each."""
    return -(-max(int(num_tiles - 1).bit_length(), 1) // SORT_RADIX_BITS)


def bin_launches(num_tiles: int) -> dict:
    """The kernels csrc/binning.cu launches to bin one render, by name."""
    passes = sort_passes(num_tiles)
    return dict(bin_keys=1, bin_count=1, bin_emit=1, bin_histogram=passes - 1,
                bin_scan=passes, bin_scatter=passes, bin_ranges=1)


def _bin_cuda(mean2d, radius, depth, width, height, tile_size, pair_capacity) -> TileBinning:
    TW, TH = tile_grid(width, height, tile_size)
    T, n, P = TW * TH, mean2d.shape[0], pair_capacity
    cols = 2 if radius.ndim == 2 else 1
    for name, x, shape in (("mean2d", mean2d, (n, 2)), ("radius", radius, (n, cols)[:radius.ndim]),
                           ("depth", depth, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != mean2d.device:
            raise ValueError(f"bin_gaussians: {name} must be {shape} float32 on "
                             f"{mean2d.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if n < 1 or not 1 <= P <= INT32_MAX or T > INT32_MAX // 2:
        raise ValueError(f"bin_gaussians: {n} rows, pair capacity {P}, {T} tiles out of range")
    mean2d, radius, depth = mean2d.contiguous(), radius.contiguous(), depth.contiguous()
    passes = sort_passes(T)
    dev = mean2d.device
    i32 = dict(dtype=torch.int32, device=dev)
    key = torch.empty(n, dtype=torch.float32, device=dev)
    launch("b3dgs_bin_keys", dev, radius, cols, depth, n, key)
    order = torch.argsort(key, stable=True)
    order32, rank_of = torch.empty(n, **i32), torch.empty(n, **i32)
    rect = torch.empty(n, 4, **i32)
    counts = torch.empty(n + 1, dtype=torch.int64, device=dev)
    launch("b3dgs_bin_count", dev, order, mean2d, radius, cols, n, tile_size, TW, TH, order32,
           rank_of, rect, counts)
    offsets = torch.cumsum(counts, 0)
    pair = [torch.empty(P, **i32) for _ in range(3 + 2 * min(passes, 3))]
    pair_tile, pair_gauss, sorted_pos, tile_e, rank_e, *ping_pong = pair
    ping_pong += [None] * (4 - len(ping_pong))  # the sort's key and value buffers a and b
    hist = torch.empty((-(-P // SORT_TILE) + 1) * (1 << SORT_RADIX_BITS), **i32)
    tile_start, tile_count = torch.empty(T, **i32), torch.empty(T, **i32)
    rank_offsets = torch.empty(n + 1, **i32)
    num_pairs, bin_slots = torch.empty((), **i32), torch.empty((), **i32)
    sort_launches = {k: v for k, v in bin_launches(T).items() if k not in ("bin_keys", "bin_count")}
    launch("b3dgs_bin_sort", dev, offsets, rect, n, P, TW, T, passes, tile_e, rank_e, *ping_pong,
           hist, pair_tile, pair_gauss, sorted_pos, tile_start, tile_count, rank_offsets,
           num_pairs, bin_slots, launches=sort_launches)
    return TileBinning(pair_gauss=pair_gauss, pair_tile=pair_tile, tile_start=tile_start,
                       tile_count=tile_count, num_pairs=num_pairs, order=order32,
                       rank_offsets=rank_offsets, sorted_pos=sorted_pos, bin_slots=bin_slots,
                       rank_of=rank_of)


def bin_gaussians(
    mean2d: torch.Tensor,  # (N, 2) pixel coords
    radius: torch.Tensor,  # (N,) isotropic or (N, 2) per-axis extents; 0 => culled
    depth: torch.Tensor,  # (N,)
    width: int,
    height: int,
    tile_size: int,
    pair_capacity: int,
) -> TileBinning:
    """The tile binning of module docstring: csrc/binning.cu's kernels for
    CUDA tensors, `bin_gaussians_torch` for CPU tensors."""
    if mean2d.is_cuda:
        return _bin_cuda(mean2d, radius, depth, width, height, tile_size, pair_capacity)
    if mean2d.device.type == "cpu":
        return bin_gaussians_torch(mean2d, radius, depth, width, height, tile_size,
                                   pair_capacity)
    raise ValueError(f"bin_gaussians: unsupported device {mean2d.device}")
