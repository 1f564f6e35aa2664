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
  * one `torch.sort` over int64 `(tile << gbits) | rank` keys. int64 leaves
    room for any capacity and tile count, so the JAX package's split between
    a packed int32 path and a fallback is not needed
  * every slot past the pair capacity or past the emitted pairs gets the
    sentinel key `num_tiles << gbits`, sorting behind all real pairs
  * per-tile [start, count) ranges via a searchsorted of num_tiles queries

`pair_gauss` is in DEPTH-RANK space: callers gather per-gaussian data with
`reordered[pair_gauss]` where `reordered = original[order]`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileBinning(NamedTuple):
    pair_gauss: torch.Tensor  # (P,) int32 depth-rank of the gaussian per sorted pair
    pair_tile: torch.Tensor  # (P,) int32 tile id per sorted pair (num_tiles = invalid)
    tile_start: torch.Tensor  # (T,) int32 first pair index of each tile
    tile_count: torch.Tensor  # (T,) int32 number of pairs of each tile
    num_pairs: torch.Tensor  # () int32 total wanted pairs (before truncation)
    order: torch.Tensor  # (N,) int32 depth order: original index of rank i
    rank_offsets: torch.Tensor  # (N+1,) int32 emission offset per depth rank


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
def bin_gaussians(
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
    key_s, _ = torch.sort(key)
    tile_s = (key_s >> bg).to(torch.int32)
    gauss_s = torch.where(tile_s < num_tiles, key_s & ((1 << bg) - 1), 0).to(torch.int32)

    tile_ids = torch.arange(num_tiles + 1, device=dev, dtype=torch.int32)
    starts = torch.searchsorted(tile_s, tile_ids, out_int32=True)
    return TileBinning(
        pair_gauss=gauss_s,
        pair_tile=tile_s,
        tile_start=starts[:-1].contiguous(),
        tile_count=(starts[1:] - starts[:-1]).contiguous(),
        num_pairs=num_pairs.to(torch.int32),
        order=order.to(torch.int32),
        rank_offsets=torch.cat([cum_end.new_zeros(1), cum_end]).to(torch.int32),
    )
