"""Tiled rasterizer: project -> bin -> gather -> blend -> planes.

Counterpart of `binocular3dgs_tpu/ops/rasterize.py` (`render_tiled`,
`rasterize_projected`) on its record-table path, forward and backward:

  1. vertex stage (ops/project.py)
  2. tile binning (ops/binning.py): gaussians depth-ordered once, pairs
     sorted by (tile, depth rank)
  3. a field-major (10, P) record table of the sorted pairs: each tile's
     records are one contiguous segment (`gather_records`)
  4. blend (ops/blend_cuda.py): the CUDA kernels read each tile's exact
     segment, so the pair axis carries no chunk padding; a long tile's
     segment is walked in chunks, one block each (`blend_plan`)
  5. (5, T, S) tile planes -> (5, H, W) image planes, cropped

Gradients: the blend's autograd backward (kernel B2) gives the per-pair
record cotangents; the record gather's backward sums them per gaussian, as
the JAX package's hand-written VJP does (`rasterize.py:124-237`, XLA, not
Pallas). Autograd's own backward of `index_select` is an `index_add_` whose
float atomics add a gaussian's pairs in another order on every run; here
each gaussian's pair cotangents are summed in a fixed order, so a training
step repeats bit for bit:

  * on the CPU (the plain version) the record table is the fields
    depth-reordered once (`fields[:, order]`) and gathered per pair
    (`fields_d[:, pair_gauss]`), both by `index_select`; the pair gather's
    backward sorts the pairs by gaussian (a stable sort) and sums each
    gaussian's segment in pair order (`segment_sum_columns`), the depth
    reorder keeps autograd's `index_add_` (a permutation adds one term onto
    each zero, which no order changes);
  * on a card one kernel writes the records of the sorted pairs through
    `order[pair_gauss]` and one sums each gaussian's slots in emission order
    straight into the fields' gradients (csrc/binning.cu): the same float
    additions in the same order, over the emitted pairs only.

The vertex stage's gradient down to the parameters and the optional
`mean2d_carrier` is plain autograd on the CPU and its own backward kernel
on a card (ops/project.py).
Serving callers render under `torch.no_grad()`.

Static capacity: `pair_capacity = pairs_per_gaussian * N`; overflowing
pairs are dropped (the deepest last) and reported by
`RenderOutput.num_pairs`.

Band mode (`tile_row_start`, `tile_rows`; JAX `ops/rasterize.py:308-414`):
only the tile rows [tile_row_start, tile_row_start + tile_rows) are binned
and blended, the unit of parallel/sharding.py's split. The splat centres are
shifted by `tile_row_start * tile_size` pixels before binning, so binning
and the blend kernels work in band-local coordinates unchanged; the shift is
a constant, so the carrier's gradient is that of the full render. The band
comes back uncropped, `tile_rows * tile_size` pixel rows high.
"""

from __future__ import annotations

import torch

from .. import resolve_device, tracing
from ..config import RasterConfig
from ..core.camera import Camera
from ..models.gaussians import GaussianModel
from .binning import TileBinning, bin_gaussians, tile_grid
from .blend_cuda import blend_forward, blend_plan
from .cuda_build import launch
from .project import ProjectedGaussians, project_for_render
from .rasterize_reference import RenderOutput

_DEFAULT_RASTER = RasterConfig()


def _build_fields(proj: ProjectedGaussians) -> torch.Tensor:
    """Field-major (10, N) record table in the blend's row layout."""
    return torch.stack(
        [
            proj.mean2d[:, 0],
            proj.mean2d[:, 1],
            proj.conic[:, 0],
            proj.conic[:, 1],
            proj.conic[:, 2],
            proj.opacity,
            proj.color[:, 0],
            proj.color[:, 1],
            proj.color[:, 2],
            proj.depth,
        ],
        dim=0,
    )


class _GatherRecords(torch.autograd.Function):
    """fields_d[:, index] (10, P), the plain version; the backward sums each
    column's cotangents in a fixed order: the pairs stably sorted by
    column, then one segment sum per column in pair order
    (`torch.segment_reduce` adds each segment sequentially)."""

    @staticmethod
    def forward(ctx, fields_d, index):
        ctx.save_for_backward(index)
        ctx.n = fields_d.shape[1]
        return torch.index_select(fields_d, 1, index)

    @staticmethod
    @tracing.region("render.gather.backward")
    def backward(ctx, d_records):
        (index,) = ctx.saved_tensors
        return segment_sum_columns(d_records, index, ctx.n), None


def segment_sum_columns(d: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """(K, n) sums of the columns of `d` (K, P) that `index` (P,) names, each
    column's terms added in ascending pair order: the same bits on every
    run, on the card and on the CPU."""
    sorted_index, perm = torch.sort(index, stable=True)
    # each column's segment bounds, without a host sync (bincount has one)
    offsets = torch.searchsorted(
        sorted_index, torch.arange(n + 1, device=index.device, dtype=index.dtype))
    rows = torch.index_select(d.T, 0, perm)  # (P, K), grouped by column
    return torch.segment_reduce(rows, "sum", offsets=offsets, axis=0, unsafe=True).T


def gather_backward(d_records: torch.Tensor, binning: TileBinning) -> tuple:
    """The gradients (mean2d, conic, opacity, color, depth) of the card's
    record gather from the cotangent `d_records` (10, P): the sorted pairs'
    cotangents made one record a pair, then each gaussian's slots from
    `rank_offsets[g]` to `min(rank_offsets[g + 1], P)`, read at their
    `sorted_pos`, summed in ascending slot order from 0 (the sums of
    `segment_sum_columns` over the plain version's gather, bit for bit).
    CUDA tensors only."""
    d_records = d_records.contiguous()
    P, n = d_records.shape[1], binning.order.shape[0]
    if d_records.shape[0] != 10 or P != binning.sorted_pos.shape[0]:
        raise ValueError(f"gather_backward: d_records must be (10, {binning.sorted_pos.shape[0]})"
                         f", got {tuple(d_records.shape)}")
    new = d_records.new_empty
    grads = (new((n, 2)), new((n, 3)), new((n,)), new((n, 3)), new((n,)))
    by_pair = new((P, 12))  # a 48-byte record a sorted pair, the first bin_slots written
    launch("b3dgs_gather_backward", d_records.device, d_records, P, binning.sorted_pos,
           binning.bin_slots, binning.rank_offsets, binning.rank_of, n, by_pair, *grads,
           launches={"gather_transpose": 1, "gather_backward": 1})
    return grads


class _GatherPairs(torch.autograd.Function):
    """The card's record gather: (10, P) records of the sorted pairs from
    the projected fields, their first `bin_slots` columns written by one
    kernel (csrc/binning.cu), and `gather_backward`."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, binning):
        P, n = binning.pair_gauss.shape[0], binning.order.shape[0]
        fields = [x.contiguous() for x in (mean2d, conic, opacity, color, depth)]
        for x, shape in zip(fields, ((n, 2), (n, 3), (n,), (n, 3), (n,))):
            if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_cuda:
                raise ValueError(f"gather_records: a field must be {shape} float32 on a card, "
                                 f"got {tuple(x.shape)} {x.dtype} on {x.device}")
        records = fields[0].new_empty((10, P))
        launch("b3dgs_gather_forward", records.device, *fields, binning.order,
               binning.pair_gauss, binning.bin_slots, P, records)
        ctx.binning = binning
        return records

    @staticmethod
    @tracing.region("render.gather.backward")
    def backward(ctx, d_records):
        grads = gather_backward(d_records, ctx.binning)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def gather_records(proj: ProjectedGaussians, binning: TileBinning) -> torch.Tensor:
    """(10, P) records of the sorted pairs in the blend's row layout,
    differentiable in the projected fields: on the CPU `_build_fields`
    depth-reordered and gathered by `pair_gauss` (`_GatherRecords`), on a
    card `_GatherPairs`, which writes the first `bin_slots` columns only."""
    if proj.mean2d.is_cuda:
        return _GatherPairs.apply(proj.mean2d, proj.conic, proj.opacity, proj.color, proj.depth,
                                  binning)
    if proj.mean2d.device.type != "cpu":
        raise ValueError(f"gather_records: unsupported device {proj.mean2d.device}")
    fields_d = torch.index_select(_build_fields(proj), 1, binning.order)
    return _GatherRecords.apply(fields_d, binning.pair_gauss)


def _tiles_to_planes(tiles: torch.Tensor, TW: int, TH: int, ts: int, H: int, W: int):
    """(K, T, S) per-tile channel planes -> (K, H, W) planar image crop."""
    K = tiles.shape[0]
    x = tiles.reshape(K, TH, TW, ts, ts).permute(0, 1, 3, 2, 4).reshape(K, TH * ts, TW * ts)
    return x[:, :H, :W]


def render_tiled(
    camera: Camera,
    model: GaussianModel,
    bg,
    raster: RasterConfig = _DEFAULT_RASTER,
    device: str | torch.device = "cuda",
    mean2d_carrier: torch.Tensor | None = None,
    tile_row_start: int = 0,
    tile_rows: int | None = None,
) -> RenderOutput:
    """Render `model` from `camera` on `device` (the model and camera are
    moved there if they live elsewhere); `bg` is an RGB sequence or (3,)
    tensor. Differentiable in the model's parameters and in
    `mean2d_carrier` (N, 2), see ops/project.py. Raises when `device` is
    CUDA and no card is present. With `tile_rows`, renders only that band
    of tile rows from `tile_row_start` (module docstring)."""
    device = resolve_device(device)
    camera = camera.to(device)
    model = model.to(device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device)
    with tracing.region("render.project"):
        proj = project_for_render(camera, model, raster, mean2d_carrier)
    return rasterize_projected(camera, proj, bg, raster, tile_row_start, tile_rows)


def rasterize_projected(
    camera: Camera,
    proj: ProjectedGaussians,
    bg: torch.Tensor,
    raster: RasterConfig = _DEFAULT_RASTER,
    tile_row_start: int = 0,
    tile_rows: int | None = None,
) -> RenderOutput:
    """Binning, record gather and blend of an already-projected set (of
    the band `tile_rows` from `tile_row_start` when `tile_rows` is given)."""
    W, H = camera.width, camera.height
    ts = raster.tile_size
    TW, TH = tile_grid(W, H, ts)
    N = proj.mean2d.shape[0]
    pair_capacity = raster.pairs_per_gaussian * N
    if tile_rows is not None:
        TH, H = tile_rows, tile_rows * ts
        shift = torch.tensor([0.0, float(tile_row_start * ts)], device=proj.mean2d.device)
        proj = proj._replace(mean2d=proj.mean2d - shift)

    with tracing.region("render.bin"):
        binning = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts,
                                pair_capacity)
    tracing.count("render.rows", N)
    tracing.count("render.pairs_wanted", binning.num_pairs)
    tracing.count("render.pair_capacity", pair_capacity)
    # the slots the sort and the gather walk: the emitted ones on a card,
    # the whole capacity in the plain version
    tracing.count("render.bin_slots", binning.bin_slots if proj.mean2d.is_cuda else pair_capacity)
    with tracing.region("render.gather"):
        records = gather_records(proj, binning)  # (10, P)
    with tracing.region("render.blend"):
        plan = None
        if records.is_cuda:  # the kernels' work items: tiles, long ones in chunks
            plan = blend_plan(binning.tile_count, records.shape[1])
            tracing.count("render.blend_chunks", plan.chunks)
            tracing.count("render.blend_longest_walk", plan.longest_walk)
        out5, _ = blend_forward(records, binning.tile_start, binning.tile_count, TW, TH, ts, plan)
    with tracing.region("render.planes"):
        planes = _tiles_to_planes(out5, TW, TH, ts, H, W)
        rgb, dep, T_final = planes[0:3], planes[3], planes[4]
        return RenderOutput(
            image=rgb + T_final[None] * bg[:, None, None],
            depth=dep,
            alpha=1.0 - T_final,
            radii=proj.radius,
            visible=proj.radius > 0,
            num_pairs=binning.num_pairs,
            max_tile_pairs=binning.tile_count.max(),
            pair_capacity=pair_capacity,
        )
