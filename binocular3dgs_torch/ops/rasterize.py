"""Tiled rasterizer: project -> bin -> gather -> blend -> planes.

Counterpart of `binocular3dgs_tpu/ops/rasterize.py` (`render_tiled`,
`rasterize_projected`) on its record-table path, forward and backward:

  1. vertex stage (ops/project.py)
  2. tile binning (ops/binning.py): gaussians depth-ordered once, pairs
     sorted by (tile, depth rank)
  3. a field-major (10, N) record table, depth-reordered once
     (`fields[:, order]`), then gathered per pair (`fields_d[:, pair_gauss]`)
     into (10, P): each tile's records are one contiguous segment; both by
     `index_select`, the pair gather with a backward that adds in a fixed
     order
  4. blend (ops/blend_cuda.py): the CUDA kernel reads each tile's exact
     segment, so the pair axis carries no chunk padding
  5. (5, T, S) tile planes -> (5, H, W) image planes, cropped

Gradients: the blend's autograd backward (kernel B2) gives the per-pair
record cotangents; the pair gather's backward sums them per gaussian, as
the JAX package's hand-written VJP does (`rasterize.py:124-237`, XLA, not
Pallas). Autograd's own backward of `index_select` is an `index_add_` whose
float atomics add a gaussian's pairs in another order on every run; here
the pairs are sorted by gaussian (a stable sort) and each gaussian's
segment is summed in pair order, so a training step repeats bit for bit.
The depth reorder keeps autograd's `index_add_`: a permutation adds one
term onto each zero, which no order changes.
The vertex stage is plain autograd down to the parameters and the optional
`mean2d_carrier`.
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
from .binning import bin_gaussians, tile_grid
from .blend_cuda import blend_forward
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
    """fields_d[:, index] (10, P); the backward sums each column's
    cotangents in a fixed order: the pairs stably sorted by column, then one
    segment sum per column in pair order (`torch.segment_reduce` adds each
    segment sequentially)."""

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


def _gather_index(binning, num_tiles: int) -> torch.Tensor:
    """The pair gather's column per slot: `pair_gauss`, except that the
    slots past the emitted pairs (sentinel tile, rank 0 in `pair_gauss`)
    take distinct columns. The blend never reads those slots and their
    cotangents are 0, but as one column repeated for every unused slot of
    the capacity they would make that column's segment in the gather's
    backward as long as the capacity's unused tail."""
    P = binning.pair_gauss.shape[0]
    spread = torch.arange(P, device=binning.pair_gauss.device, dtype=torch.int32)
    spread = spread % binning.order.shape[0]
    return torch.where(binning.pair_tile < num_tiles, binning.pair_gauss, spread)


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
    with tracing.region("render.gather"):
        fields_d = torch.index_select(_build_fields(proj), 1, binning.order)
        records = _GatherRecords.apply(fields_d, _gather_index(binning, TW * TH))  # (10, P)
    with tracing.region("render.blend"):
        out5, _ = blend_forward(records, binning.tile_start, binning.tile_count, TW, TH, ts)
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
