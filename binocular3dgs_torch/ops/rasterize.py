"""Tiled rasterizer: project -> bin -> gather -> blend -> planes.

Counterpart of `binocular3dgs_tpu/ops/rasterize.py` (`render_tiled`,
`rasterize_projected`) on its record-table path, forward and backward:

  1. vertex stage (ops/project.py)
  2. tile binning (ops/binning.py): gaussians depth-ordered once, pairs
     sorted by (tile, depth rank)
  3. a field-major (10, N) record table, depth-reordered once
     (`fields[:, order]`), then gathered per pair (`fields_d[:, pair_gauss]`)
     into (10, P): each tile's records are one contiguous segment; both by
     `index_select`, whose backward is an `index_add_`
  4. blend (ops/blend_cuda.py): the CUDA kernel reads each tile's exact
     segment, so the pair axis carries no chunk padding
  5. (5, T, S) tile planes -> (5, H, W) image planes, cropped

Gradients: the blend's autograd backward (kernel B2) gives the per-pair
record cotangents; plain autograd of the pair gather and the depth reorder
sums them per gaussian (the VJPs the JAX package writes by hand,
`rasterize.py:124-237`, were XLA, not Pallas); the vertex stage is plain
autograd down to the parameters and the optional `mean2d_carrier`.
Serving callers render under `torch.no_grad()`.

Static capacity: `pair_capacity = pairs_per_gaussian * N`; overflowing
pairs are dropped (the deepest last) and reported by
`RenderOutput.num_pairs`.
"""

from __future__ import annotations

import torch

from .. import resolve_device
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


def _gather_index(binning, num_tiles: int) -> torch.Tensor:
    """The pair gather's column per slot: `pair_gauss`, except that the
    slots past the emitted pairs (sentinel tile, rank 0 in `pair_gauss`)
    take distinct columns. The blend never reads those slots and their
    cotangents are 0, but as one column repeated for every unused slot of
    the capacity they would serialize the gather's backward (an index_add_)
    on that column."""
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
) -> RenderOutput:
    """Render `model` from `camera` on `device` (the model and camera are
    moved there if they live elsewhere); `bg` is an RGB sequence or (3,)
    tensor. Differentiable in the model's parameters and in
    `mean2d_carrier` (N, 2), see ops/project.py. Raises when `device` is
    CUDA and no card is present."""
    device = resolve_device(device)
    camera = camera.to(device)
    model = model.to(device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device)
    proj = project_for_render(camera, model, raster, mean2d_carrier)
    return rasterize_projected(camera, proj, bg, raster)


def rasterize_projected(
    camera: Camera,
    proj: ProjectedGaussians,
    bg: torch.Tensor,
    raster: RasterConfig = _DEFAULT_RASTER,
) -> RenderOutput:
    """Binning, record gather and blend of an already-projected set."""
    W, H = camera.width, camera.height
    ts = raster.tile_size
    TW, TH = tile_grid(W, H, ts)
    N = proj.mean2d.shape[0]
    pair_capacity = raster.pairs_per_gaussian * N

    binning = bin_gaussians(proj.mean2d, proj.bin_extent, proj.depth, W, H, ts, pair_capacity)
    fields_d = torch.index_select(_build_fields(proj), 1, binning.order)
    records = torch.index_select(fields_d, 1, _gather_index(binning, TW * TH))  # (10, P)
    out5, _ = blend_forward(records, binning.tile_start, binning.tile_count, TW, TH, ts)
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
