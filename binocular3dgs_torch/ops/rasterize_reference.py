"""Dense reference renderer — the golden oracle (tests only).

Counterpart of `binocular3dgs_tpu/ops/rasterize_reference.py`: an
O(pixels * gaussians) front-to-back composite with the exact CUDA
compositing semantics (0.99 alpha clamp, power > 0 and alpha < 1/255 skips,
termination before the pair that would take T below 1e-4, tile-granular
bbox coverage), outputs rgb (+ T_final * bg), unnormalized alpha-weighted
depth and alpha = 1 - T_final.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.camera import Camera
from ..models.gaussians import GaussianModel
from .binning import tile_grid, tile_rect
from .blend_cuda import ALPHA_CLAMP, ALPHA_MIN, T_MIN
from .project import ProjectedGaussians, project_for_render


@dataclass
class RenderOutput:
    image: torch.Tensor  # (3, H, W) planar
    depth: torch.Tensor  # (H, W)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (N,) float; 0 => culled
    visible: torch.Tensor  # (N,) bool (radii > 0)
    # Pair-list pressure (tiled rasterizer only): total wanted pairs before
    # capacity truncation, the largest tile's pair count, and the capacity.
    num_pairs: torch.Tensor | None = None
    max_tile_pairs: torch.Tensor | None = None
    pair_capacity: int | None = None


def blend_dense(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg: torch.Tensor,
    tile_size: int = 16,
):
    """Per-pixel front-to-back composite of all gaussians (dense)."""
    order = torch.argsort(torch.where(proj.visible, proj.depth, torch.inf), stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    color = proj.color[order]
    opacity = torch.where(proj.visible, proj.opacity, 0.0)[order]
    depth = proj.depth[order]
    radius = proj.radius[order]

    dev = mean2d.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    dx = mean2d[None, None, :, 0] - xs[None, :, None]  # (1, W, N)
    dy = mean2d[None, None, :, 1] - ys[:, None, None]  # (H, 1, N)

    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy  # (H, W, N)
    alpha = torch.clamp(opacity * torch.exp(power), max=ALPHA_CLAMP)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)

    TW, TH = tile_grid(width, height, tile_size)
    tmin_x, tmin_y, tmax_x, tmax_y = tile_rect(mean2d, radius, tile_size, TW, TH)
    ptx = (xs.long() // tile_size)[None, :, None]
    pty = (ys.long() // tile_size)[:, None, None]
    covered = (ptx >= tmin_x) & (ptx < tmax_x) & (pty >= tmin_y) & (pty < tmax_y)
    alpha = torch.where(covered, alpha, 0.0)

    # termination: the first gaussian whose inclusion drops T below T_MIN
    # stops blending (itself excluded)
    one_minus = 1.0 - alpha
    T_incl_raw = torch.cumprod(one_minus, dim=-1)
    T_before_raw = torch.cat([torch.ones_like(T_incl_raw[..., :1]), T_incl_raw[..., :-1]], dim=-1)
    killed = torch.cumsum((T_before_raw * one_minus < T_MIN).int(), dim=-1) > 0
    alpha_eff = torch.where(killed, 0.0, alpha)
    T_incl = torch.cumprod(1.0 - alpha_eff, dim=-1)
    T_before = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], dim=-1)
    w = alpha_eff * T_before  # (H, W, N)

    T_final = T_incl[..., -1]
    image = (w[None] * color.T[:, None, None, :]).sum(-1) + T_final[None] * bg[:, None, None]
    depth_out = (w * depth).sum(-1)
    return image, depth_out, 1.0 - T_final


def render_dense(
    camera: Camera,
    model: GaussianModel,
    bg: torch.Tensor,
    mean2d_carrier: torch.Tensor | None = None,
) -> RenderOutput:
    """Full dense render on the model's device; differentiable by plain
    autograd, `mean2d_carrier` included."""
    proj = project_for_render(camera, model, mean2d_carrier=mean2d_carrier)
    image, depth, alpha = blend_dense(proj, camera.width, camera.height, bg)
    return RenderOutput(
        image=image, depth=depth, alpha=alpha, radii=proj.radius, visible=proj.radius > 0
    )
