"""Gaussian preprocessing: projection, EWA splatting covariance, culling, SH color.

Counterpart of `binocular3dgs_tpu/ops/project.py` (the vertex stage of the
CUDA rasterizer's forward preprocess, SURVEY.md §3.5):

  * perspective projection through the row-convention full_proj matrix with
    the 1e-7-guarded homogeneous divide
  * view-space depth cull at z <= znear_cull
  * EWA: cov2d = J W Sigma W^T J^T with the +0.3 pixel dilation and the
    1.3*tan(fov) frustum clamp on the Jacobian linearization point
  * radius = ceil(3 * sqrt(max eigenvalue)), conic = inverse covariance
  * SH -> RGB with the +0.5 shift and clamp at 0
  * the tight opacity-aware binning extents (`bin_extent`)

Component-wise elementwise algebra on (N,) tensors, as the JAX version, so
the two round alike; gradients are plain PyTorch autograd. The optional
`mean2d_carrier` (N, 2) of zeros is added to the pixel centre in NDC
half-extent units, `mean2d + carrier * (0.5 W, 0.5 H)`, as the JAX version
adds it: its gradient is the reference's `means2D.grad`, the densification
statistic, whose 0.0002 threshold is stated in those units. The JAX
package's precomputed-color, precomputed-covariance and scaling-modifier
inputs have no caller here and are not carried.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterConfig
from ..core.camera import Camera
from ..core.sh import eval_sh
from ..models.gaussians import GaussianModel


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor  # (N, 2) pixel coords of the splat center
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor  # (N, 3) RGB after SH evaluation
    opacity: torch.Tensor  # (N,) post-sigmoid opacity
    radius: torch.Tensor  # (N,) float screen radius in pixels (0 => culled)
    visible: torch.Tensor  # (N,) bool
    bin_extent: torch.Tensor  # (N, 2) tight per-axis binning extents (px)


def compute_cov3d(scaling: torch.Tensor, rotation_raw: torch.Tensor):
    """Sigma = (R S)(R S)^T from activated scales and raw quaternions,
    packed as (N, 6): (xx, xy, xz, yy, yz, zz)."""
    q = rotation_raw / torch.linalg.norm(rotation_raw, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R00 = 1 - 2 * (y * y + z * z)
    R01 = 2 * (x * y - r * z)
    R02 = 2 * (x * z + r * y)
    R10 = 2 * (x * y + r * z)
    R11 = 1 - 2 * (x * x + z * z)
    R12 = 2 * (y * z - r * x)
    R20 = 2 * (x * z - r * y)
    R21 = 2 * (y * z + r * x)
    R22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = scaling[..., 0], scaling[..., 1], scaling[..., 2]
    # L = R diag(s); Sigma = L L^T => Sigma_ik = sum_j R_ij R_kj s_j^2
    a0, a1, a2 = s0 * s0, s1 * s1, s2 * s2
    xx = R00 * R00 * a0 + R01 * R01 * a1 + R02 * R02 * a2
    xy = R00 * R10 * a0 + R01 * R11 * a1 + R02 * R12 * a2
    xz = R00 * R20 * a0 + R01 * R21 * a1 + R02 * R22 * a2
    yy = R10 * R10 * a0 + R11 * R11 * a1 + R12 * R12 * a2
    yz = R10 * R20 * a0 + R11 * R21 * a1 + R12 * R22 * a2
    zz = R20 * R20 * a0 + R21 * R21 * a1 + R22 * R22 * a2
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def ewa_cov2d(
    xyz: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    dilation: float = 0.3,
    valid: torch.Tensor | None = None,
):
    """Screen-space 2x2 covariances, (N, 3) packed (xx, xy, yy) after the
    low-pass dilation. `valid` masks rows whose view-space point is usable;
    invalid rows are computed at a safe dummy point so all values stay
    finite."""
    Wm = camera.world_view.T[:3, :3]  # W2C rotation applied to column vectors
    ones = torch.ones_like(xyz[..., :1])
    t = (torch.cat([xyz, ones], dim=-1) @ camera.world_view)[..., :3]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    if valid is not None:  # dummy point (0, 0, 1); scalar fills keep the host unsynced
        tx = torch.where(valid, tx, 0.0)
        ty = torch.where(valid, ty, 0.0)
        tz = torch.where(valid, tz, 1.0)
    fx = camera.focal_x
    fy = camera.focal_y
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    txtz = torch.clamp(tx / tz, -limx, limx) * tz
    tytz = torch.clamp(ty / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J: row 0 = (fx/z, 0, -fx tx/z^2), row 1 = (0, fy/z, -fy ty/z^2)
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2
    T00 = j00 * Wm[0, 0] + j02 * Wm[2, 0]
    T01 = j00 * Wm[0, 1] + j02 * Wm[2, 1]
    T02 = j00 * Wm[0, 2] + j02 * Wm[2, 2]
    T10 = j11 * Wm[1, 0] + j12 * Wm[2, 0]
    T11 = j11 * Wm[1, 1] + j12 * Wm[2, 1]
    T12 = j11 * Wm[1, 2] + j12 * Wm[2, 2]
    cxx, cxy, cxz = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    cyy, cyz, czz = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]
    U00 = T00 * cxx + T01 * cxy + T02 * cxz
    U01 = T00 * cxy + T01 * cyy + T02 * cyz
    U02 = T00 * cxz + T01 * cyz + T02 * czz
    U10 = T10 * cxx + T11 * cxy + T12 * cxz
    U11 = T10 * cxy + T11 * cyy + T12 * cyz
    U12 = T10 * cxz + T11 * cyz + T12 * czz
    xx = U00 * T00 + U01 * T01 + U02 * T02 + dilation
    xy = U10 * T00 + U11 * T01 + U12 * T02
    yy = U10 * T10 + U11 * T11 + U12 * T12 + dilation
    return torch.stack([xx, xy, yy], dim=-1)


def project_gaussians(
    xyz: torch.Tensor,  # (N, 3)
    scaling: torch.Tensor,  # (N, 3) activated (exp'd)
    rotation_raw: torch.Tensor,  # (N, 4)
    opacity: torch.Tensor,  # (N,) activated (sigmoid'd)
    features: torch.Tensor,  # (N, K, 3) SH coeffs, [coeff, channel]
    active: torch.Tensor,  # (N,) bool
    camera: Camera,
    sh_degree: int,
    dilation: float = 0.3,
    znear_cull: float = 0.2,
    mean2d_carrier: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Vectorized vertex stage over the capacity axis."""
    N = xyz.shape[0]
    xyz1 = torch.cat([xyz, xyz.new_ones((N, 1))], dim=-1)

    p_view = xyz1 @ camera.world_view
    depth = p_view[..., 2]
    in_front = depth > znear_cull

    p_hom = xyz1 @ camera.full_proj
    # sanitize the homogeneous divide for culled points (w ~ 0 behind camera)
    w_hom = torch.where(in_front, p_hom[..., 3], 1.0)
    p_w = 1.0 / (w_hom + 1e-7)
    ndc = p_hom[..., :3] * p_w[..., None]

    W, H = camera.width, camera.height
    px = ((ndc[..., 0] + 1.0) * W - 1.0) * 0.5
    py = ((ndc[..., 1] + 1.0) * H - 1.0) * 0.5
    mean2d = torch.stack([px, py], dim=-1)
    if mean2d_carrier is not None:
        mean2d = mean2d + mean2d_carrier * mean2d.new_tensor([0.5 * W, 0.5 * H])

    cov2d = ewa_cov2d(xyz, compute_cov3d(scaling, rotation_raw), camera, dilation, valid=in_front)

    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack(
        [cov2d[..., 2] * inv_det, -cov2d[..., 1] * inv_det, cov2d[..., 0] * inv_det], dim=-1
    )

    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    visible = active & in_front & det_ok
    radius = torch.where(visible, radius, 0.0)

    # Tight per-axis binning extents (lossless, see the JAX docstring at
    # binocular3dgs_tpu/ops/project.py): the axis extent of the
    # alpha >= 1/255 ellipse, +1 px slack for getRect's rounding, capped at
    # the reference radius.
    d_max = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), min=0.0))
    ext = torch.stack(
        [
            torch.minimum(d_max * torch.sqrt(torch.clamp(cov2d[..., 0], min=0.0)) + 1.0, radius),
            torch.minimum(d_max * torch.sqrt(torch.clamp(cov2d[..., 2], min=0.0)) + 1.0, radius),
        ],
        dim=-1,
    )
    bin_extent = torch.where((visible & (d_max > 0.0))[..., None], ext, 0.0)
    # sanitize every per-gaussian output of invisible rows
    mean2d = torch.where(visible[..., None], mean2d, 0.0)
    conic = torch.stack(
        [torch.where(visible, conic[:, i], fill) for i, fill in enumerate((1.0, 0.0, 1.0))], dim=-1
    )
    depth = torch.where(visible, depth, 0.0)
    opacity = torch.where(visible, opacity, 0.0)

    dir_pp = xyz - camera.cam_center
    norm = torch.sqrt(torch.sum(dir_pp * dir_pp, dim=-1, keepdim=True))
    dir_pp = dir_pp / torch.clamp(norm, min=1e-8)
    sh = features.transpose(-1, -2)  # eval_sh wants [..., channel, coeff]
    color = torch.clamp(eval_sh(sh_degree, sh, dir_pp) + 0.5, min=0.0)

    return ProjectedGaussians(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacity,
        radius=radius,
        visible=visible,
        bin_extent=bin_extent,
    )


def project_for_render(
    camera: Camera,
    model: GaussianModel,
    raster: RasterConfig | None = None,
    mean2d_carrier: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """The vertex stage of a render: `model`'s activated parameters through
    `project_gaussians` with the raster config's dilation and cull."""
    raster = raster or RasterConfig()
    return project_gaussians(
        xyz=model.params.xyz,
        scaling=model.get_scaling(),
        rotation_raw=model.params.rotation,
        opacity=model.get_opacity()[..., 0],
        features=model.get_features(),
        active=model.active,
        camera=camera,
        sh_degree=model.active_sh_degree,
        dilation=raster.dilation,
        znear_cull=raster.znear_cull,
        mean2d_carrier=mean2d_carrier,
    )
