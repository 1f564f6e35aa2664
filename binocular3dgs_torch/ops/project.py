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

`project_gaussians` is the plain version: component-wise elementwise
algebra on (N,) tensors, as the JAX version, so the two round alike, with
gradients by plain autograd. The optional `mean2d_carrier` (N, 2) of zeros
is added to the pixel centre in NDC half-extent units,
`mean2d + carrier * (0.5 W, 0.5 H)`, as the JAX version adds it: its
gradient is the reference's `means2D.grad`, the densification statistic,
whose 0.0002 threshold is stated in those units. The JAX package's
precomputed-color, precomputed-covariance and scaling-modifier inputs have
no caller here and are not carried.

`project_for_render` runs `project_gaussians` for a model on the CPU and,
for a model on a card, one `torch.autograd.Function` whose forward and
backward are each one hand-written CUDA kernel over the raw leaves
(csrc/project.cu: `project_forward`, `project_backward`; one thread per
row, exp, sigmoid and the quaternion's normalisation inside); on a card it
launches them or raises. `project_backward_torch` is the backward kernel's
formulas row for row in torch ops, held against autograd of
`project_gaussians` by the CPU tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..config import RasterConfig
from ..core.camera import Camera
from ..core.sh import C0, C1, C2, C3, eval_sh, num_sh_coeffs
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


# -- the vertex stage on a card: csrc/project.cu ----------------------------

_LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
_CAMERA = ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy")


def _kernel_inputs(name, leaves, active, camera, sh_degree):
    """The leaves (xyz, f_dc, f_rest, opacity, scaling, rotation: raw,
    float32, rows on one card), `active` and the camera's five tensors,
    checked and made contiguous, and f_rest's coefficient count."""
    xyz = leaves[0]
    if not xyz.is_cuda:
        raise ValueError(f"{name}: the kernel runs on a CUDA device, got {xyz.device}")
    n = xyz.shape[0]
    shapes = ((n, 3), (n, 1, 3), None, (n, 1), (n, 3), (n, 4))
    for leaf, key, shape in zip(leaves, _LEAVES, shapes):
        if leaf.dtype != torch.float32 or leaf.device != xyz.device:
            raise ValueError(f"{name}: {key} must be float32 on {xyz.device}, got "
                             f"{leaf.dtype} on {leaf.device}")
        if shape is not None and tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {tuple(leaf.shape)}")
    if leaves[2].dim() != 3 or leaves[2].shape[0] != n or leaves[2].shape[2] != 3:
        raise ValueError(f"{name}: f_rest must be ({n}, K, 3), got {tuple(leaves[2].shape)}")
    k_rest = leaves[2].shape[1]
    if not 0 <= sh_degree <= 3 or num_sh_coeffs(sh_degree) > 1 + k_rest:
        raise ValueError(f"{name}: SH degree {sh_degree} with {1 + k_rest} coefficients")
    if active.dtype != torch.bool or tuple(active.shape) != (n,) or active.device != xyz.device:
        raise ValueError(f"{name}: active must be ({n},) bool on {xyz.device}")
    cam = [getattr(camera, k).contiguous() for k in _CAMERA]
    for k, t, numel in zip(_CAMERA, cam, (16, 16, 3, 1, 1)):
        if t.dtype != torch.float32 or t.device != xyz.device or t.numel() != numel:
            raise ValueError(f"{name}: camera.{k} must be {numel} float32 values on "
                             f"{xyz.device}, got {t.numel()} {t.dtype} on {t.device}")
    return [x.contiguous() for x in leaves], active.contiguous(), cam, k_rest


def project_forward(xyz, f_dc, f_rest, opacity, scaling, rotation, active, camera: Camera,
                    sh_degree: int, dilation: float, znear_cull: float,
                    mean2d_carrier: torch.Tensor | None = None) -> ProjectedGaussians:
    """The forward kernel on raw leaves: `project_gaussians` of
    exp(scaling), sigmoid(opacity) and the concatenated features, every
    field of `ProjectedGaussians` in one launch. CUDA tensors only."""
    from .cuda_build import load_library

    leaves, active, cam, k_rest = _kernel_inputs(
        "project_forward", (xyz, f_dc, f_rest, opacity, scaling, rotation), active, camera,
        sh_degree)
    n = leaves[0].shape[0]
    carrier = None
    if mean2d_carrier is not None:
        if (mean2d_carrier.dtype != torch.float32 or tuple(mean2d_carrier.shape) != (n, 2)
                or mean2d_carrier.device != leaves[0].device):
            raise ValueError(f"project_forward: mean2d_carrier must be ({n}, 2) float32 on "
                             f"{leaves[0].device}")
        carrier = mean2d_carrier.contiguous()
    new = leaves[0].new_empty
    out = ProjectedGaussians(
        mean2d=new((n, 2)), depth=new((n,)), conic=new((n, 3)), color=new((n, 3)),
        opacity=new((n,)), radius=new((n,)),
        visible=torch.empty(n, dtype=torch.bool, device=leaves[0].device),
        bin_extent=new((n, 2)))
    lib = load_library()
    with torch.cuda.device(leaves[0].device):
        err = lib.b3dgs_project_forward(
            *(x.data_ptr() for x in leaves), active.data_ptr(),
            None if carrier is None else carrier.data_ptr(), *(t.data_ptr() for t in cam),
            n, k_rest, sh_degree, camera.width, camera.height, dilation, znear_cull,
            *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"project_forward kernel launch failed: cudaError {err}")
    tracing.launched("project_forward")
    return out


def project_backward(xyz, f_dc, f_rest, opacity, scaling, rotation, active, camera: Camera,
                     sh_degree: int, dilation: float, znear_cull: float, g_mean2d, g_depth,
                     g_conic, g_color, g_opacity, with_carrier: bool):
    """The backward kernel: the gradients (xyz, f_dc, f_rest, opacity,
    scaling, rotation, carrier) of the raw leaves and of the carrier (None
    without `with_carrier`) from the cotangents of mean2d, depth, conic,
    color and opacity (each None for zeros). CUDA tensors only."""
    from .cuda_build import load_library

    leaves, active, cam, k_rest = _kernel_inputs(
        "project_backward", (xyz, f_dc, f_rest, opacity, scaling, rotation), active, camera,
        sh_degree)
    n = leaves[0].shape[0]
    cots = []
    for key, g, shape in (("mean2d", g_mean2d, (n, 2)), ("depth", g_depth, (n,)),
                          ("conic", g_conic, (n, 3)), ("color", g_color, (n, 3)),
                          ("opacity", g_opacity, (n,))):
        if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != shape
                              or g.device != leaves[0].device):
            raise ValueError(f"project_backward: the cotangent of {key} must be {shape} "
                             f"float32 on {leaves[0].device}")
        cots.append(None if g is None else g.contiguous())
    grads = [torch.empty_like(x) for x in leaves]
    d_carrier = leaves[0].new_empty((n, 2)) if with_carrier else None
    lib = load_library()
    with torch.cuda.device(leaves[0].device):
        err = lib.b3dgs_project_backward(
            *(x.data_ptr() for x in leaves), active.data_ptr(), *(t.data_ptr() for t in cam),
            n, k_rest, sh_degree, camera.width, camera.height, dilation, znear_cull,
            *(None if g is None else g.data_ptr() for g in cots),
            *(g.data_ptr() for g in grads), None if d_carrier is None else d_carrier.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"project_backward kernel launch failed: cudaError {err}")
    tracing.launched("project_backward")
    return (*grads, d_carrier)


class _Project(torch.autograd.Function):
    """The vertex stage on a card: `project_forward` forward,
    `project_backward` backward; radius, visible and bin_extent carry no
    gradient (binning reads them as integers)."""

    @staticmethod
    def forward(ctx, xyz, f_dc, f_rest, opacity, scaling, rotation, carrier, active, camera,
                sh_degree, dilation, znear_cull):
        out = project_forward(xyz, f_dc, f_rest, opacity, scaling, rotation, active, camera,
                              sh_degree, dilation, znear_cull, carrier)
        ctx.save_for_backward(xyz, f_dc, f_rest, opacity, scaling, rotation, active)
        ctx.camera, ctx.statics = camera, (sh_degree, dilation, znear_cull)
        ctx.with_carrier = carrier is not None
        ctx.mark_non_differentiable(out.radius, out.visible, out.bin_extent)
        ctx.set_materialize_grads(False)  # None cotangents reach the kernel as null
        return tuple(out)

    @staticmethod
    @tracing.region("render.project.backward")
    def backward(ctx, g_mean2d, g_depth, g_conic, g_color, g_opacity, *_):
        *saved, active = ctx.saved_tensors
        grads = project_backward(*saved, active, ctx.camera, *ctx.statics, g_mean2d, g_depth,
                                 g_conic, g_color, g_opacity,
                                 ctx.with_carrier and ctx.needs_input_grad[6])
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None, None, None, None)


# -- the backward kernel's formulas in torch ops -----------------------------


def _geometry_rows(xyz, scaling_raw, rotation, camera: Camera, dilation, znear_cull):
    """csrc/project.cu:geometry on (N,) columns in its order of operations:
    every intermediate the outputs and the gradient need. The camera
    products are matrix products here, which the kernel rounds as cuBLAS
    does on the card."""
    V = camera.world_view
    xyz1 = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    g = {}
    g["pv"] = list((xyz1 @ V)[:, :3].unbind(-1))
    ph = xyz1 @ camera.full_proj
    g["ph0"], g["ph1"], g["ph3"] = ph[:, 0], ph[:, 1], ph[:, 3]
    g["in_front"] = in_front = g["pv"][2] > znear_cull
    g["pw"] = 1.0 / (torch.where(in_front, g["ph3"], 1.0) + 1e-7)

    r = rotation.unbind(-1)
    g["qn"] = torch.sqrt((r[0] * r[0] + r[2] * r[2]) + (r[1] * r[1] + r[3] * r[3]))
    g["q"] = q = [c / g["qn"] for c in r]
    qr, qx, qy, qz = q
    g["R"] = R = [
        1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qr * qz), 2.0 * (qx * qz + qr * qy),
        2.0 * (qx * qy + qr * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qr * qx),
        2.0 * (qx * qz - qr * qy), 2.0 * (qy * qz + qr * qx), 1.0 - 2.0 * (qx * qx + qy * qy)]
    g["s"] = s = [torch.exp(c) for c in scaling_raw.unbind(-1)]
    g["a"] = a = [c * c for c in s]

    def sig(i, k):
        return ((R[3 * i] * R[3 * k]) * a[0] + (R[3 * i + 1] * R[3 * k + 1]) * a[1]) \
            + (R[3 * i + 2] * R[3 * k + 2]) * a[2]

    g["S"] = S = [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)]

    g["tx"] = torch.where(in_front, g["pv"][0], 0.0)
    g["ty"] = torch.where(in_front, g["pv"][1], 0.0)
    g["tz"] = tz = torch.where(in_front, g["pv"][2], 1.0)
    g["fx"] = (1.0 / (2.0 * camera.tanfovx)) * camera.width
    g["fy"] = (1.0 / (2.0 * camera.tanfovy)) * camera.height
    g["limx"], g["limy"] = 1.3 * camera.tanfovx, 1.3 * camera.tanfovy
    g["ux"], g["uy"] = g["tx"] / tz, g["ty"] / tz
    g["cux"] = torch.clamp(g["ux"], -g["limx"], g["limx"])
    g["cuy"] = torch.clamp(g["uy"], -g["limy"], g["limy"])
    g["inv_z"] = 1.0 / tz
    g["inv_z2"] = g["inv_z"] * g["inv_z"]
    j00 = g["fx"] * g["inv_z"]
    j02 = (-g["fx"] * (g["cux"] * tz)) * g["inv_z2"]
    j11 = g["fy"] * g["inv_z"]
    j12 = (-g["fy"] * (g["cuy"] * tz)) * g["inv_z2"]
    g["T"] = T = ([j00 * V[j, 0] + j02 * V[j, 2] for j in range(3)]
                  + [j11 * V[j, 1] + j12 * V[j, 2] for j in range(3)])
    g["U"] = U = []
    for row in (T[:3], T[3:]):
        U += [(row[0] * S[0] + row[1] * S[1]) + row[2] * S[2],
              (row[0] * S[1] + row[1] * S[3]) + row[2] * S[4],
              (row[0] * S[2] + row[1] * S[4]) + row[2] * S[5]]
    g["xx"] = ((U[0] * T[0] + U[1] * T[1]) + U[2] * T[2]) + dilation
    g["xy"] = (U[3] * T[0] + U[4] * T[1]) + U[5] * T[2]
    g["yy"] = ((U[3] * T[3] + U[4] * T[4]) + U[5] * T[5]) + dilation
    g["det"] = g["xx"] * g["yy"] - g["xy"] * g["xy"]
    g["det_ok"] = g["det"] > 0.0
    g["inv_det"] = 1.0 / torch.where(g["det_ok"], g["det"], 1.0)
    return g


def _sh_basis(deg, x, y, z):
    """csrc/project.cu:sh_basis: the SH basis terms b_k at the unit
    direction, each in `eval_sh`'s order of operations."""
    b = [torch.full_like(x, C0)]
    if deg > 0:
        b += [-(C1 * y), C1 * z, -(C1 * x)]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [C2[0] * xy, C2[1] * yz, C2[2] * ((2.0 * zz - xx) - yy), C2[3] * xz,
              C2[4] * (xx - yy)]
        if deg > 2:
            b += [(C3[0] * y) * (3.0 * xx - yy), (C3[1] * xy) * z,
                  (C3[2] * y) * ((4.0 * zz - xx) - yy),
                  (C3[3] * z) * ((2.0 * zz - 3.0 * xx) - 3.0 * yy),
                  (C3[4] * x) * ((4.0 * zz - xx) - yy), (C3[5] * z) * (xx - yy),
                  (C3[6] * x) * (xx - 3.0 * yy)]
    return b


def _sh_dir_grad(deg, x, y, z, G):
    """csrc/project.cu:sh_dir_grad: d(sum_k G_k b_k) / d(x, y, z)."""
    gx = gy = gz = torch.zeros_like(x)
    if deg > 0:
        gy, gz, gx = gy + G[1] * -C1, gz + G[2] * C1, gx + G[3] * -C1
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        gx, gy = gx + G[4] * (C2[0] * y), gy + G[4] * (C2[0] * x)
        gy, gz = gy + G[5] * (C2[1] * z), gz + G[5] * (C2[1] * y)
        gx, gy = gx + G[6] * ((-2.0 * C2[2]) * x), gy + G[6] * ((-2.0 * C2[2]) * y)
        gz = gz + G[6] * ((4.0 * C2[2]) * z)
        gx, gz = gx + G[7] * (C2[3] * z), gz + G[7] * (C2[3] * x)
        gx, gy = gx + G[8] * ((2.0 * C2[4]) * x), gy + G[8] * ((-2.0 * C2[4]) * y)
        if deg > 2:
            gx = gx + G[9] * ((6.0 * C3[0]) * xy)
            gy = gy + G[9] * (C3[0] * (3.0 * xx - 3.0 * yy))
            gx, gy, gz = (gx + G[10] * (C3[1] * yz), gy + G[10] * (C3[1] * xz),
                          gz + G[10] * (C3[1] * xy))
            gx = gx + G[11] * ((-2.0 * C3[2]) * xy)
            gy = gy + G[11] * (C3[2] * ((4.0 * zz - xx) - 3.0 * yy))
            gz = gz + G[11] * ((8.0 * C3[2]) * yz)
            gx = gx + G[12] * ((-6.0 * C3[3]) * xz)
            gy = gy + G[12] * ((-6.0 * C3[3]) * yz)
            gz = gz + G[12] * (C3[3] * ((6.0 * zz - 3.0 * xx) - 3.0 * yy))
            gx = gx + G[13] * (C3[4] * ((4.0 * zz - 3.0 * xx) - yy))
            gy = gy + G[13] * ((-2.0 * C3[4]) * xy)
            gz = gz + G[13] * ((8.0 * C3[4]) * xz)
            gx = gx + G[14] * ((2.0 * C3[5]) * xz)
            gy = gy + G[14] * ((-2.0 * C3[5]) * yz)
            gz = gz + G[14] * (C3[5] * (xx - yy))
            gx = gx + G[15] * (C3[6] * (3.0 * xx - 3.0 * yy))
            gy = gy + G[15] * ((-6.0 * C3[6]) * xy)
    return gx, gy, gz


@torch.no_grad()
def project_backward_torch(xyz, f_dc, f_rest, opacity, scaling, rotation, active,
                           camera: Camera, sh_degree: int, dilation: float, znear_cull: float,
                           g_mean2d, g_depth, g_conic, g_color, g_opacity, with_carrier: bool):
    """Plain `project_backward`: the backward kernel's formulas row for row
    (csrc/project.cu:project_backward_kernel), in the dtype of the leaves.
    The same arguments and results: the raw leaves' gradients and the
    carrier's (None without `with_carrier`); a None cotangent is zeros."""
    n = xyz.shape[0]
    zeros = xyz.new_zeros
    g_mean2d = zeros((n, 2)) if g_mean2d is None else g_mean2d
    g_depth = zeros((n,)) if g_depth is None else g_depth
    g_conic = zeros((n, 3)) if g_conic is None else g_conic
    g_color = zeros((n, 3)) if g_color is None else g_color
    g_opacity = zeros((n,)) if g_opacity is None else g_opacity
    W, H = camera.width, camera.height
    g = _geometry_rows(xyz, scaling, rotation, camera, dilation, znear_cull)
    visible = active & g["in_front"] & g["det_ok"]
    gmx, gmy = (torch.where(visible, c, 0.0) for c in g_mean2d.unbind(-1))
    gdep = torch.where(visible, g_depth, 0.0)
    gc0, gc1, gc2 = (torch.where(visible, c, 0.0) for c in g_conic.unbind(-1))
    gop = torch.where(visible, g_opacity, 0.0)

    o = 1.0 / (1.0 + torch.exp(-opacity[:, 0]))
    d_opacity = ((gop * (1.0 - o)) * o)[:, None]
    d_carrier = torch.stack([gmx * (0.5 * W), gmy * (0.5 * H)], -1) if with_carrier else None

    # colour
    d = [xyz[:, j] - camera.cam_center[j] for j in range(3)]
    norm = torch.sqrt((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1])
    cn = torch.clamp(norm, min=1e-8)
    u = [c / cn for c in d]
    b = _sh_basis(sh_degree, *u)
    f = torch.cat([f_dc, f_rest], 1)
    gs = []
    for ch in range(3):
        acc = b[0] * f[:, 0, ch]
        for k in range(1, len(b)):
            acc = acc + b[k] * f[:, k, ch]
        gs.append(torch.where(acc + 0.5 >= 0.0, g_color[:, ch], 0.0))
    d_f = torch.zeros_like(f)
    for k in range(len(b)):
        d_f[:, k] = torch.stack([gs[ch] * b[k] for ch in range(3)], -1)
    G = [(gs[0] * f[:, k, 0] + gs[1] * f[:, k, 1]) + gs[2] * f[:, k, 2] for k in range(len(b))]
    gu = _sh_dir_grad(sh_degree, *u, G)
    gx = [c / cn for c in gu]
    gcn = -(((gu[0] * d[0] + gu[1] * d[1]) + gu[2] * d[2]) / (cn * cn))
    gss = torch.where(norm >= 1e-8, gcn, 0.0) / (2.0 * norm)
    gx = [gx[j] + (2.0 * d[j]) * gss for j in range(3)]

    # conic, cov2d
    inv_det, xx, xy, yy = g["inv_det"], g["xx"], g["xy"], g["yy"]
    gxx, gyy, gxy = gc2 * inv_det, gc0 * inv_det, -(gc1 * inv_det)
    ginv = (gc0 * yy + gc1 * -xy) + gc2 * xx
    gdet = torch.where(g["det_ok"], -(ginv * (inv_det * inv_det)), 0.0)
    gxx, gyy, gxy = gxx + gdet * yy, gyy + gdet * xx, gxy - 2.0 * (gdet * xy)
    T, U, S = g["T"], g["U"], g["S"]
    gU = [gxx * T[j] for j in range(3)] + [gxy * T[j] + gyy * T[3 + j] for j in range(3)]
    sym = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    gT = ([(gxx * U[j] + gxy * U[3 + j])
           + ((gU[0] * S[sym[j][0]] + gU[1] * S[sym[j][1]]) + gU[2] * S[sym[j][2]])
           for j in range(3)]
          + [gyy * U[3 + j]
             + ((gU[3] * S[sym[j][0]] + gU[4] * S[sym[j][1]]) + gU[5] * S[sym[j][2]])
             for j in range(3)])
    gS = [gU[0] * T[0] + gU[3] * T[3],
          (gU[0] * T[1] + gU[1] * T[0]) + (gU[3] * T[4] + gU[4] * T[3]),
          (gU[0] * T[2] + gU[2] * T[0]) + (gU[3] * T[5] + gU[5] * T[3]),
          gU[1] * T[1] + gU[4] * T[4],
          (gU[1] * T[2] + gU[2] * T[1]) + (gU[4] * T[5] + gU[5] * T[4]),
          gU[2] * T[2] + gU[5] * T[5]]

    # J, the linearisation point
    V, P = camera.world_view, camera.full_proj
    gj00 = (gT[0] * V[0, 0] + gT[1] * V[1, 0]) + gT[2] * V[2, 0]
    gj02 = (gT[0] * V[0, 2] + gT[1] * V[1, 2]) + gT[2] * V[2, 2]
    gj11 = (gT[3] * V[0, 1] + gT[4] * V[1, 1]) + gT[5] * V[2, 1]
    gj12 = (gT[3] * V[0, 2] + gT[4] * V[1, 2]) + gT[5] * V[2, 2]
    fx, fy, tz, cux, cuy = g["fx"], g["fy"], g["tz"], g["cux"], g["cuy"]
    inv_z, inv_z2, ux, uy = g["inv_z"], g["inv_z2"], g["ux"], g["uy"]
    gtxtz = (gj02 * inv_z2) * -fx
    gtytz = (gj12 * inv_z2) * -fy
    ginvz2 = gj02 * (-fx * (cux * tz)) + gj12 * (-fy * (cuy * tz))
    ginvz = (gj00 * fx + gj11 * fy) + 2.0 * (ginvz2 * inv_z)
    gtz = -(ginvz * (inv_z * inv_z))
    gtz = gtz + gtxtz * cux + gtytz * cuy
    gux = torch.where((ux >= -g["limx"]) & (ux <= g["limx"]), gtxtz * tz, 0.0)
    guy = torch.where((uy >= -g["limy"]) & (uy <= g["limy"]), gtytz * tz, 0.0)
    gtx, gty = gux / tz, guy / tz
    gtz = gtz - (gux * (ux / tz) + guy * (uy / tz))

    # the mean
    in_front, pw = g["in_front"], g["pw"]
    gndc0, gndc1 = (gmx * 0.5) * W, (gmy * 0.5) * H
    gph0, gph1 = gndc0 * pw, gndc1 * pw
    gpw = gndc0 * g["ph0"] + gndc1 * g["ph1"]
    gph3 = torch.where(in_front, -(gpw * (pw * pw)), 0.0)
    gpv0, gpv1 = torch.where(in_front, gtx, 0.0), torch.where(in_front, gty, 0.0)
    gpv2 = gdep + torch.where(in_front, gtz, 0.0)
    for j in range(3):
        gx[j] = gx[j] + ((gph0 * P[j, 0] + gph1 * P[j, 1]) + gph3 * P[j, 3])
        gx[j] = gx[j] + ((gpv0 * V[j, 0] + gpv1 * V[j, 1]) + gpv2 * V[j, 2])

    # cov3d
    R, a, s = g["R"], g["a"], g["s"]
    gR = [None] * 9
    d_scaling = []
    for j in range(3):
        r0, r1, r2 = R[j], R[3 + j], R[6 + j]
        gR[j] = a[j] * ((2.0 * gS[0] * r0 + gS[1] * r1) + gS[2] * r2)
        gR[3 + j] = a[j] * ((gS[1] * r0 + 2.0 * gS[3] * r1) + gS[4] * r2)
        gR[6 + j] = a[j] * ((gS[2] * r0 + gS[4] * r1) + 2.0 * gS[5] * r2)
        ga = (r0 * ((gS[0] * r0 + gS[1] * r1) + gS[2] * r2)
              + r1 * (gS[3] * r1 + gS[4] * r2)) + r2 * (gS[5] * r2)
        d_scaling.append(((2.0 * s[j]) * ga) * s[j])
    qr, qx, qy, qz = g["q"]
    gq = [2.0 * (((((-qz * gR[1] + qy * gR[2]) + qz * gR[3]) - qx * gR[5]) - qy * gR[6])
                 + qx * gR[7]),
          2.0 * (((((((qy * gR[1] + qz * gR[2]) + qy * gR[3]) - 2.0 * qx * gR[4])
                    - qr * gR[5]) + qz * gR[6]) + qr * gR[7]) - 2.0 * qx * gR[8]),
          2.0 * (((((((-2.0 * qy * gR[0] + qx * gR[1]) + qr * gR[2]) + qx * gR[3])
                    + qz * gR[5]) - qr * gR[6]) + qz * gR[7]) - 2.0 * qy * gR[8]),
          2.0 * (((((((-2.0 * qz * gR[0] - qr * gR[1]) + qx * gR[2]) + qr * gR[3])
                    - 2.0 * qz * gR[4]) + qy * gR[5]) + qx * gR[6]) + qy * gR[7])]
    dot = ((gq[0] * qr + gq[1] * qx) + gq[2] * qy) + gq[3] * qz
    d_rotation = torch.stack([(gq[j] - dot * g["q"][j]) / g["qn"] for j in range(4)], -1)
    return (torch.stack(gx, -1), d_f[:, :1].contiguous(), d_f[:, 1:].contiguous(), d_opacity,
            torch.stack(d_scaling, -1), d_rotation, d_carrier)


def project_for_render(
    camera: Camera,
    model: GaussianModel,
    raster: RasterConfig | None = None,
    mean2d_carrier: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """The vertex stage of a render with the raster config's dilation and
    cull: `project_gaussians` of `model`'s activated parameters on the CPU,
    the kernel pair (`_Project`) on the raw leaves on a card."""
    raster = raster or RasterConfig()
    xyz = model.params.xyz
    if xyz.device.type == "cpu":
        return project_gaussians(
            xyz=xyz,
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
    if not xyz.is_cuda:
        raise ValueError(f"project_for_render: unsupported device {xyz.device}")
    p = model.params
    return ProjectedGaussians(*_Project.apply(
        xyz, p.f_dc, p.f_rest, p.opacity, p.scaling, p.rotation, mean2d_carrier, model.active,
        camera, model.active_sh_degree, raster.dilation, raster.znear_cull))
