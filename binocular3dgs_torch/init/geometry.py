"""Geometric primitives for the dense initialization pipeline.

Counterpart of `binocular3dgs_tpu/init/geometry.py`: the numpy functions
are the port's own copies (DLT, projections and filters stay float64 on the
host, as the JAX package computes them), and the jitted JAX ones
(`grid_sample_bilinear_jax`, `sample_patches_jax`, `patch_ssim_jax`) are the
torch functions at the end, which run on the device of their inputs in
their dtype (the growth scorer's float32, the colours' float64).

Behavioral parity targets:
  * DLT two-view triangulation: cv2.triangulatePoints at reference
    `submodules/dense_matcher/triangulate.py:171` (SVD nullspace of the
    4x4 DLT system), batched numpy
  * world->image projection + depth: `utils.py:96-104` (point_world2depth)
    and `utils.py:186-201` (map_points_to_image)
  * depth->world backprojection: `utils.py:106-132` (normalized-by-(W-1,H-1)
    NDC convention)
  * bilinear sampling with torch grid_sample align_corners=False semantics
    (`triangulate.py:214-219`, `utils.py:160-178`)
  * 11x11 patch SSIM: `ssim.py:84-104` (SSIM_v2)

This stage runs once per scene.
"""

from __future__ import annotations

import numpy as np
import torch


def triangulate_points_dlt(P0: np.ndarray, P1: np.ndarray, uv0: np.ndarray, uv1: np.ndarray):
    """Batched DLT triangulation.

    P0, P1: (3, 4) projection matrices; uv0, uv1: (N, 2) pixel matches.
    Returns (N, 3) world points (homogeneous-normalized), matching
    cv2.triangulatePoints up to SVD sign.
    """
    N = uv0.shape[0]
    A = np.empty((N, 4, 4), dtype=np.float64)
    A[:, 0] = uv0[:, 0:1] * P0[2] - P0[0]
    A[:, 1] = uv0[:, 1:2] * P0[2] - P0[1]
    A[:, 2] = uv1[:, 0:1] * P1[2] - P1[0]
    A[:, 3] = uv1[:, 1:2] * P1[2] - P1[1]
    # nullspace = right singular vector of smallest singular value
    _, _, vt = np.linalg.svd(A)
    X = vt[:, 3, :]  # (N, 4)
    return X[:, :3] / X[:, 3:4]


def project_points(points: np.ndarray, K: np.ndarray, w2c: np.ndarray):
    """points (N, 3) world -> (uv (N, 2), depth (N,)) via K (3,3), w2c (4,4).

    reference `utils.py:96-104`."""
    pc = points @ w2c[:3, :3].T + w2c[:3, 3]
    pi = pc @ K.T
    uv = pi[:, :2] / pi[:, 2:3]
    return uv, pi[:, 2]


def backproject_depth(depth: np.ndarray, K: np.ndarray, c2w: np.ndarray):
    """Full-image depth map (H, W) -> world points (H*W, 3).

    reference `depth2point_world` (`utils.py:106-132`): pixel grid normalized
    by (W-1, H-1), unprojected through K^-1 with xy pre-scaled by z."""
    H, W = depth.shape
    xs = np.arange(W, dtype=np.float64) / (W - 1)
    ys = np.arange(H, dtype=np.float64) / (H - 1)
    gx, gy = np.meshgrid(xs, ys)
    z = depth.astype(np.float64)
    inv_scale = np.array([W - 1, H - 1], dtype=np.float64)
    cam_xy = np.stack([gx, gy], -1) * inv_scale * z[..., None]
    cam_xyz = np.concatenate([cam_xy, z[..., None]], axis=-1).reshape(-1, 3)
    cam_xyz = cam_xyz @ np.linalg.inv(K.T)
    world = np.concatenate([cam_xyz, np.ones_like(cam_xyz[:, :1])], axis=-1) @ c2w.T
    return world[:, :3]


def grid_sample_bilinear(img: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """torch.nn.functional.grid_sample semantics (bilinear, zero padding,
    align_corners=False). img (H, W, C); grid (..., 2) normalized [-1, 1].
    Returns (..., C)."""
    H, W = img.shape[:2]
    gx = (grid[..., 0] + 1.0) * W / 2.0 - 0.5
    gy = (grid[..., 1] + 1.0) * H / 2.0 - 0.5
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    out = np.zeros(grid.shape[:-1] + (img.shape[-1],), dtype=img.dtype)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (1 - np.abs(gx - xi)) * (1 - np.abs(gy - yi))
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = np.clip(xi, 0, W - 1)
        yi_c = np.clip(yi, 0, H - 1)
        out = out + np.where(valid[..., None], wgt[..., None] * img[yi_c, xi_c], 0.0)
    return out


def sample_colors_at(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Colors at pixel coords with the reference's normalization
    (`triangulate.py:214-217`): grid = uv / (W-1, H-1) * 2 - 1."""
    H, W = img.shape[:2]
    grid = uv / np.array([W - 1, H - 1]) * 2.0 - 1.0
    return grid_sample_bilinear(img, grid)


def build_patch_offset(half_patch_size: int) -> np.ndarray:
    """(w^2, 2) x/y offsets of a (2h+1)^2 patch (reference `utils.py:203-208`,
    note meshgrid 'ij' ordering: offsets iterate y-major)."""
    r = np.arange(-half_patch_size, half_patch_size + 1, dtype=np.float64)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    return np.stack([ox, oy], axis=-1).reshape(-1, 2)


def _gaussian_1d(size, sigma=1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    return g / g.sum()


def _blur_matrix(w: int) -> np.ndarray:
    """Banded matrix B s.t. (B @ x) is the 1-D Gaussian 'SAME' zero-padded
    convolution along an axis of length w: B[a, i] = g[i - a + w//2]."""
    g = _gaussian_1d(w)
    c = w // 2
    a = np.arange(w)
    idx = a[None, :] - a[:, None] + c  # (out, in)
    B = np.where((idx >= 0) & (idx < w), g[np.clip(idx, 0, w - 1)], 0.0)
    return B


def patch_ssim(pred: np.ndarray, gt: np.ndarray, half_patch_size: int) -> np.ndarray:
    """Mean SSIM per patch pair (reference SSIM_v2, `ssim.py:84-104`).

    pred, gt: (N, w^2, 3) patches. Gaussian-window SSIM over the (w, w)
    patch with 'SAME' zero padding, averaged over pixels and channels.
    The separable Gaussian blur is two banded matmuls over all patches at
    once (the reference loops a conv2d; a per-patch scipy loop is ~1000x
    slower at LLFF growth scale).
    """
    w = 2 * half_patch_size + 1
    N = pred.shape[0]
    B = _blur_matrix(w)
    p = pred.reshape(N, w, w, 3)
    g = gt.reshape(N, w, w, 3)

    def blur(x):
        # rows then cols: out[n,a,b,c] = sum_{i,j} B[a,i] B[b,j] x[n,i,j,c]
        return np.einsum("ai,nijc,bj->nabc", B, x, B, optimize=True)

    mu1, mu2 = blur(p), blur(g)
    s1 = blur(p * p) - mu1 * mu1
    s2 = blur(g * g) - mu2 * mu2
    s12 = blur(p * g) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1**2 + mu2**2 + c1) * (s1 + s2 + c2))
    return m.mean(axis=(1, 2, 3))


def grid_sample_bilinear_torch(img, grid):
    """`grid_sample_bilinear` in torch (bilinear, zero padding,
    align_corners=False): img (H, W, C); grid (..., 2) -> (..., C), in the
    inputs' dtype, on their device."""
    H, W = img.shape[:2]
    gx = (grid[..., 0] + 1.0) * W / 2.0 - 0.5
    gy = (grid[..., 1] + 1.0) * H / 2.0 - 0.5
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    out = torch.zeros(grid.shape[:-1] + (img.shape[-1],), dtype=img.dtype, device=img.device)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (1 - torch.abs(gx - xi)) * (1 - torch.abs(gy - yi))
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        tap = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        out = out + torch.where(valid[..., None], wgt[..., None] * tap, 0.0)
    return out


def sample_colors_at_torch(img, uv):
    """`sample_colors_at` in torch: colours at pixel coordinates uv (N, 2)."""
    H, W = img.shape[:2]
    grid = uv / uv.new_tensor([W - 1, H - 1]) * 2.0 - 1.0
    return grid_sample_bilinear_torch(img, grid)


def sample_patches_torch(img, uv, half_patch_size: int):
    """`sample_patches` in torch: (N, w^2, C) patches centred at uv (N, 2)."""
    H, W = img.shape[:2]
    offset = torch.as_tensor(build_patch_offset(half_patch_size), dtype=img.dtype,
                             device=img.device)
    grid_pix = uv[:, None, :] + offset[None, :, :]
    grid = grid_pix * 2.0 / grid_pix.new_tensor([W, H]) - 1.0
    return grid_sample_bilinear_torch(img, grid)


def patch_ssim_torch(pred, gt, half_patch_size: int):
    """`patch_ssim` in torch (separable banded-matmul Gaussian blur)."""
    w = 2 * half_patch_size + 1
    N = pred.shape[0]
    B = torch.as_tensor(_blur_matrix(w), dtype=pred.dtype, device=pred.device)
    p = pred.reshape(N, w, w, -1)
    g = gt.reshape(N, w, w, -1)

    def blur(x):
        return torch.einsum("ai,nijc,bj->nabc", B, x, B)

    mu1, mu2 = blur(p), blur(g)
    s1 = blur(p * p) - mu1 * mu1
    s2 = blur(g * g) - mu2 * mu2
    s12 = blur(p * g) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1**2 + mu2**2 + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))
