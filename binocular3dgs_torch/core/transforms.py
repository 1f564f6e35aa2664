"""Geometric transforms: quaternions, camera matrices, fov conversions.

Counterpart of `binocular3dgs_tpu/core/transforms.py`. Camera matrices on
the device use the row-vector convention of the reference
(``p_clip = [p, 1] @ full_proj``); the matrix functions here return host-side
column-convention numpy matrices, as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion(s) [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """4x4 world-to-camera matrix (column-vector convention), host-side numpy.

    `R` is the camera-to-world rotation (COLMAP R transposed), `t` the
    world-to-camera translation; `translate`/`scale` move the camera center
    in world space.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is None and scale == 1.0:
        return Rt.astype(np.float32)
    C2W = np.linalg.inv(Rt)
    center = C2W[:3, 3]
    center = (center + (0.0 if translate is None else translate)) * scale
    C2W[:3, 3] = center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection (column-vector convention), host-side numpy:
    maps view z in [znear, zfar] to NDC z in [~0, 1]."""
    tan_half_fovx = math.tan(fovx / 2.0)
    tan_half_fovy = math.tan(fovy / 2.0)
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / tan_half_fovx
    P[1, 1] = 1.0 / tan_half_fovy
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.astype(np.float32)


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linear decay with optional warm-up easing (reference
    `utils/general_utils.py:29`). The returned function takes a Python step
    and returns a Python float: the trainer's step is a host integer, so the
    rate is computed on the host and never syncs the device."""

    def helper(step) -> float:
        step = float(step)
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
            )
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay_rate * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return helper
