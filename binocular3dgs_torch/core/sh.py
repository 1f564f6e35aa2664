"""Real spherical harmonics evaluation (degrees 0..3).

Counterpart of `binocular3dgs_tpu/core/sh.py` (PlenOctree SH convention,
reference `utils/sh_utils.py`). The JAX package also evaluates degree 4,
which no model of the repo uses; it is not carried.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions.

    deg: degree in [0, 3]; sh: [..., C, K] coefficients with K >= (deg+1)^2
    (channel-major); dirs: [..., 3] unit directions. Returns [..., C] color
    (before the +0.5 shift).
    """
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} not supported (0..3)")
    if sh.shape[-1] < num_sh_coeffs(deg):
        raise ValueError(f"{sh.shape[-1]} SH coefficients for degree {deg}")

    result = C0 * sh[..., 0]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
    return result


def rgb_to_sh(rgb):
    """DC-band encoding of an RGB color (reference `utils/sh_utils.py:114`)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """Inverse of :func:`rgb_to_sh`."""
    return sh * C0 + 0.5
