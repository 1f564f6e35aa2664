"""Image reading, resizing and grey conversion with OpenCV's semantics.

The JAX package's dense init reads and scales its images with OpenCV
(`binocular3dgs_tpu/init/pipeline.py:82-85`, `init/matchers.py:50-53`); the
port imports no `cv2`, so it carries the three operations it needs:

  * `imread_rgb`: `cv2.imread` + `cvtColor(BGR2RGB)`, through PIL (EXIF
    orientation applied, as `cv2.imread` does; alpha dropped)
  * `resize_linear_u8`: `cv2.resize`'s default INTER_LINEAR on uint8:
    half-pixel centres, no antialiasing on a downscale, 11-bit fixed-point
    weights; columns clamp their taps and weights at the borders, rows
    clamp only their taps, and the vertical pass rounds in OpenCV's
    reduced-precision form `((b0*(S0>>4))>>16 + (b1*(S1>>4))>>16 + 2)>>2`
  * `rgb_to_gray_u8`: `COLOR_RGB2GRAY`, (9798 R + 19235 G + 3735 B + 2^14) >> 15

plus `resize_linear_f32`, the same resize on float32 planes (float weights;
an exact 2x downscale is OpenCV's 2x2 box average), which the Farneback
pyramid uses. `tests/test_torch_init_image_io.py` holds the uint8 and grey
functions against cv2 bit for bit, and the float resize within 2 units in
the last place (float32 sums in another order). Tensors are resized on the
device they live on.
"""

from __future__ import annotations

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file."""
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        return np.array(ImageOps.exif_transpose(im).convert("RGB"))


def _axis_coefs(dst: int, src: int, clamp_weights: bool, position=np.float64):
    """(tap0, tap1, w1) of OpenCV's linear resize along one axis: w1 is the
    float32 weight of tap1; with `clamp_weights` a tap before the first or
    past the last source index is pulled onto it with weight 0 (columns),
    else only the taps are clamped (rows). The source position is rounded
    to `position` before its fraction is taken: float32 for uint8 images,
    float64 for float32 ones (each matches cv2 on its images)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(position)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(position)).astype(np.float32)
    if clamp_weights:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0.0
        s = np.clip(s, 0, src - 1)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _fixed(w1: np.ndarray):
    """OpenCV's 11-bit weights: each float weight times 2048, rounded."""
    w0 = np.rint((np.float32(1.0) - w1) * np.float32(_COEF_SCALE)).astype(np.int64)
    return w0, np.rint(w1 * np.float32(_COEF_SCALE)).astype(np.int64)


def resize_linear_u8(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """`cv2.resize(img, size)` of an (H, W) or (H, W, C) uint8 tensor;
    `size` is (width, height), as cv2 takes it."""
    w, h = size
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.clone()
    dev = img.device
    x0, x1, fx = _axis_coefs(w, W, True, np.float32)
    y0, y1, fy = _axis_coefs(h, H, False, np.float32)
    (a0, a1), (b0, b1) = _fixed(fx), _fixed(fy)

    def t(a):
        return torch.from_numpy(a).to(dev)

    S = img.to(torch.int64)
    shape = (1, w) + (1,) * (img.ndim - 2)
    rows = S[:, t(x0)] * t(a0).reshape(shape) + S[:, t(x1)] * t(a1).reshape(shape)
    bshape = (h,) + (1,) * (img.ndim - 1)
    out = ((((rows[t(y0)] >> 4) * t(b0).reshape(bshape)) >> 16)
           + (((rows[t(y1)] >> 4) * t(b1).reshape(bshape)) >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(torch.uint8)


def resize_linear_f32(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """`cv2.resize(x, size)` (INTER_LINEAR) of float32 planes (C, H, W);
    `size` is (width, height). Horizontal taps first, then vertical, in
    float32; an exact 2x downscale averages each 2x2 block, as OpenCV
    switches to its area resize there."""
    w, h = size
    C, H, W = x.shape
    if (w, h) == (W, H):
        return x.clone()
    if W == 2 * w and H == 2 * h:
        return ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
                + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) * 0.25
    dev = x.device
    x0, x1, fx = _axis_coefs(w, W, True)
    y0, y1, fy = _axis_coefs(h, H, False)

    def t(a):
        return torch.from_numpy(a).to(dev)

    a1 = t(fx)
    rows = x[:, :, t(x0)] * (1.0 - a1) + x[:, :, t(x1)] * a1
    b1 = t(fy)[:, None]
    return rows[:, t(y0)] * (1.0 - b1) + rows[:, t(y1)] * b1


def rgb_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)` of an (H, W, 3) uint8 tensor."""
    c = img.to(torch.int32)
    y = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735 + (1 << 14)) >> 15
    return y.to(torch.uint8)
