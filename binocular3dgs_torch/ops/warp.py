"""Disparity-based inverse image warp — the binocular-consistency core.

Counterpart of `binocular3dgs_tpu/ops/warp.py` (reference
`utils/graphics_utils.py:80-125`, from monodepth): a horizontal-only
backward warp with per-pixel float disparity, linear interpolation between
the two straddling columns, and zero wherever *either* column is out of
bounds. Gradients reach the image through the transpose scatter and the
disparity through the interpolation weights only (floor is piecewise
constant), as with the reference's detached integer indices.

`inverse_warp_image` is a `torch.autograd.Function` around two CUDA kernels
(csrc/warp.cu): W1 `warp_forward` gives `out` and `diff = g1 - g0`, W2
`warp_backward` gives `d_image`; `d_disp = sum_c diff * d_out * valid` is
computed here. For CPU tensors each wrapper runs its plain PyTorch version
(`warp_forward_torch`, the two-gather form of the JAX `_warp_xla`, and
`warp_backward_torch`, the kernel's per-row int64 fixed-point sum by
`index_add_`, equal to it bit for bit); on a CUDA tensor it launches its
kernel or raises. Images are channels-first
(C, H, W), disparities (H, W), float32.
"""

from __future__ import annotations

import torch

from .. import tracing
from .cuda_build import launch


def _taps(disparity: torch.Tensor, W: int):
    """(c0, c1, w0, w1, valid) per pixel: the clamped tap columns, the
    interpolation weights and the validity of both taps."""
    x0 = torch.floor(disparity)
    cols = torch.arange(W, device=disparity.device, dtype=torch.int32)[None, :]
    c0 = cols + x0.to(torch.int32)
    valid = (c0 >= 0) & (c0 + 1 < W)
    w1 = disparity - x0
    return torch.clamp(c0, 0, W - 1), torch.clamp(c0 + 1, 0, W - 1), 1.0 - w1, w1, valid


def warp_mask(disparity: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Validity mask = warp of an all-ones image (reference `train.py:133`),
    (H, W) float32 in {0, 1}: w0 + w1 = 1 where both columns are in bounds,
    0 elsewhere, and its disparity gradient is zero, so the analytic
    comparison is exact (JAX `warp.py:101-112`)."""
    cols = torch.arange(width, device=disparity.device, dtype=torch.int32)[None, :]
    c0 = cols + torch.floor(disparity).to(torch.int32)
    return ((c0 >= 0) & (c0 + 1 < width)).to(torch.float32)


def _row_index(c: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Flat (H*W,) index of column `c (H, W)` in each pixel's own row."""
    rows = torch.arange(H, device=c.device, dtype=torch.int64)[:, None] * W
    return (rows + c.long()).reshape(-1)


@torch.no_grad()
def warp_forward_torch(image: torch.Tensor, disparity: torch.Tensor):
    """Plain W1: (out, diff), each (C, H, W), both zero on invalid pixels."""
    C, H, W = image.shape
    c0, c1, w0, w1, valid = _taps(disparity, W)
    flat = image.reshape(C, H * W)
    g0 = flat[:, _row_index(c0, H, W)].reshape(C, H, W)
    g1 = flat[:, _row_index(c1, H, W)].reshape(C, H, W)
    out = torch.where(valid[None], w0[None] * g0 + w1[None] * g1, 0.0)
    diff = torch.where(valid[None], g1 - g0, 0.0)
    return out, diff


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n as float64, exact for int64 n in [-1022, 1023]."""
    return ((n + 1023) << 52).view(torch.float64)


def _fixed_to_float(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """float32 of the int64 sums `v` times 2^-s, correctly rounded: |v|
    rounded to odd at 52-53 bits is exact in float64, the scale too, so the
    one rounding to float32 is correct (subnormals included)."""
    a = v.abs()
    k = (torch.frexp(a.double()).exponent.long() - 53).clamp_(min=0)
    t = (a >> k) | ((a & ((torch.ones_like(a) << k) - 1)) != 0).long()
    mag = t.double() * _pow2(k - s)
    return torch.where(v < 0, -mag, mag).float()


@torch.no_grad()
def warp_backward_torch(disparity: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """Plain W2: d_image (C, H, W), the transpose of the warp applied to
    `d_out`, summed per row in int64 fixed point as the kernel does
    (csrc/warp.cu, W2 steps 2-4), so the two agree bit for bit and neither
    depends on the order of the additions. Row scale 2^s with
    s = 62 - e - ceil(log2 W), e from frexp of max |d_out| over the row's
    valid pixels (finite values); each float32 term w * d_out becomes
    round_half_even(t * 2^s), `index_add_` sums them in int64, and each
    column converts back once. Non-finite terms stay out of the sums and
    make their column what a float sum would: +inf, -inf or NaN."""
    C, H, W = d_out.shape
    c0, c1, w0, w1, valid = _taps(disparity, W)
    terms = torch.where(valid, torch.stack([w0 * d_out, w1 * d_out]), 0.0)  # (2, C, H, W)
    finite = torch.isfinite(terms)
    row_max = torch.where(valid & torch.isfinite(d_out), d_out.abs(), 0.0).amax(dim=(0, 2))
    s = 62 - torch.frexp(row_max).exponent.long() - (W - 1).bit_length()  # (H,)
    q = torch.round(torch.where(finite, terms, 0.0).double() * _pow2(s)[:, None]).long()
    idx = (_row_index(c0, H, W), _row_index(c1, H, W))
    acc = torch.zeros(C, H * W, dtype=torch.int64, device=d_out.device)
    for tap in range(2):
        acc.index_add_(1, idx[tap], q[tap].reshape(C, -1))
    d_img = _fixed_to_float(acc.reshape(C, H, W), s[:, None])
    if bool(finite.all()):
        return d_img
    # per column: any +inf or NaN term, any -inf or NaN term
    pos, neg = (((terms > 0) | terms.isnan()) & ~finite), (((terms < 0) | terms.isnan()) & ~finite)
    hit = torch.zeros(2, C, H * W, dtype=torch.int64, device=d_out.device)
    for tap in range(2):
        hit.index_add_(2, idx[tap], torch.stack([pos[tap], neg[tap]]).reshape(2, C, -1).long())
    pos, neg = (hit > 0).reshape(2, C, H, W)
    d_img = torch.where(pos, torch.inf, torch.where(neg, -torch.inf, d_img))
    return torch.where(pos & neg, torch.nan, d_img)


def _check(name, *tensors):
    for x in tensors:
        if x.dtype != torch.float32:
            raise ValueError(f"{name} takes float32 tensors, got {x.dtype}")
        if x.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {x.device} and {tensors[0].device}")


def warp_forward(image: torch.Tensor, disparity: torch.Tensor):
    """W1: (out, diff) of the warp; the CUDA kernel for CUDA tensors,
    `warp_forward_torch` for CPU tensors."""
    _check("warp_forward", image, disparity)
    C, H, W = image.shape
    if disparity.shape != (H, W):
        raise ValueError(f"disparity must be ({H}, {W}), got {tuple(disparity.shape)}")
    if image.device.type == "cpu":
        return warp_forward_torch(image, disparity)
    if not image.is_cuda:
        raise ValueError(f"warp_forward: unsupported device {image.device}")
    image, disparity = image.contiguous(), disparity.contiguous()
    out = torch.empty_like(image)
    diff = torch.empty_like(image)
    launch("b3dgs_warp_forward", image.device, image, disparity, C, H, W, out, diff)
    return out, diff


def warp_backward(disparity: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """W2: d_image of the warp; the CUDA kernel for CUDA tensors,
    `warp_backward_torch` for CPU tensors."""
    _check("warp_backward", d_out, disparity)
    C, H, W = d_out.shape
    if disparity.shape != (H, W):
        raise ValueError(f"disparity must be ({H}, {W}), got {tuple(disparity.shape)}")
    if d_out.device.type == "cpu":
        return warp_backward_torch(disparity, d_out)
    if not d_out.is_cuda:
        raise ValueError(f"warp_backward: unsupported device {d_out.device}")
    disparity, d_out = disparity.contiguous(), d_out.contiguous()
    d_image = torch.empty_like(d_out)
    launch("b3dgs_warp_backward", d_out.device, disparity, d_out, C, H, W, d_image)
    return d_image


class _InverseWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, disparity):
        out, diff = warp_forward(image, disparity)
        ctx.save_for_backward(disparity, diff)
        return out

    @staticmethod
    @tracing.region("step.warp.backward")
    def backward(ctx, d_out):
        disparity, diff = ctx.saved_tensors
        d_image = warp_backward(disparity, d_out) if ctx.needs_input_grad[0] else None
        d_disp = None
        if ctx.needs_input_grad[1]:
            H, W = disparity.shape
            d_disp = (diff * d_out).sum(0) * warp_mask(disparity, H, W)
        return d_image, d_disp


def inverse_warp_image(image: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """Warp `image (C, H, W)` horizontally by per-pixel `disparity (H, W)`:
    out(r, c) = (x1 - d) * image[r, c + x0] + (d - x0) * image[r, c + x1],
    x0 = floor(d), x1 = x0 + 1, zero where either column is out of bounds."""
    return _InverseWarp.apply(image, disparity)
