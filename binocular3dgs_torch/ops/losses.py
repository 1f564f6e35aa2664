"""Image metrics and losses.

Counterpart of `binocular3dgs_tpu/ops/losses.py`: L1 with the
unnormalized mask convention, window-11 sigma-1.5 SSIM, PSNR and the
edge-aware disparity smoothness of the binocular loss (reference
`utils/loss_utils.py`, `utils/image_utils.py:18`). Images are (C, H, W)
float32, or (B, C, H, W).

On the CPU, SSIM blurs with a grouped convolution, as the reference does
(`ssim_torch`). On a card it runs the kernel pair of `csrc/ssim.cu`
(`_SSIM`): one forward kernel that also writes the three partial-derivative
maps the backward needs (its blurs sum as the card's depthwise convolution
does, so its maps equal `ssim_maps_torch`'s there bit for bit), one
backward kernel that blurs them into the image's gradient.
`ssim_maps_torch` and `ssim_backward_torch` are those kernels' formulas in
torch ops (the forward's maps, and the gradient from them), which the tests
hold against autograd of `ssim` and against the kernels. On a card
`ssim_torch` convolves through PyTorch, where cuDNN would run float32 in
TF32 unless `torch.backends.cudnn.allow_tf32` is off; the entry points turn
it off (binocular3dgs_torch.resolve_device).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import tracing

SSIM_WINDOW = 11
SSIM_SIGMA = 1.5
SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


def l1_loss(pred, gt, mask=None):
    """Mean absolute error; with a mask the mean still runs over all pixels
    (reference `utils/loss_utils.py:18-21`)."""
    if mask is not None:
        return torch.mean(torch.abs(pred * mask - gt * mask))
    return torch.mean(torch.abs(pred - gt))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(xs**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _batched(img1, img2):
    """(img1, img2) as (B, C, H, W), and whether they came as (C, H, W)."""
    if img1.ndim == 3:
        return img1[None], img2[None], True
    return img1, img2, False


def _blur(channels: int, device, window_size: int = SSIM_WINDOW):
    """SSIM's blur of (B, channels, H, W) images: the window_size^2 Gaussian
    window, zero padding."""
    g = _gaussian_window(window_size, SSIM_SIGMA, device)
    window = (g[:, None] * g[None, :]).expand(channels, 1, window_size, window_size).contiguous()
    return lambda x: F.conv2d(x, window, padding=window_size // 2, groups=channels)


def _ssim_terms(img1, img2, window_size: int = SSIM_WINDOW):
    """The plain composition on (B, C, H, W) images: the SSIM map and the
    terms it is made of."""
    blur = _blur(img1.shape[1], img1.device, window_size)
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    n1, n2 = 2 * mu1_mu2 + SSIM_C1, 2 * sigma12 + SSIM_C2
    d1, d2 = mu1_sq + mu2_sq + SSIM_C1, sigma1_sq + sigma2_sq + SSIM_C2
    ssim_map = (n1 * n2) / (d1 * d2)
    return ssim_map, mu1, mu2, n1, n2, d1, d2


def ssim(img1, img2, window_size: int = SSIM_WINDOW, size_average: bool = True):
    """Structural similarity with zero ('SAME') padding
    (reference `utils/loss_utils.py:36-66`): the mean over all images, or
    with `size_average` False one mean per image. `ssim_torch` on the CPU;
    on a card the kernel pair (`_SSIM`: the window must be 11, and `img2`,
    the ground truth, gets no gradient), forward only where no gradient of
    `img1` is wanted."""
    if not img1.is_cuda:
        return ssim_torch(img1, img2, window_size, size_average)
    if window_size != SSIM_WINDOW:
        raise ValueError(f"ssim on a card: the kernel's window is {SSIM_WINDOW}, got "
                         f"{window_size}")
    grad = torch.is_grad_enabled()
    if grad and img2.requires_grad:
        raise ValueError("ssim on a card computes no gradient of img2")
    x, y, _ = _batched(img1, img2)
    if grad and img1.requires_grad:
        return _SSIM.apply(x, y, size_average)
    return ssim_forward(x, y, size_average)[0]


def ssim_torch(img1, img2, window_size: int = SSIM_WINDOW, size_average: bool = True):
    """`ssim` as the reference composes it, in torch ops on any device."""
    img1, img2, _ = _batched(img1, img2)
    ssim_map = _ssim_terms(img1, img2, window_size)[0]
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_maps_torch(img1, img2, size_average: bool = True):
    """The forward kernel's results in torch ops: (`ssim_torch`'s value, the
    derivatives of the SSIM map in mu1 = blur(img1), sxx = blur(img1^2)
    and sxy = blur(img1 img2), each with the other two held), the maps
    shaped as the images."""
    x, y, squeeze = _batched(img1, img2)
    m, mu1, mu2, n1, n2, d1, d2 = _ssim_terms(x, y)
    den = d1 * d2
    d_mu1 = (2 * mu2 * (n2 - n1)) / den + 2 * mu1 * m * (1 / d2 - 1 / d1)
    d_sxx = -m / d2
    d_sxy = (2 * n1) / den
    maps = tuple(t[0] if squeeze else t for t in (d_mu1, d_sxx, d_sxy))
    return (m.mean() if size_average else m.mean(dim=(1, 2, 3))), maps


def ssim_backward_torch(img1, img2, maps, grad, size_average: bool = True):
    """The backward kernel's formula in torch ops: the gradient of `img1`
    from `grad`, the upstream gradient of `ssim`'s value (one per image
    without `size_average`), and `maps` (`ssim_maps_torch`'s):
    grad / n * (blur(dm/dmu1) + 2 img1 blur(dm/dsxx) + img2 blur(dm/dsxy)),
    n the values each mean is taken over; the zero-padded blur is its own
    adjoint, the window being symmetric."""
    x, y, squeeze = _batched(img1, img2)
    d_mu1, d_sxx, d_sxy = (m[None] if squeeze else m for m in maps)
    B, C, H, W = x.shape
    blur = _blur(C, x.device)
    n = (B if size_average else 1) * C * H * W
    scale = (grad / n).reshape(-1, 1, 1, 1)
    dx = scale * ((blur(d_mu1) + 2 * x * blur(d_sxx)) + y * blur(d_sxy))
    return dx[0] if squeeze else dx


# -- SSIM on a card: csrc/ssim.cu ---------------------------------------------

# The PyTorch and CUDA versions whose conv_depthwise2d sums each blur in the
# order that the forward kernel follows, so that its maps equal
# `ssim_maps_torch`'s on the card bit for bit (csrc/ssim.cu; the card's
# tests check it, and that the plain blur still runs conv_depthwise2d)
SSIM_CONV_PINNED = ("2.11", "12.8")
# the forward kernel's tile of outputs (rows, columns): one partial sum each
SSIM_TILE = (64, 32)


@functools.cache
def _window_host(device: torch.device):
    """The 11 taps of the window as the kernels take them: computed on
    `device`, as the plain composition computes them there (one read, the
    first time)."""
    taps = _gaussian_window(SSIM_WINDOW, SSIM_SIGMA, device).tolist()
    return (ctypes.c_float * SSIM_WINDOW)(*taps)


def _kernel_images(name, *images):
    """`images`, (B, C, H, W) float32 on one card, made contiguous."""
    first = images[0]
    if not first.is_cuda or first.ndim != 4:
        raise ValueError(f"{name}: (B, C, H, W) images on a CUDA device, got "
                         f"{tuple(first.shape)} on {first.device}")
    for t in images:
        if t.dtype != torch.float32 or t.device != first.device or t.shape != first.shape:
            raise ValueError(f"{name}: every image must be {tuple(first.shape)} float32 on "
                             f"{first.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return [t.contiguous() for t in images]


def ssim_forward(img1, img2, size_average: bool = True, maps: bool = False):
    """The forward kernel on (B, C, H, W) float32 CUDA images: (`ssim`'s
    value, and with `maps` `ssim_maps_torch`'s three maps for
    `ssim_backward`, else None)."""
    return _forward(*_kernel_images("ssim_forward", img1, img2), size_average, maps)


def _forward(x, y, size_average, maps):
    """`ssim_forward` on images that `_kernel_images` gave."""
    from .cuda_build import load_library

    B, C, H, W = x.shape
    tiles = B * C * -(-H // SSIM_TILE[0]) * -(-W // SSIM_TILE[1])
    partials = x.new_empty(tiles)
    mean = x.new_empty(() if size_average else (B,))
    out = tuple(torch.empty_like(x) for _ in range(3)) if maps else None
    with torch.cuda.device(x.device):
        err = load_library().b3dgs_ssim_forward(
            x.data_ptr(), y.data_ptr(), B * C, H, W, _window_host(x.device),
            1 if size_average else B, partials.data_ptr(), tiles, mean.data_ptr(),
            *((m.data_ptr() for m in out) if maps else (None, None, None)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_forward kernel launch failed: cudaError {err}")
    tracing.launched("ssim_forward")
    tracing.count("loss.ssim_elems", B * C * H * W)
    return mean, out


def ssim_backward(img1, img2, maps, grad, size_average: bool = True):
    """The backward kernel: `ssim_backward_torch` on (B, C, H, W) float32
    CUDA images, `grad` on the same card."""
    x, y, *maps = _kernel_images("ssim_backward", img1, img2, *maps)
    groups = 1 if size_average else x.shape[0]
    if grad.numel() != groups or grad.device != x.device:
        raise ValueError(f"ssim_backward: grad must hold {groups} value(s) on {x.device}")
    return _backward(x, y, maps, grad, groups)


def _backward(x, y, maps, grad, groups):
    """`ssim_backward` on images and maps that `_kernel_images` gave, and
    the upstream gradient of each of `groups` means."""
    from .cuda_build import load_library

    B, C, H, W = x.shape
    grad = grad.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().b3dgs_ssim_backward(
            x.data_ptr(), y.data_ptr(), *(m.data_ptr() for m in maps), grad.data_ptr(), B * C,
            H, W, _window_host(x.device), groups, dx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_backward kernel launch failed: cudaError {err}")
    tracing.launched("ssim_backward")
    return dx


class _SSIM(torch.autograd.Function):
    """SSIM on a card: the forward kernel with the maps forward, the
    backward kernel backward; no gradient of img2."""

    @staticmethod
    def forward(ctx, img1, img2, size_average):
        x, y = _kernel_images("ssim", img1, img2)
        value, maps = _forward(x, y, size_average, maps=True)
        ctx.save_for_backward(x, y, *maps)
        ctx.groups = 1 if size_average else x.shape[0]
        return value

    @staticmethod
    @tracing.region("step.ssim.backward")
    def backward(ctx, grad):
        x, y, *maps = ctx.saved_tensors
        return _backward(x, y, maps, grad, ctx.groups), None, None


def smooth_loss(disparity, image):
    """Edge-aware disparity smoothness (reference `utils/loss_utils.py:68-91`):
    disparity (H, W), image (3, H, W); central differences (x0.5) at the
    interior pixels, image edges summed over channels, weight
    exp(-0.33 |edge|)."""
    ex_im = 0.5 * (image[:, 1:-1, 2:] - image[:, 1:-1, :-2]).sum(dim=0)
    ey_im = 0.5 * (image[:, 2:, 1:-1] - image[:, :-2, 1:-1]).sum(dim=0)
    ex_d = 0.5 * (disparity[1:-1, 2:] - disparity[1:-1, :-2])
    ey_d = 0.5 * (disparity[2:, 1:-1] - disparity[:-2, 1:-1])
    wx = torch.exp(-0.33 * torch.abs(ex_im))
    wy = torch.exp(-0.33 * torch.abs(ey_im))
    return torch.mean(torch.abs(wx * ex_d)) + torch.mean(torch.abs(wy * ey_d))


def psnr(img1, img2, mask=None):
    """Peak signal-to-noise ratio; with a mask only pixels where mask == 1
    enter the mean (reference `utils/image_utils.py:18-23`)."""
    if mask is not None:
        sel = torch.broadcast_to((mask == 1.0).to(img1.dtype), img1.shape)
        mse = torch.sum(((img1 - img2) ** 2) * sel) / torch.clamp(torch.sum(sel), min=1.0)
    else:
        mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
