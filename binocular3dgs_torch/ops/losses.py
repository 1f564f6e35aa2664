"""Image metrics and losses.

Counterpart of `binocular3dgs_tpu/ops/losses.py`: L1 with the
unnormalized mask convention, window-11 sigma-1.5 SSIM, PSNR and the
edge-aware disparity smoothness of the binocular loss (reference
`utils/loss_utils.py`, `utils/image_utils.py:18`). Images are (C, H, W)
float32, or (B, C, H, W).

SSIM blurs with a grouped convolution, as the reference does; cuDNN runs
float32 convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is
off, and may pick a backward that adds in another order on each run unless
`torch.backends.cudnn.deterministic` is on; the entry points set both
(binocular3dgs_torch.resolve_device).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ssim(img1, img2, window_size: int = SSIM_WINDOW, size_average: bool = True):
    """Structural similarity with zero ('SAME') padding
    (reference `utils/loss_utils.py:36-66`)."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    C = img1.shape[1]
    g = _gaussian_window(window_size, SSIM_SIGMA, img1.device)
    window = (g[:, None] * g[None, :]).expand(C, 1, window_size, window_size).contiguous()

    def blur(x):
        return F.conv2d(x, window, padding=window_size // 2, groups=C)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + SSIM_C1) * (2 * sigma12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


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
