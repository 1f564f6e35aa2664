"""Mixture-density uncertainty decoders and P_R closed forms (reference
models/PDCNet/mod_uncertainty.py).

Counterpart of `binocular3dgs_tpu/init/pdcnet/uncertainty.py`. PDCNet_plus
predicts a 2-mode Laplace mixture per pixel: a fixed small variance (1.0)
and a learned large one constrained to [2, 520^2] (256^2 on the 256x256
levels). Maps are NCHW: the mixture's modes on dim 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv_block


class CorrUncertaintyDecoder(nn.Module):
    """MixtureDensityEstimatorFromCorr (reference mod_uncertainty.py:69-135),
    output_all_channels_together, one input channel: each position's s x s
    correlation patch is a 1-channel image -> 6 channels."""

    def __init__(self, search_size: int):
        super().__init__()
        if search_size not in (9, 16):
            raise ValueError(f"unsupported search size {search_size}")
        self.search_size = search_size
        self.conv_0 = conv_block(1, 32, padding=0)
        self.conv_1 = conv_block(32, 16, padding=0)
        self.conv_2 = conv_block(16, 16, padding=0)
        self.predict_uncertainty = nn.Conv2d(16, 6, 3, padding=0)

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        """corr: (b, s*s, h, w) -> (b, 6, h, w)."""
        b, _, h, w = corr.shape
        s = self.search_size
        x = self.conv_0(corr.permute(0, 2, 3, 1).reshape(b * h * w, 1, s, s))
        if s == 16:
            x = F.max_pool2d(x, 2)
        x = self.predict_uncertainty(self.conv_2(self.conv_1(x)))  # (bhw, 6, 1, 1)
        return x.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class UncertaintyPredictor(nn.Module):
    """MixtureDensityEstimatorFromUncertaintiesAndFlow (reference
    mod_uncertainty.py:184-225), output_channels=3."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv_0 = conv_block(in_channels, 32)
        self.conv_1 = conv_block(32, 16)
        self.predict_uncertainty_final = nn.Conv2d(16, 3, 3, padding=1)

    def forward(self, x: torch.Tensor):
        """-> (large log-variance (b, 1, h, w), weight map (b, 2, h, w))."""
        u = self.predict_uncertainty_final(self.conv_1(self.conv_0(x)))
        return u[:, 0:1], u[:, 1:]


def constrain_large_log_var_map(var_min: float, var_max: float, large_log_var_map):
    """log(var_min + (var_max - var_min) sigmoid(x - log(var_max)))
    (reference base_pdcnet.py:constrain_large_log_var_map)."""
    return torch.log(var_min + (var_max - var_min)
                     * torch.sigmoid(large_log_var_map - math.log(var_max)))


def p_r_of_mixture(weight_map, log_var_map, R: float = 1.0, gaussian: bool = False, dim: int = 1):
    """P_R of a K-mode mixture (reference mod_uncertainty.py:16-34), the
    modes on `dim`."""
    proba = torch.softmax(weight_map, dim=dim)
    var = torch.exp(log_var_map)
    if gaussian:
        p = proba * (1.0 - torch.exp(-(R ** 2) / (2.0 * var)))
    else:
        p = proba * (1.0 - torch.exp(-math.sqrt(2.0) * R / torch.sqrt(var))) ** 2
    return p.sum(dim=dim, keepdim=True)


def average_variance_of_mixture(weight_map, log_var_map, dim: int = 1):
    """reference mod_uncertainty.py:8-13."""
    return (torch.softmax(weight_map, dim=dim) * torch.exp(log_var_map)).sum(dim=dim, keepdim=True)
