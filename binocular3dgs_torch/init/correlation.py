"""Local windowed correlation (cost volume) and global correlation.

Counterpart of `binocular3dgs_tpu/init/correlation.py` (reference CuPy
`FunctionCorrelation`, `submodules/dense_matcher/models/modules/
local_correlation/correlation.py:15-241`), channels-last like it:

    out[b, y, x, d] = mean_c( ref[b, y, x, c] * query[b, y+dy, x+dx, c] )

for displacements (dx, dy) in [-md, md]^2, zero outside the image, channel
d = (dy + md) * (2 md + 1) + (dx + md). PDCNet+ (`init/pdcnet/`: the
LocalGOCor optimizer and the uncertainty decoders' input) is their caller;
they run at inference, and as plain torch they are differentiable anyway.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifts(x: torch.Tensor, md: int):
    """The (dy, dx) windows of x (B, H, W, C) zero-padded by md, row-major
    over (dy, dx)."""
    _, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, md, md, md, md))
    for dy in range(-md, md + 1):
        for dx in range(-md, md + 1):
            yield xp[:, md + dy:md + dy + H, md + dx:md + dx + W, :]


def local_correlation(ref: torch.Tensor, query: torch.Tensor, md: int = 4) -> torch.Tensor:
    """ref, query: (B, H, W, C) -> cost volume (B, H, W, (2 md + 1)^2)."""
    C = ref.shape[-1]
    return torch.stack([torch.sum(ref * q, dim=-1) / C for q in _shifts(query, md)], dim=-1)


def local_correlation_transpose(v: torch.Tensor, feat: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Adjoint of `local_correlation` in its first argument:

        out[b, y, x, c] = (1/C) sum_{dy,dx} v[b, y, x, d(dy, dx)] feat[b, y+dy, x+dx, c]

    v: (B, H, W, (2 md + 1)^2); feat: (B, H, W, C) -> (B, H, W, C)."""
    C = feat.shape[-1]
    out = torch.zeros_like(feat)
    for k, shifted in enumerate(_shifts(feat, md)):
        out = out + v[..., k:k + 1] * shifted
    return out / C


def global_correlation(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Every ref position against every query position: (B, H, W, H*W)
    (reference GlobalFeatureCorrelationLayer,
    `models/modules/feature_correlation_layer.py:75`). One matmul."""
    B, H, W, C = ref.shape
    corr = torch.matmul(ref.reshape(B, H * W, C), query.reshape(B, H * W, C).transpose(1, 2))
    return corr.reshape(B, H, W, H * W)
