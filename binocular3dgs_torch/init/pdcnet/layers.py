"""NN primitives of the PDCNet+ port (NCHW, inference mode).

Counterpart of `binocular3dgs_tpu/init/pdcnet/layers.py`, which rebuilds
torch's ops in JAX; here they are torch's own:

  conv_block           reference models/modules/mod.py:conv — Conv2d,
                       eval-mode BatchNorm2d and LeakyReLU(0.1) as an
                       nn.Sequential, so its state_dict names are
                       {prefix}.0.* (conv) and {prefix}.1.* (BN)
  l2norm               FeatureL2Norm: x / sqrt(sum_c x^2 + 1e-6)
  resize_bilinear      F.interpolate(mode="bilinear"), no antialias
  resize_area          F.interpolate(mode="area")
  grid_sample_bilinear F.grid_sample(bilinear, zeros, align_corners=True)
  warp                 flow warp (reference base_matching_net.py:228-262)
  flow <-> mapping     reference flow_and_mapping_operations.py:53,126

Flows and mappings are (B, 2, H, W) in pixels, channel 0 horizontal.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_block(in_ch: int, out_ch: int, kernel_size: int = 3, padding: int = 1,
               dilation: int = 1, act: bool = True) -> nn.Sequential:
    """Conv2d + BatchNorm2d [+ LeakyReLU(0.1)]; JAX `conv_block` with
    bn=True and act "leaky" (act=True) or None (act=False)."""
    layers = [nn.Conv2d(in_ch, out_ch, kernel_size, padding=padding, dilation=dilation),
              nn.BatchNorm2d(out_ch)]
    if act:
        layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


def l2norm(x: torch.Tensor, dim: int = 1, eps: float = 1e-6) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(int(s) for s in out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_area(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Adaptive average pooling: output cell (i, j) averages input rows
    [floor(i H / h), ceil((i + 1) H / h)) and the same columns."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(int(s) for s in out_hw), mode="area")


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W); grid: (B, h, w, 2) normalized (gx, gy) in [-1, 1]."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def pixel_grid(H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    """(1, 2, H, W): channel 0 the column, channel 1 the row."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=like.dtype, device=like.device),
                            torch.arange(W, dtype=like.dtype, device=like.device),
                            indexing="ij")
    return torch.stack([xs, ys])[None]


def sample_by_mapping(x: torch.Tensor, mapping: torch.Tensor, norm_hw=None) -> torch.Tensor:
    """x sampled at the absolute pixel positions `mapping` (B, 2, h, w)
    (reference pixel_wise_mapping.py:99-126); positions are normalized by
    `norm_hw`, x's own (H, W) unless given."""
    H, W = x.shape[-2:] if norm_hw is None else norm_hw
    gx = 2.0 * mapping[:, 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * mapping[:, 1] / max(H - 1, 1) - 1.0
    return grid_sample_bilinear(x, torch.stack([gx, gy], dim=-1))


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)), bilinear, zero outside; positions normalized
    by the flow's size, as the JAX `warp`."""
    return sample_by_mapping(x, convert_flow_to_mapping(flow), flow.shape[-2:])


def convert_flow_to_mapping(flow: torch.Tensor) -> torch.Tensor:
    return flow + pixel_grid(flow.shape[-2], flow.shape[-1], flow)


def convert_mapping_to_flow(mapping: torch.Tensor) -> torch.Tensor:
    return mapping - pixel_grid(mapping.shape[-2], mapping.shape[-1], mapping)


def unnormalise_mapping_and_convert_to_flow(nmap: torch.Tensor) -> torch.Tensor:
    """nmap (B, 2, H, W) in [-1, 1] -> pixel flow (reference
    models/modules/mod.py:unnormalise_and_convert_mapping_to_flow)."""
    H, W = nmap.shape[-2:]
    mx = (nmap[:, 0] + 1.0) * (W - 1) / 2.0
    my = (nmap[:, 1] + 1.0) * (H - 1) / 2.0
    return torch.stack([mx, my], dim=1) - pixel_grid(H, W, nmap)
