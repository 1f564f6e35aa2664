"""Mapping/flow decoders and PWC refinement (reference models/modules/mod.py,
matching_modules.py, base_matching_net.py:379-411).

Counterpart of `binocular3dgs_tpu/init/pdcnet/decoders.py`. PDCNet_plus
uses the residual-connection variants (reference model_selection.py:157-171):
CMDTopResidualConnections for the global mapping decoder (decoder4),
OpticalFlowEstimatorResidualConnection for the flow decoders (decoder3/2/1)
and the dilated PWC refinement stacks dc_conv1-7 / l_dc_conv1-7. The
trunk's widths are the reference's: 128, 128, 96, 64, 32, with 1x1 skips
128 -> 96 and 96 -> 32; every block is a `conv_block`, the heads bare
Conv2d.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv_block


class _ResidualTrunk(nn.Module):
    """conv_0 .. conv_4 with two 1x1 skips (reference mod.py:116-144, 208-240)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv_0 = conv_block(in_channels, 128, act=False)
        self.conv0_skip = conv_block(128, 96, kernel_size=1, padding=0, act=False)
        self.conv_1 = conv_block(128, 128)
        self.conv_2 = conv_block(128, 96, act=False)
        self.conv2_skip = conv_block(96, 32, kernel_size=1, padding=0, act=False)
        self.conv_3 = conv_block(96, 64)
        self.conv_4 = conv_block(64, 32, act=False)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.conv_0(x)
        x2 = self.conv_2(self.conv_1(F.leaky_relu(x0, 0.1)))
        x2_skip = x2 + self.conv0_skip(x0)
        x4 = self.conv_4(self.conv_3(F.leaky_relu(x2_skip, 0.1)))
        x4_skip = x4 + self.conv2_skip(x2_skip)
        return F.leaky_relu(x4_skip, 0.1)


class CMDTopResidual(_ResidualTrunk):
    """CMDTopResidualConnections (output_x=True): x -> (32 ch, mapping 2 ch)."""

    def __init__(self, in_channels: int):
        super().__init__(in_channels)
        self.final = nn.Conv2d(32, 2, 3, padding=1)

    def forward(self, x):
        feats = self.trunk(x)
        return feats, self.final(feats)


class FlowEstimatorResidual(_ResidualTrunk):
    """OpticalFlowEstimatorResidualConnection: x -> (32 ch, flow 2 ch)."""

    def __init__(self, in_channels: int):
        super().__init__(in_channels)
        self.predict_flow = nn.Conv2d(32, 2, 3, padding=1)

    def forward(self, x):
        feats = self.trunk(x)
        return feats, self.predict_flow(feats)


DILATIONS = (1, 2, 4, 8, 16, 1)
_REFINEMENT_WIDTHS = (128, 128, 128, 96, 64, 32)


def add_pwc_refinement(module: nn.Module, stem: str, in_channels: int) -> None:
    """Register the PWC-Net context network's blocks on `module` as
    {stem}1 .. {stem}7 (their reference names sit at the model's top
    level): six dilated conv blocks and a flow head."""
    for i, (d, out_ch) in enumerate(zip(DILATIONS, _REFINEMENT_WIDTHS), start=1):
        module.add_module(f"{stem}{i}", conv_block(in_channels, out_ch, padding=d, dilation=d))
        in_channels = out_ch
    module.add_module(f"{stem}7", nn.Conv2d(in_channels, 2, 3, padding=1))


def pwc_refinement(module: nn.Module, stem: str, x: torch.Tensor):
    """The refinement registered by `add_pwc_refinement`: (32 ch, residual flow)."""
    for i in range(1, len(DILATIONS) + 1):
        x = getattr(module, f"{stem}{i}")(x)
    return x, getattr(module, f"{stem}7")(x)
