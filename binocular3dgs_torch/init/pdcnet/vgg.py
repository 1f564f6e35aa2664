"""VGG-16 feature pyramid (reference models/feature_backbones/VGG_features.py:6-54).

Counterpart of `binocular3dgs_tpu/init/pdcnet/vgg.py`. torchvision's VGG-16
`features` stack cut into blocks, each an nn.Sequential, so the state_dict
names are {root}.level_{i}.{j}.weight/bias with the convolutions at j = 0,
2, 4:

  level_0: conv(3->64), relu                      -> 64 ch  @ full res
  level_1: conv(64->64), relu, maxpool            -> 64 ch  @ 1/2
  level_2: conv(64->128), relu, conv, relu, pool  -> 128 ch @ 1/4
  level_3: 3 x (conv, relu) to 256, maxpool       -> 256 ch @ 1/8
  level_4: 3 x (conv, relu) to 512, maxpool       -> 512 ch @ 1/16

PDCNet+ reads levels 0-3 of the image pyramid (`eigth_resolution`) and all
five of the 256x256 one, so the image pyramid is built with 4 levels: its
state_dict holds exactly the names the forward reads. A reference
checkpoint's `pyramid.level_4.*` is left out at load (convert.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

_LEVEL_CHANNELS = ((64,), (64,), (128, 128), (256, 256, 256), (512, 512, 512))


class VGGPyramid(nn.Module):
    def __init__(self, n_levels: int = 5):
        super().__init__()
        in_ch = 3
        for i, widths in enumerate(_LEVEL_CHANNELS[:n_levels]):
            layers = []
            for out_ch in widths:
                layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU()]
                in_ch = out_ch
            if i > 0:
                layers.append(nn.MaxPool2d(2, 2))
            self.add_module(f"level_{i}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, 3, H, W) ImageNet-normalized -> every level's output."""
        outputs = []
        for level in self.children():
            x = level(x)
            outputs.append(x)
        return outputs
