"""LPIPS perceptual metric — vgg / alex / squeeze backbones.

Counterpart of `binocular3dgs_tpu/eval/lpips.py` (reference `lpipsPyTorch/`,
LPIPS v0.1: backbone conv features captured after the reference's target
layers, imagenet z-score, unit-normalize along channels, 1x1 linear heads,
spatial mean, sum over layers; `metrics.py:105` uses net_type='vgg'). The
weights come from the JAX package's npz layout (its
`convert_backbone_weights` writes it from torchvision and richzhang state
dicts): `conv{i}.w` (HWIO) and `.b`, `fire{j}.{squeeze,expand1x1,expand3x3}.w`
and `.b`, `lin{l}.w` (C,), `net_type`. Nothing is downloaded:

    lpips_fn = make_lpips(load_lpips_weights("/path/to/weights.npz"), "vgg")

Convolutions run through `torch.nn.functional.conv2d` (cuDNN on the card,
with TF32 off: `binocular3dgs_torch.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# imagenet shift/scale used by LPIPS (reference lpipsPyTorch/modules/networks.py:39-43)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# Layer programs of the torchvision `features` sequentials, with "cap" at the
# reference's target layers (networks.py:61-88), as in the JAX package.
# ops: ("conv", stride, pad) ("relu",) ("pool", k, stride, ceil_mode)
# ("fire",) ("cap",)
_C = ("conv", 1, 1)
_R = ("relu",)
_P2 = ("pool", 2, 2, False)

NET_SPECS = {
    # torchvision vgg16.features; targets [4,9,16,23,30]
    "vgg": [
        _C, _R, _C, _R, ("cap",), _P2,
        _C, _R, _C, _R, ("cap",), _P2,
        _C, _R, _C, _R, _C, _R, ("cap",), _P2,
        _C, _R, _C, _R, _C, _R, ("cap",), _P2,
        _C, _R, _C, _R, _C, _R, ("cap",),
    ],
    # torchvision alexnet.features; targets [2,5,8,10,12]
    "alex": [
        ("conv", 4, 2), _R, ("cap",), ("pool", 3, 2, False),
        ("conv", 1, 2), _R, ("cap",), ("pool", 3, 2, False),
        _C, _R, ("cap",),
        _C, _R, ("cap",),
        _C, _R, ("cap",),
    ],
    # torchvision squeezenet1_1.features; targets [2,5,8,10,11,12,13]
    "squeeze": [
        ("conv", 2, 0), _R, ("cap",), ("pool", 3, 2, True),
        ("fire",), ("fire",), ("cap",), ("pool", 3, 2, True),
        ("fire",), ("fire",), ("cap",), ("pool", 3, 2, True),
        ("fire",), ("cap",), ("fire",), ("cap",),
        ("fire",), ("cap",), ("fire",), ("cap",),
    ],
}

N_CHANNELS = {
    "vgg": [64, 128, 256, 512, 512],
    "alex": [64, 192, 384, 256, 256],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}


# (in, out, kernel) of the plain convs and (in, squeeze, expand) of the
# Fire modules, in torchvision's order
_CONV_SHAPES = {
    "vgg": [(3, 64, 3), (64, 64, 3), (64, 128, 3), (128, 128, 3), (128, 256, 3),
            (256, 256, 3), (256, 256, 3), (256, 512, 3), (512, 512, 3), (512, 512, 3),
            (512, 512, 3), (512, 512, 3), (512, 512, 3)],
    "alex": [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)],
    "squeeze": [(3, 64, 3)],
}
_FIRE_SHAPES = {"squeeze": [(64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
                            (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256)]}


def random_lpips_weights(net_type: str, seed: int = 0) -> dict[str, np.ndarray]:
    """Weights of the npz layout drawn from `seed` (He-normal convolutions,
    small biases, positive linear heads): an LPIPS of the right shapes for
    checks where no trained weights are at hand. Not a perceptual metric."""
    rng = np.random.default_rng(seed)
    out = {"net_type": np.asarray(net_type)}

    def conv(name, cin, cout, k):
        out[f"{name}.w"] = (rng.normal(size=(k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cin))
                            ).astype(np.float32)
        out[f"{name}.b"] = (rng.normal(size=cout) * 0.01).astype(np.float32)

    for i, (cin, cout, k) in enumerate(_CONV_SHAPES[net_type]):
        conv(f"conv{i}", cin, cout, k)
    for j, (cin, sq, ex) in enumerate(_FIRE_SHAPES.get(net_type, [])):
        conv(f"fire{j}.squeeze", cin, sq, 1)
        conv(f"fire{j}.expand1x1", sq, ex, 1)
        conv(f"fire{j}.expand3x3", sq, ex, 3)
    for l, c in enumerate(N_CHANNELS[net_type]):
        out[f"lin{l}.w"] = rng.uniform(0.0, 1.0, c).astype(np.float32)
    return out


def load_lpips_weights(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class LPIPS(torch.nn.Module):
    """lpips(img1, img2) of (H, W, 3) images in [0, 1] (a 0-d tensor) or of
    (B, H, W, 3) batches (a (B,) tensor). The reference feeds [0, 1] images
    straight into the z-score (networks.py:50-53)."""

    def __init__(self, weights: dict[str, np.ndarray], net_type: str):
        super().__init__()
        if net_type not in NET_SPECS:
            raise ValueError(f"unknown LPIPS backbone {net_type!r}")
        self.net_type = net_type
        self.register_buffer("shift", torch.from_numpy(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(SCALE).view(1, 3, 1, 1))
        for k, v in weights.items():
            if k.endswith(".w") and k.startswith(("conv", "fire")):
                v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
            elif not k.endswith((".w", ".b")):
                continue  # net_type
            self.register_buffer(k.replace(".", "_"),
                                 torch.from_numpy(np.ascontiguousarray(v, np.float32)))

    def _conv(self, x, name, stride, pad):
        w, b = getattr(self, f"{name}_w"), getattr(self, f"{name}_b")
        return F.conv2d(x, w, b, stride=stride, padding=pad)

    def _fire(self, x, name):
        """torchvision squeezenet Fire: 1x1 squeeze -> relu -> parallel 1x1
        and 3x3 (pad 1) expands -> relu -> channel concat."""
        s = F.relu(self._conv(x, f"{name}_squeeze", 1, 0))
        return torch.cat([F.relu(self._conv(s, f"{name}_expand1x1", 1, 0)),
                          F.relu(self._conv(s, f"{name}_expand3x3", 1, 1))], dim=1)

    def features(self, x):
        """x: (B, 3, H, W) in [0, 1] -> the captured feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        ci = fi = 0
        for op in NET_SPECS[self.net_type]:
            kind = op[0]
            if kind == "conv":
                x = self._conv(x, f"conv{ci}", op[1], op[2])
                ci += 1
            elif kind == "relu":
                x = F.relu(x)
            elif kind == "pool":
                x = F.max_pool2d(x, op[1], op[2], ceil_mode=op[3])
            elif kind == "fire":
                x = self._fire(x, f"fire{fi}")
                fi += 1
            else:  # cap
                feats.append(x)
        return feats

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        single = img1.dim() == 3
        x = (img1[None] if single else img1).permute(0, 3, 1, 2)
        y = (img2[None] if single else img2).permute(0, 3, 1, 2)
        total = 0.0
        for l, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            # reference normalize_activation: x / (sqrt(sum x^2) + eps)
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            lin = getattr(self, f"lin{l}_w").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1), dim=(1, 2))
        return total[0] if single else total


def make_lpips(weights: dict[str, np.ndarray], net_type: str | None = None,
               device: str | torch.device = "cuda") -> LPIPS:
    """The LPIPS module on `device`. net_type defaults to the tag stored by
    the JAX package's converter, else 'vgg' (the metrics.py path)."""
    if net_type is None:
        net_type = str(weights.get("net_type", "vgg"))
    return LPIPS(weights, net_type).to(resolve_device(device))
