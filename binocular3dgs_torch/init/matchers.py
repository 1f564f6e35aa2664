"""Dense matchers for the initialization pipeline.

Counterpart of `binocular3dgs_tpu/init/matchers.py`, with the same
constructor and `get_matches_and_confidence` contract (the reference dict
{kp_source, kp_target, confidence_value}, float32 numpy arrays ordered by
confidence):

  * `FarnebackMatcher` — dense Farneback flow both ways (the port's own,
    `init/farneback.py`, in place of `cv2.calcOpticalFlowFarneback`) at a
    quarter of the resolution, a stride grid, forward-backward cyclic
    consistency as confidence; on the device given as `device`. The arrays
    follow the JAX version's dtypes (positions float32, the cyclic error
    float64). Matches of equal confidence keep their grid order (a stable
    sort), where numpy's argsort leaves ties in an order of its own, so
    the rows of the two packages agree as sets, not index by index.
  * `PDCNetPlusMatcher` — PDCNet+ (`init/pdcnet/`) from a checkpoint
    (a reference `.pth`, or the npz both packages read), on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .farneback import calc_optical_flow_farneback
from .image_io import resize_linear_u8, rgb_to_gray_u8


class FarnebackMatcher:
    """Farneback pyramidal dense flow + cyclic-consistency confidence."""

    def __init__(self, scaling: float = 0.25, cyclic_thresh: float = 1.5, stride: int = 2,
                 device: str | torch.device = "cuda"):
        self.scaling = scaling
        self.cyclic_thresh = cyclic_thresh
        self.stride = stride
        self.device = resolve_device(device)

    def _flow(self, a_gray: torch.Tensor, b_gray: torch.Tensor) -> torch.Tensor:
        return calc_optical_flow_farneback(
            a_gray, b_gray, pyr_scale=0.5, levels=5, winsize=21, iterations=5,
            poly_n=7, poly_sigma=1.5,
        )

    def _gray(self, image, size):
        """The (h, w) uint8 grey image of an (H, W, 3) uint8 image (numpy or
        tensor; float values in [0, 255] are truncated, as numpy casts)."""
        img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
        return rgb_to_gray_u8(resize_linear_u8(img.to(self.device).to(torch.uint8), size))

    def get_matches_and_confidence(self, ref_image, src_image) -> dict:
        """ref/src: (H, W, 3) uint8 or float [0, 255]. Returns matches at the
        (possibly downscaled) working resolution mapped back to full res."""
        H, W = ref_image.shape[:2]
        s = self.scaling
        size = (max(8, int(W * s)), max(8, int(H * s)))
        ref_g, src_g = self._gray(ref_image, size), self._gray(src_image, size)

        fwd = self._flow(ref_g, src_g)  # ref -> src
        bwd = self._flow(src_g, ref_g)

        h, w = ref_g.shape
        dev = self.device
        yi, xi = torch.meshgrid(torch.arange(0, h, self.stride, device=dev),
                                torch.arange(0, w, self.stride, device=dev), indexing="ij")
        yi, xi = yi.reshape(-1), xi.reshape(-1)
        xs, ys = xi.float(), yi.float()
        tx, ty = xs + fwd[yi, xi, 0], ys + fwd[yi, xi, 1]
        inb = (tx >= 0) & (tx < w - 1) & (ty >= 0) & (ty < h - 1)

        # cyclic error: follow bwd flow from the target position back
        txi = torch.clamp(tx, 0, w - 1.001)
        tyi = torch.clamp(ty, 0, h - 1.001)
        x0, y0 = txi.long(), tyi.long()
        wx, wy = txi.double() - x0, tyi.double() - y0
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)

        def bilerp(ch):
            f = bwd[..., ch]
            return (f[y0, x0] * (1 - wx) * (1 - wy) + f[y0, x1] * wx * (1 - wy)
                    + f[y1, x0] * (1 - wx) * wy + f[y1, x1] * wx * wy)

        bx, by = bilerp(0), bilerp(1)
        err = torch.sqrt((tx.double() + bx - xs.double()) ** 2
                         + (ty.double() + by - ys.double()) ** 2)
        good = inb & (err < self.cyclic_thresh)

        conf = 1.0 / (1.0 + err[good])
        scale_back = torch.tensor([W / w, H / h], dtype=torch.float64, device=dev)
        kp_src = torch.stack([xs[good], ys[good]], 1).double() * scale_back
        kp_tgt = torch.stack([tx[good], ty[good]], 1).double() * scale_back
        order = torch.sort(-conf, stable=True).indices
        return {
            "kp_source": kp_src[order].float().cpu().numpy(),
            "kp_target": kp_tgt[order].float().cpu().numpy(),
            "confidence_value": conf[order].float().cpu().numpy(),
        }


class PDCNetPlusMatcher:
    """PDCNet+ (`init/pdcnet/`); needs a checkpoint (reference .pth, or
    the npz of `python -m binocular3dgs_torch.init.pdcnet.convert`)."""

    def __init__(self, weights_path: str | None = None, device: str | torch.device = "cuda",
                 **inference_parameters):
        if weights_path is None:
            raise ValueError(
                "PDCNet+ inference requires a checkpoint (reference "
                "pre_trained_models/PDCNet_plus_megadepth.pth or a converted "
                ".npz); use FarnebackMatcher for a weight-free classical "
                "fallback."
            )
        from .pdcnet import PDCNetPlus

        self.net = PDCNetPlus(weights_path, inference_parameters or None, device=device)

    def get_matches_and_confidence(self, ref_image, src_image) -> dict:
        """The matches in the pipeline's convention, FarnebackMatcher's:
        kp_source in ref_image, kp_target in src_image. PDCNetPlus returns
        them the other way round (the reference's base_pdcnet names:
        kp_target in the flow's frame, ref_image), so they are exchanged
        here. The JAX package passes them on unexchanged, and its
        `triangulate_pairs` then pairs the source view's points with the
        reference camera (ROADMAP C; tests/test_torch_pdcnet_inference.py)."""
        pred = self.net.get_matches_and_confidence(ref_image, src_image)
        return {"kp_source": pred["kp_target"], "kp_target": pred["kp_source"],
                "confidence_value": pred["confidence_value"]}


def select_matcher(name: str = "farneback", **kwargs):
    """reference `model_selection.select_model` analog."""
    if name in ("farneback", "classical"):
        return FarnebackMatcher(**kwargs)
    if name in ("PDCNet_plus", "pdcnet_plus", "pdcnet"):
        return PDCNetPlusMatcher(**kwargs)
    raise ValueError(f"unknown matcher: {name}")
