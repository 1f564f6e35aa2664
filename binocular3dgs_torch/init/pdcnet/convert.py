"""PDCNet+ weights across packages: the reference checkpoint, the port's
state_dict and the JAX package's npz.

Counterpart of `binocular3dgs_tpu/init/pdcnet/convert.py`. The port's
PDCNetModel holds the reference's native layouts (Conv2d OIHW,
ConvTranspose2d IOHW), so a reference `.pth` loads as it is; the JAX
package's layout is

  Conv2d weight      (O, I, kH, kW) -> (kH, kW, I, O)  [HWIO]
  ConvTranspose2d    (I, O, kH, kW) -> spatially flipped (kH, kW, I, O)
  everything else    unchanged; num_batches_tracked left out

and the port carries its own copy of that mapping both ways, so one npz
serves both packages:

  python -m binocular3dgs_torch.init.pdcnet.convert ckpt.pth out.npz
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's ConvTranspose2d modules (PDCNet.py: deconv4/deconv2 and
# upfeat2; the others for completeness, as the JAX converter lists them)
_DECONV_PREFIXES = ("deconv4", "deconv2", "deconv3", "deconv1", "upfeat1", "upfeat2")
# in a reference checkpoint and read by no forward: PDCNet+ takes the image
# pyramid to 1/8 (levels 0-3)
_UNUSED_PREFIXES = ("pyramid.level_4.",)


def _is_filter(name: str, v: np.ndarray) -> bool:
    return name.endswith((".weight", "weight1", "weight2")) and v.ndim == 4


def _is_deconv(name: str) -> bool:
    return name.split(".", 1)[0] in _DECONV_PREFIXES


def jax_params_from_state_dict(state_dict) -> dict:
    """torch-layout state_dict (tensors or arrays) -> the JAX package's
    params (float32 numpy), num_batches_tracked left out."""
    out = {}
    for name, value in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        v = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        if _is_filter(name, v):
            v = (v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if _is_deconv(name)
                 else v.transpose(2, 3, 1, 0))
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    return out


def state_dict_from_jax_params(params) -> dict:
    """The inverse: JAX params -> torch-layout float32 tensors (a deconv's
    pre-flipped HWIO back to un-flipped IOHW, a conv's HWIO to OIHW)."""
    out = {}
    for name, value in params.items():
        v = np.asarray(value)
        if _is_filter(name, v):
            v = (v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1] if _is_deconv(name)
                 else v.transpose(3, 2, 0, 1))
        out[name] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return out


def load_checkpoint(path: str) -> dict:
    """A torch-layout state_dict from a reference checkpoint (`.pth` /
    `.pth.tar`: the `state_dict` entry if there is one, DataParallel's
    `module.` prefix stripped) or from the JAX package's npz. Only tensors
    are unpickled (`weights_only`)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return state_dict_from_jax_params({k: z[k] for k in z.files})
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def load_into(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """Load a torch-layout state_dict into `model`: every name the model
    has must be there (KeyError names the first missing), except
    BatchNorm's num_batches_tracked, which inference never reads and the
    npz does not carry; names the forward never reads (`pyramid.level_4`)
    are dropped; any other name raises."""
    own = model.state_dict()
    sd = {k: v for k, v in state_dict.items() if not k.startswith(_UNUSED_PREFIXES)}
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing:
        raise KeyError(f"PDCNet+ weights lack {missing[0]} ({len(missing)} names missing)")
    if unexpected:
        raise KeyError(f"PDCNet+ weights have unknown names: {unexpected[:5]}")
    for k, v in own.items():
        sd.setdefault(k, v)
    model.load_state_dict(sd)
    return model


def save_npz(state_dict: dict, path: str) -> None:
    """Write a torch-layout state_dict as the JAX package's npz."""
    np.savez(path, **jax_params_from_state_dict(state_dict))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Convert a PDCNet+ checkpoint to the npz layout "
                                            "both packages load")
    p.add_argument("checkpoint")
    p.add_argument("output")
    args = p.parse_args(argv)
    save_npz(load_checkpoint(args.checkpoint), args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
