"""Evaluation: PSNR / SSIM over rendered test sets.

Counterpart of `binocular3dgs_tpu/eval/metrics.py` (reference
`metrics.py:37-124`, `read_eval_result.py`): per-method directories of
renders + gt, DTU idrmask compositing (render*m + (1-m)), masked PSNR,
results.json / per_view.json, and cross-scene aggregation. LPIPS is
computed by `lpips_fn` when one is given (eval/lpips.py, from supplied
weights) and reported as null otherwise.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..ops.losses import psnr, ssim


def _load_image(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32)[..., :3] / 255.0


def _load_mask(path, size):
    from PIL import Image

    with Image.open(path) as im:
        im = im.resize(size)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr > 0.5).astype(np.float32)[..., None]


def find_idr_mask(idrmasks_path: str, scan_name: str, idx: int):
    """DTU idrmasks layout (reference `metrics.py:69-86`): either
    <root>/<scan>/mask/<idx:03d>.png or <root>/<scan>/<idx:03d>.png."""
    for cand in (
        os.path.join(idrmasks_path, scan_name, "mask", f"{idx:03d}.png"),
        os.path.join(idrmasks_path, scan_name, f"{idx:03d}.png"),
    ):
        if os.path.exists(cand):
            return cand
    return None


def evaluate_dir(
    scene_dir: str,
    dataset_name: str = "LLFF",
    idrmasks_path: str | None = None,
    lpips_fn=None,
    save_masked: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Evaluate every method under <scene_dir>/test/ (reference `evaluate`)
    and write results.json and per_view.json beside it. `lpips_fn(render,
    gt)` takes (H, W, 3) tensors on `device`."""
    device = resolve_device(device)
    full = {}
    per_view = {}
    test_dir = Path(scene_dir) / "test"
    scan_name = os.path.basename(os.path.normpath(scene_dir)).split("_")[0]

    def planar(a):
        return torch.as_tensor(np.ascontiguousarray(a.transpose(2, 0, 1)), device=device)

    for method in sorted(os.listdir(test_dir)):
        method_dir = test_dir / method
        renders_dir = method_dir / "renders"
        gt_dir = method_dir / "gt"
        if not renders_dir.is_dir():
            continue
        names = sorted(os.listdir(renders_dir))
        ssims, psnrs, lpipss = [], [], []
        for idx, name in enumerate(names):
            render = _load_image(renders_dir / name)
            gt = _load_image(gt_dir / name)
            mask = None
            if dataset_name == "DTU" and idrmasks_path:
                mpath = find_idr_mask(idrmasks_path, scan_name, idx)
                if mpath:
                    mask = _load_mask(mpath, (render.shape[1], render.shape[0]))
                    render = render * mask + (1 - mask)
                    gt = gt * mask + (1 - mask)
                    if save_masked:
                        from PIL import Image

                        os.makedirs(method_dir / "masked", exist_ok=True)
                        Image.fromarray((render * 255).astype(np.uint8)).save(
                            method_dir / "masked" / f"{idx:05d}.png"
                        )
            r, g = planar(render), planar(gt)
            m = planar(mask) if mask is not None else None
            ssims.append(float(ssim(r, g)))
            psnrs.append(float(psnr(r, g, mask=m)))
            if lpips_fn is not None:
                lpipss.append(float(lpips_fn(torch.as_tensor(render, device=device),
                                             torch.as_tensor(gt, device=device))))
        full[method] = {
            "SSIM": float(np.mean(ssims)) if ssims else None,
            "PSNR": float(np.mean(psnrs)) if psnrs else None,
            "LPIPS": float(np.mean(lpipss)) if lpipss else None,
        }
        per_view[method] = {
            "SSIM": dict(zip(names, ssims)),
            "PSNR": dict(zip(names, psnrs)),
            "LPIPS": dict(zip(names, lpipss)) if lpipss else {},
        }

    with open(os.path.join(scene_dir, "results.json"), "w") as f:
        json.dump(full, f, indent=True)
    with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
        json.dump(per_view, f, indent=True)
    return full


def aggregate_results(model_paths: list[str], method: str | None = None) -> dict:
    """Cross-scene averages (reference `read_eval_result.py` behavior)."""
    rows = {}
    for path in model_paths:
        rp = os.path.join(path, "results.json")
        if not os.path.exists(rp):
            continue
        with open(rp) as f:
            res = json.load(f)
        for m in [method] if method else list(res.keys()):
            if m in res:
                rows.setdefault(m, []).append(res[m])
    out = {}
    for m, entries in rows.items():
        out[m] = {
            k: float(np.mean([e[k] for e in entries if e.get(k) is not None]))
            if any(e.get(k) is not None for e in entries)
            else None
            for k in ("SSIM", "PSNR", "LPIPS")
        }
        out[m]["n_scenes"] = len(entries)
    return out
