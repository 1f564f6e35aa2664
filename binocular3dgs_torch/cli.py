"""Command-line entry points of the port.

Same subcommands and flags as `binocular3dgs_tpu/cli.py`, plus `--device`
(default `cuda`; with no GPU present a CUDA run raises, it does not carry on
on the CPU):

  python -m binocular3dgs_torch.cli render    -m <model> -s <scene> [--eval]
  python -m binocular3dgs_torch.cli metrics   -m <model> [...]
  python -m binocular3dgs_torch.cli aggregate -m <model> [...]

`train`, `spiral`, `triangulate` and `run` are not ported yet: they print so
and exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import resolve_device
from .config import Config, load_config

NOT_PORTED = ("train", "spiral", "triangulate", "run")


def _add_common_model_flags(p: argparse.ArgumentParser):
    # None / False = keep the value of the model's cfg_args.json (or the
    # default ModelConfig when there is none)
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default=None)
    p.add_argument("--resolution", "-r", type=int, default=None)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--sh_degree", type=int, default=None)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu on request)")


def _load_trained(args, device):
    from .models.gaussians import load_ply

    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    cfg = load_config(cfg_path) if os.path.exists(cfg_path) else Config()
    cfg.model.model_path = args.model_path
    if args.source_path:
        cfg.model.source_path = os.path.abspath(args.source_path)
    # a flag given on the command line overrides the training run's setting
    for k in ("images", "resolution", "sh_degree", "white_background", "eval"):
        v = getattr(args, k)
        if v is not None and v is not False:
            setattr(cfg.model, k, v)

    pc_root = os.path.join(args.model_path, "point_cloud")
    if args.iteration == -1:
        iteration = max(
            int(d.split("_")[-1]) for d in os.listdir(pc_root) if d.startswith("iteration_")
        )
    else:
        iteration = args.iteration
    print(f"Loading trained model at iteration {iteration}")
    ply = os.path.join(pc_root, f"iteration_{iteration}", "point_cloud.ply")
    model = load_ply(ply, max_sh_degree=cfg.model.sh_degree, device=device)
    return cfg, model, iteration


def _save_png(arr, path):
    """arr: (H, W, 3) host array or (3, H, W) planar tensor/array."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = arr.transpose(1, 2, 0)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def cmd_render(argv):
    # reference render.py
    p = argparse.ArgumentParser("render")
    _add_common_model_flags(p)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--n_views", type=int, default=None)
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .data.dataset import Scene
    from .ops.rasterize import render_tiled

    device = resolve_device(args.device)
    cfg, model, iteration = _load_trained(args, device)
    if args.dataset_name:
        cfg.train.dataset_name = args.dataset_name
    if args.n_views is not None:
        cfg.train.n_views = args.n_views
    scene = Scene.load(cfg, shuffle=False, device=device)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, device=device)

    def render_set(name, views):
        base = os.path.join(cfg.model.model_path, name, f"ours_{iteration}")
        for idx, v in enumerate(views):
            out = render_tiled(v.camera, model, bg, raster=cfg.raster, device=device)
            _save_png(out.image, os.path.join(base, "renders", f"{idx:05d}.png"))
            if v.image is not None:
                _save_png(v.image, os.path.join(base, "gt", f"{idx:05d}.png"))

    if not args.skip_train:
        render_set("train", scene.train_views)
    if not args.skip_test:
        render_set("test", scene.test_views)
    return 0


def cmd_metrics(argv):
    # reference metrics.py
    p = argparse.ArgumentParser("metrics")
    p.add_argument("--model_paths", "-m", nargs="+", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="LLFF")
    p.add_argument("--idrmasks_path", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .eval.metrics import evaluate_dir

    device = resolve_device(args.device)
    print("LPIPS is not ported — reporting LPIPS as null")
    failed = 0
    for scene_dir in args.model_paths:
        print("Scene:", scene_dir)
        try:
            res = evaluate_dir(
                scene_dir, dataset_name=args.dataset_name,
                idrmasks_path=args.idrmasks_path, device=device,
            )
        except (OSError, ValueError) as e:  # one unreadable scene does not stop the rest
            print("Unable to compute metrics for model", scene_dir, f"({e})")
            failed += 1
            continue
        for method, entry in res.items():
            print(f"  {method}: {json.dumps(entry)}")
    return 1 if failed else 0


def cmd_aggregate(argv):
    # reference read_eval_result.py
    p = argparse.ArgumentParser("aggregate")
    p.add_argument("--model_paths", "-m", nargs="+", type=str, required=True)
    p.add_argument("--method", type=str, default=None)
    args = p.parse_args(argv)
    from .eval.metrics import aggregate_results

    print(json.dumps(aggregate_results(args.model_paths, args.method), indent=2))
    return 0


COMMANDS = {
    "render": cmd_render,
    "metrics": cmd_metrics,
    "aggregate": cmd_aggregate,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"'{argv[0]}' is not yet ported to binocular3dgs_torch; "
              f"use python -m binocular3dgs_tpu.cli {argv[0]}")
        return 2
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m binocular3dgs_torch.cli {{{','.join(COMMANDS)}}} ...")
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main() or 0)
