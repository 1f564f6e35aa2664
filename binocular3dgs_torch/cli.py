"""Command-line entry points of the port.

Same subcommands and flags as `binocular3dgs_tpu/cli.py`, plus `--device`
(default `cuda`; with no GPU present a CUDA run raises, it does not carry on
on the CPU):

  python -m binocular3dgs_torch.cli train       -s <scene> -m <model> [...]
  python -m binocular3dgs_torch.cli triangulate -s <scene> [--output_path <dir>] [...]
  python -m binocular3dgs_torch.cli render    -m <model> [-s <scene>]
  python -m binocular3dgs_torch.cli spiral    -m <model> [--n_frames N] [...]
  python -m binocular3dgs_torch.cli metrics   -m <model> [--lpips_weights <npz>]
  python -m binocular3dgs_torch.cli aggregate -m <model> [...]
  python -m binocular3dgs_torch.cli run       --dataset_name LLFF --data_path <dir> [...]

`train` writes `cfg_args.json`, checkpoints at `--checkpoint_iterations`,
resumes from `--start_checkpoint <path|latest>` (a checkpoint of either
package) and traces its first iterations into `--profile_dir` (the
profiler's `trace.json`, with the program's ranges, and `ranges.json`, its
ranges and counters as `tracing.snapshot()` gives them); `render` and
`spiral` read the model settings from that file alone, as the JAX CLI does
(their `--eval`, `-r`, `-i`, `-w` and `--sh_degree` are accepted and
ignored; `-m` and `-s` apply). `train` leaves out the TPU-only `--backend`,
`--max_pairs_per_tile` and `--raster_chunk`. `triangulate` has the
Farneback matcher and, with `--matcher pdcnet --pdcnet_weights <.pth or
.npz>`, PDCNet+ (without weights it raises, as the JAX CLI does). `run`
(orchestrate.py) drives triangulate, train, render and metrics per scene,
each a `binocular3dgs_torch.cli` process on `--device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config import Config, load_config, save_config

def _add_common_model_flags(p: argparse.ArgumentParser):
    # reference arguments/__init__.py:47-91
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--sh_degree", type=int, default=1)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu on request)")


def cmd_train(argv):
    # reference train.py:263-298
    p = argparse.ArgumentParser("train")
    _add_common_model_flags(p)
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--position_lr_init", type=float, default=0.00016)
    p.add_argument("--position_lr_final", type=float, default=0.0000016)
    p.add_argument("--position_lr_max_steps", type=int, default=30_000)
    p.add_argument("--feature_lr", type=float, default=0.0025)
    p.add_argument("--opacity_lr", type=float, default=0.05)
    p.add_argument("--scaling_lr", type=float, default=0.005)
    p.add_argument("--rotation_lr", type=float, default=0.001)
    p.add_argument("--percent_dense", type=float, default=0.01)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--densify_from_iter", type=int, default=500)
    p.add_argument("--densify_until_iter", type=int, default=15_000)
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--test_iterations", nargs="+", type=int, default=[30_000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[30_000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--opacity_decay", action="store_true", default=True)
    p.add_argument("--opacity_decay_factor", type=float, default=0.995)
    p.add_argument("--cam_trans_dist", type=float, default=0.4)
    p.add_argument("--binocular_consistency", action="store_true", default=True)
    p.add_argument("--shift_cam_start", type=int, default=20_000)
    p.add_argument("--dataset_name", type=str, default="LLFF")
    p.add_argument("--n_views", type=int, default=3)
    p.add_argument("--suffix", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pairs_per_gaussian", type=int, default=12)
    p.add_argument("--fused_steps", type=int, default=0,
                   help="most steps the trainer runs between two host reads of the card "
                        "(0: the densification interval; 1: a read after every step)")
    p.add_argument("--debug", action="store_true",
                   help="dump the state and abort on a non-finite loss "
                        "(reference --detect_anomaly)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first ~200 iterations here")
    p.add_argument("--quiet", "-q", action="store_true")
    _add_device_flag(p)
    args = p.parse_args(argv)

    cfg = Config()
    m = cfg.model
    m.source_path = os.path.abspath(args.source_path) if args.source_path else ""
    for k in ("model_path", "images", "resolution", "white_background", "eval", "sh_degree"):
        setattr(m, k, getattr(args, k))
    for k in (
        "iterations", "position_lr_init", "position_lr_final", "position_lr_max_steps",
        "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr", "percent_dense",
        "lambda_dssim", "densification_interval", "densify_from_iter",
        "densify_until_iter", "densify_grad_threshold",
    ):
        setattr(cfg.opt, k, getattr(args, k))
    t = cfg.train
    for k in (
        "opacity_decay", "opacity_decay_factor", "cam_trans_dist", "binocular_consistency",
        "shift_cam_start", "dataset_name", "n_views", "suffix", "seed", "fused_steps",
        "start_checkpoint",
    ):
        setattr(t, k, getattr(args, k))
    t.test_iterations = tuple(args.test_iterations)
    t.save_iterations = tuple(args.save_iterations) + (args.iterations,)
    t.checkpoint_iterations = tuple(args.checkpoint_iterations)
    cfg.raster.pairs_per_gaussian = args.pairs_per_gaussian
    cfg.pipeline.debug = args.debug

    from .data.dataset import Scene
    from .train.loop import Trainer, find_latest_checkpoint

    device = resolve_device(args.device)
    if m.model_path:
        os.makedirs(m.model_path, exist_ok=True)
        save_config(cfg, os.path.join(m.model_path, "cfg_args.json"))
    print(f"Optimizing {m.model_path}")
    trainer = Trainer(cfg, Scene.load(cfg, device=device), device=device)
    first_iter = 0
    ckpt_path = args.start_checkpoint
    if ckpt_path == "latest":
        ckpt_path = find_latest_checkpoint(m.model_path)
        if ckpt_path is None:
            print("No checkpoint found; starting fresh")
    if ckpt_path:
        first_iter = trainer.load_checkpoint(ckpt_path)
        print(f"Resumed from {ckpt_path} at iteration {first_iter}")

    def progress(entry):
        if not args.quiet:
            print(f"iter {entry.iteration}: loss {entry.loss:.6f} "
                  f"disp {entry.disparity_loss:.6f} points {entry.points} "
                  f"({entry.iters_per_sec:.2f} it/s)", flush=True)

    if args.profile_dir:
        from . import tracing

        n_prof = min(args.iterations, first_iter + 200)
        t_prof = time.time_ns()
        with _profile(device) as prof:
            trainer.train(n_prof, progress=progress, first_iteration=first_iter + 1)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
        # the program's ranges (in trace.json too) and its counters, on the
        # trace's clock
        with open(os.path.join(args.profile_dir, "ranges.json"), "w") as f:
            json.dump(tracing.snapshot(since_ns=t_prof), f)
        first_iter = n_prof
        print(f"profiler trace written to {args.profile_dir}")
    trainer.train(args.iterations, progress=progress, first_iteration=first_iter + 1)
    if m.model_path and trainer.log:
        with open(os.path.join(m.model_path, "train_log.json"), "w") as f:
            json.dump([dataclasses.asdict(e) for e in trainer.log], f)
    print(f"\nTraining complete. {m.model_path}")
    return 0


def _profile(device):
    """torch.profiler over host work and, on the card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _load_trained(args, device):
    """The model settings come from the model's cfg_args.json alone, as in
    the JAX CLI; only -m and -s apply over it."""
    from .models.gaussians import load_ply

    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    cfg = load_config(cfg_path) if os.path.exists(cfg_path) else Config()
    cfg.model.model_path = args.model_path
    if args.source_path:
        cfg.model.source_path = os.path.abspath(args.source_path)

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

    @torch.no_grad()
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


def cmd_spiral(argv):
    # reference spiral.py
    p = argparse.ArgumentParser("spiral")
    _add_common_model_flags(p)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--n_frames", type=int, default=180)
    p.add_argument("--near", type=float, default=0.0)
    p.add_argument("--no_video", action="store_true")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .data.dataset import load_view
    from .ops.rasterize import render_tiled
    from .render.spiral import (
        create_dtu_spiral, create_llff_spiral, depth_curve_fn, visualize_cmap,
    )

    device = resolve_device(args.device)
    cfg, model, iteration = _load_trained(args, device)
    source = cfg.model.source_path
    scene_name = os.path.basename(os.path.normpath(source))
    make_spiral = create_dtu_spiral if "scan" in source else create_llff_spiral
    info = make_spiral(source, n_frames=args.n_frames)
    views = [load_view(cfg, i, c, device=device) for i, c in enumerate(info.test_cameras)]
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, device=device)

    render_path = os.path.join(cfg.model.model_path, "spiral", f"ours_{iteration}")
    for idx, v in enumerate(views):
        with torch.no_grad():
            out = render_tiled(v.camera, model, bg, raster=cfg.raster, device=device)
        _save_png(out.image, os.path.join(render_path, f"{idx:05d}.png"))
        depth = out.depth.cpu().numpy()
        alpha = out.alpha.cpu().numpy()
        # reference spiral.py:120-122: normalized inverted depth, alpha matted
        dnorm = 1.0 - (depth - depth.min()) / (depth.max() - depth.min() + 1e-12)
        dshow = 1.0 - dnorm * alpha
        _save_png(np.repeat(dshow[..., None], 3, axis=-1),
                  os.path.join(render_path, f"depth_{idx:05d}.png"))
        cmapped = visualize_cmap(dshow, np.ones_like(dshow), curve_fn=depth_curve_fn)
        _save_png(cmapped, os.path.join(render_path, f"cdepth_{idx:05d}.png"))
    if not args.no_video:
        for prefix, outname in (("", "out"), ("depth_", "out_depth"), ("cdepth_", "out_cdepth")):
            try:
                subprocess.run(
                    ["ffmpeg", "-loglevel", "error", "-i", f"{render_path}/{prefix}%5d.png",
                     "-q", "2", f"{cfg.model.model_path}/{outname}_{scene_name}.mp4", "-y"],
                    check=True)
            except FileNotFoundError:
                print(f"ffmpeg not found: no video; the frames are in {render_path}")
                return 1
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
    lpips_fn = None
    if args.lpips_weights and os.path.exists(args.lpips_weights):
        from .eval.lpips import load_lpips_weights, make_lpips

        lpips_fn = make_lpips(load_lpips_weights(args.lpips_weights), device=device)
    else:
        print("LPIPS weights not provided — reporting LPIPS as null")
    failed = 0
    for scene_dir in args.model_paths:
        print("Scene:", scene_dir)
        try:
            res = evaluate_dir(
                scene_dir, dataset_name=args.dataset_name,
                idrmasks_path=args.idrmasks_path, lpips_fn=lpips_fn, device=device,
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


def cmd_triangulate(argv):
    # reference submodules/dense_matcher/triangulate.py CLI
    p = argparse.ArgumentParser("triangulate")
    p.add_argument("--scene_path", "-s", type=str, required=True)
    p.add_argument("--output_path", type=str, default="keypoints_to_3d/LLFF")
    p.add_argument("--images", type=str, default="images")
    p.add_argument("--dataset_name", type=str, default="LLFF")
    p.add_argument("--n_views", type=int, default=3)
    p.add_argument("--resolution", type=int, default=8)
    p.add_argument("--matcher", type=str, default="farneback")
    p.add_argument("--pdcnet_weights", type=str, default=None)
    p.add_argument("--growth_iterations", type=int, default=1000)
    p.add_argument("--ssim_threshold", type=float, default=0.95)
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .init.matchers import select_matcher
    from .init.pipeline import TriangulateConfig, triangulate_scene

    device = resolve_device(args.device)
    kwargs = {"device": device}
    if args.matcher.lower().startswith("pdcnet"):
        kwargs["weights_path"] = args.pdcnet_weights
    matcher = select_matcher(args.matcher, **kwargs)
    cfg = TriangulateConfig(
        dataset_name=args.dataset_name,
        n_views=args.n_views,
        resolution=args.resolution,
        growth_iterations=args.growth_iterations,
        ssim_threshold=args.ssim_threshold,
    )
    ply = triangulate_scene(args.scene_path, args.output_path, matcher, cfg, args.images,
                            device=device)
    print(f"wrote {ply}")
    return 0


def cmd_run(argv):
    # reference script/run_llff.py / run_dtu.py / run_blender.py dispatcher
    from .orchestrate import main as orchestrate_main

    return orchestrate_main(argv)


COMMANDS = {
    "train": cmd_train,
    "triangulate": cmd_triangulate,
    "render": cmd_render,
    "spiral": cmd_spiral,
    "metrics": cmd_metrics,
    "aggregate": cmd_aggregate,
    "run": cmd_run,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m binocular3dgs_torch.cli {{{','.join(COMMANDS)}}} ...")
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main() or 0)
