"""End-to-end quality protocol of the port on a synthetic golden scene.

The port's twin of `scripts/quality_run.py`: the same ~1.2k-gaussian cloud
drawn from `default_rng(7)`, golden renders of 9 views at 256x256 by the
port's dense oracle (`ops/rasterize_reference.render_dense`), a COLMAP
scene on disk, then the scaled LLFF few-shot protocol through the port's
CLIs (train on 3 views with densification, the binocular branch and opacity
decay; render; metrics), and the held-out PSNR / SSIM written as JSON into
`--out`:

    python -m binocular3dgs_torch.quality_run --out <dir> [--device cuda]

Protocol scaling against the reference LLFF recipe (train.py:35-202,
script/run_llff.py:10-11), as in the JAX script: iterations 30k -> 3k,
shift_cam_start 20k -> 2k, densify from 500 every 100 until the end
(opacity-decay mode), 3 train views, every 8th view held out. `run` takes
the iteration count and the image size (which scales the focal length too)
for checks at a reduced size; the command line runs the protocol.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import resolve_device

N_VIEWS, N_GAUSSIANS, N_INIT = 9, 1200, 500
ITERATIONS, SIZE = 3000, 256
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # holds the package


def golden_model(rng, device):
    """The golden cloud: smooth blobs filling the frustum around z ~ 4."""
    from .core.sh import rgb_to_sh
    from .models.gaussians import from_numpy

    n = N_GAUSSIANS
    xyz = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(3.0, 5.2, n)], axis=1).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    params = dict(
        xyz=xyz,
        f_dc=rgb_to_sh(colors)[:, None, :],
        f_rest=np.zeros((n, 3, 3), np.float32),
        opacity=rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32),
        scaling=np.log(rng.uniform(0.04, 0.11, (n, 3))).astype(np.float32),
        rotation=np.concatenate([np.ones((n, 1)), np.zeros((n, 3))], 1).astype(np.float32),
    )
    return from_numpy(params, np.ones(n, bool), 1, 0, device=device), xyz, colors


def build_scene(scene: str, size: int = SIZE, device: str | torch.device = "cuda") -> dict:
    """Write the golden COLMAP scene under `scene` (forward-facing LLFF-style
    arc of 9 PINHOLE views looking at the cloud, 500 noisy cloud points as
    the SfM stand-in, golden-rendered PNGs) and return the golden renders,
    {image name: (3, size, size) float tensor}, before quantization."""
    from PIL import Image

    from .config import Config
    from .data import colmap
    from .data.dataset import Scene
    from .ops.rasterize_reference import render_dense

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    os.makedirs(f"{scene}/sparse/0", exist_ok=True)
    os.makedirs(f"{scene}/images", exist_ok=True)

    focal = 290.0 * size / 256
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", size, size,
                                   np.array([focal, focal, size / 2, size / 2]))}
    images = {}
    for i in range(1, N_VIEWS + 1):
        u = (i - (N_VIEWS + 1) / 2) / N_VIEWS  # -0.44 .. 0.44
        ang = u * 0.35
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])  # yaw about y
        # world->cam translation: the camera sits at x = 1.2u, y = 0.3|u|, z = 0
        cpos = np.array([1.2 * u, 0.3 * abs(u), 0.0])
        t = -colmap.qvec2rotmat(q) @ cpos
        images[i] = colmap.ColmapImage(i, q, t, 1, f"im_{i:02d}.png", np.zeros((0, 2)),
                                       np.zeros(0, dtype=np.int64))
        Image.fromarray(np.zeros((size, size, 3), dtype=np.uint8)).save(
            f"{scene}/images/im_{i:02d}.png")

    model, xyz, colors = golden_model(rng, device)
    sel = rng.choice(N_GAUSSIANS, N_INIT, replace=False)
    pts = xyz[sel] + rng.normal(0, 0.02, (N_INIT, 3)).astype(np.float32)
    colmap.write_cameras_binary(f"{scene}/sparse/0/cameras.bin", cams)
    colmap.write_images_binary(f"{scene}/sparse/0/images.bin", images)
    colmap.write_points3d_binary(f"{scene}/sparse/0/points3D.bin", pts,
                                 (colors[sel] * 255).astype(np.uint8), np.zeros((N_INIT, 1)))

    # golden-render through the camera objects the trainer will see
    cfg = Config()
    cfg.model.source_path = scene
    cfg.model.eval = True
    cfg.train.dataset_name = "LLFF"
    cfg.train.n_views = 7  # all 9 views: 7 train + 2 test
    loaded = Scene.load(cfg, shuffle=False, device=device)
    bg = torch.zeros(3, device=device)
    renders = {}
    for v in list(loaded.train_views) + list(loaded.test_views):
        with torch.no_grad():
            image = render_dense(v.camera, model, bg).image
        name = str(v.image_name)
        name = name if name.endswith(".png") else name + ".png"
        renders[name] = image
        arr = image.permute(1, 2, 0).cpu().numpy()
        Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(scene, "images", name))
    return renders


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_cli(args, log):
    print("+ python -m binocular3dgs_torch.cli", " ".join(args), flush=True)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        r = subprocess.run([sys.executable, "-m", "binocular3dgs_torch.cli", *args],
                           cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True,
                           timeout=7200)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        with open(log) as f:
            print(f.read()[-4000:])
        raise SystemExit(f"cli {args[0]} failed with rc={r.returncode}")
    print(f"  ok ({dt:.1f} s)", flush=True)
    return dt


def run(out: str, device: str | torch.device = "cuda", iterations: int = ITERATIONS,
        size: int = SIZE) -> dict:
    """Build the golden scene under `out`, train, render and score it through
    the CLIs, write `out/quality.json` and return its record."""
    device = resolve_device(device)
    out = os.path.abspath(out)
    scene, model_dir = os.path.join(out, "scene"), os.path.join(out, "model")
    build_scene(scene, size, device)
    print(f"golden scene written: {scene} ({N_VIEWS} views rendered)", flush=True)

    it = iterations
    dev = ["--device", device.type]
    times = {
        "train_s": run_cli(["train", "-s", scene, "-m", model_dir, "--eval", "-r", "1",
                            "--iterations", str(it), "--position_lr_max_steps", str(it),
                            "--shift_cam_start", str(it * 2 // 3), "--test_iterations", str(it),
                            "--save_iterations", str(it), "--dataset_name", "LLFF",
                            "--n_views", "3", *dev], os.path.join(out, "train.log")),
        "render_s": run_cli(["render", "-m", model_dir, *dev], os.path.join(out, "render.log")),
        "metrics_s": run_cli(["metrics", "-m", model_dir, *dev],
                             os.path.join(out, "metrics.log")),
    }
    with open(os.path.join(model_dir, "results.json")) as f:
        method, entry = sorted(json.load(f).items())[-1]
    record = {
        "protocol": f"LLFF 3-view, {N_VIEWS}x{size}x{size} synthetic golden cloud "
                    f"({N_GAUSSIANS} gaussians)",
        "iterations": it,
        "shift_cam_start": it * 2 // 3,
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else None,
        "method": method,
        "psnr": entry.get("PSNR"),
        "ssim": entry.get("SSIM"),
        "lpips": entry.get("LPIPS"),
        **times,
        "command": "python -m binocular3dgs_torch.quality_run --out " + out,
    }
    with open(os.path.join(out, "quality.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the scene, model and JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
