"""Multi-scene job dispatcher (reference script/run_llff.py, run_dtu.py,
run_blender.py).

Counterpart of `binocular3dgs_tpu/orchestrate.py`: the same protocols, scene
lists, per-scene pipeline (triangulate -> train -> render -> metrics) and
dispatch over a ThreadPoolExecutor with the reference's retry loop
(run_llff.py:61-98). Each stage is a subprocess of the port's CLI,
`binocular3dgs_torch.cli`, with `--device` forwarded to it; on a host with
several GPUs each slot pins one through CUDA_VISIBLE_DEVICES.

As in the JAX package, `run_scene` writes the dense PLY under
`<out_path>/keypoints_to_3d/<dataset>`, while `cli train` looks for it under
`./keypoints_to_3d/<dataset>` (the reader's default root, relative to the
working directory): with an `out_path` other than the working directory,
training starts from the scene's sparse COLMAP cloud. Both packages keep
this difference from the reference's scripts.

Dataset protocols (SURVEY §6 / reference run scripts):
  LLFF:    3 views, resolution /2, 30k iters, binocular from 20k
  DTU:     3 views, resolution /4, 30k iters, masked eval
  Blender: 8 views, resolution /2, 7k iters, shift_cam_start 4k, white bg
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from . import resolve_device

LLFF_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids", "room", "trex"]
DTU_SCENES = [f"scan{i}" for i in (8, 21, 30, 31, 34, 38, 40, 41, 45, 55, 63, 82, 103, 110, 114)]
BLENDER_SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]


@dataclass
class DatasetProtocol:
    dataset_name: str
    scenes: list
    n_views: int
    resolution: int
    iterations: int
    extra_train_flags: list = field(default_factory=list)
    run_triangulate: bool = True


PROTOCOLS = {
    # reference script/run_llff.py:10-11 + train.py defaults
    "LLFF": DatasetProtocol("LLFF", LLFF_SCENES, n_views=3, resolution=2, iterations=30000),
    # reference script/run_dtu.py:10-11
    "DTU": DatasetProtocol("DTU", DTU_SCENES, n_views=3, resolution=4, iterations=30000),
    # reference script/run_blender.py:20-41 — no triangulation, 7k iters
    "Blender": DatasetProtocol(
        "Blender", BLENDER_SCENES, n_views=8, resolution=2, iterations=7000,
        extra_train_flags=["--shift_cam_start", "4000", "--white_background"],
        run_triangulate=False,
    ),
}


def _cli(args, env=None):
    cmd = [sys.executable, "-m", "binocular3dgs_torch.cli"] + [str(a) for a in args]
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, env=env).returncode


def run_scene(scene: str, data_path: str, out_path: str, proto: DatasetProtocol,
              device_env: dict | None = None, skip_metrics: bool = False,
              device: str = "cuda") -> bool:
    """One scene pipeline (reference run_llff.py:21-53); every stage runs on
    `device`."""
    env = dict(os.environ)
    if device_env:
        env.update({k: str(v) for k, v in device_env.items()})
    scene_dir = os.path.join(data_path, scene)
    model_dir = os.path.join(out_path, f"{scene}_{proto.n_views}views")

    if proto.run_triangulate:
        rc = _cli([
            "triangulate", "-s", scene_dir,
            "--output_path", os.path.join(out_path, "keypoints_to_3d", proto.dataset_name),
            "--dataset_name", proto.dataset_name, "--n_views", proto.n_views,
            "--resolution", proto.resolution, "--device", device,
        ], env)
        if rc != 0:
            return False

    rc = _cli([
        "train", "-s", scene_dir, "-m", model_dir, "--eval",
        "--dataset_name", proto.dataset_name, "--n_views", proto.n_views,
        "-r", proto.resolution, "--iterations", proto.iterations,
        *proto.extra_train_flags, "--device", device,
    ], env)
    if rc != 0:
        return False

    rc = _cli([
        "render", "-m", model_dir, "--skip_train", "--device", device,
    ], env)
    if rc != 0:
        return False

    if not skip_metrics:
        rc = _cli(["metrics", "-m", model_dir, "--dataset_name", proto.dataset_name,
                   "--device", device], env)
        if rc != 0:
            return False
    return True


def available_device_slots() -> list:
    """Device slots to dispatch over. With more than one GPU each slot pins
    one (the reference's per-GPU dispatch, run_llff.py:61-94); otherwise a
    single unpinned slot."""
    n = torch.cuda.device_count()
    if n > 1:
        return [{"CUDA_VISIBLE_DEVICES": str(i)} for i in range(n)]
    return [{}]


def dispatch_jobs(dataset: str, data_path: str, out_base: str | None = None,
                  scenes: list | None = None, max_workers: int = 8,
                  retry_interval: float = 60.0, max_retries: int = 1,
                  device: str = "cuda") -> dict:
    """Dispatch all scenes over available device slots with retries
    (reference run_llff.py:61-98). Returns {scene: bool}."""
    proto = PROTOCOLS[dataset]
    scenes = list(scenes if scenes is not None else proto.scenes)
    out_path = out_base or os.path.join("output", dataset)
    os.makedirs(out_path, exist_ok=True)

    slots = available_device_slots()
    results: dict = {}

    def worker(slot_env, scene):
        tries = 0
        while True:
            ok = run_scene(scene, data_path, out_path, proto, slot_env, device=device)
            if ok or tries >= max_retries:
                return ok
            tries += 1
            time.sleep(retry_interval)

    with ThreadPoolExecutor(max_workers=min(max_workers, max(1, len(slots)))) as pool:
        futures = {}
        for i, scene in enumerate(scenes):
            slot = slots[i % len(slots)]
            futures[scene] = pool.submit(worker, slot, scene)
        for scene, fut in futures.items():
            results[scene] = fut.result()
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Run full per-scene pipelines for a dataset")
    p.add_argument("--dataset_name", choices=list(PROTOCOLS), required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--output_path", default=None)
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--max_workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of every stage (default cuda; cpu on request)")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card: fail here, not in every stage
    results = dispatch_jobs(args.dataset_name, args.data_path, args.output_path,
                            args.scenes, args.max_workers, device=args.device)
    failed = [s for s, ok in results.items() if not ok]
    print(f"done: {len(results) - len(failed)}/{len(results)} scenes ok"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
