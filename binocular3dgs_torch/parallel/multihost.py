"""Multi-process dry run: the band-sharded binocular train step over ranks
in separate processes.

Counterpart of `binocular3dgs_tpu/parallel/multihost.py`. The sharded step
(parallel/sharding.py) is written against a process group; several hosts
run the same program, with the group spanning every host's ranks.

torch has no virtual devices and one process holds one rank, so a JAX
process of L local devices becomes L rank processes here:
`dryrun_multihost(num_processes, local_ranks)` starts num_processes "hosts"
of local_ranks ranks each (rank = host * local_ranks + local_rank; on the
card a rank computes on card local_rank % device_count), all meeting over
one rendezvous, and asserts that every rank's loss is the same, bit for
bit, and within 1e-6 of a world-size-1 run of the same problem. The backend
is the caller's choice: nccl with one rank per card, or gloo, which also
runs ranks that share one card (sharding.py, "Transport").

    python -m binocular3dgs_torch.parallel.multihost --backend gloo \\
        --init_method tcp://localhost:<port> --world_size 2 --rank 0 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_worker(
    init_method: str | None,
    world_size: int,
    rank: int,
    *,
    backend: str,
    local_rank: int = 0,
    steps: int = 2,
    height: int | None = None,
    device: str = "cuda",
) -> float:
    """One rank: `steps` band-sharded binocular steps on a toy scene (256
    points at capacity 256, 64 x `height`, by default 16 * max(world, 3)
    pixels); returns the last step's loss. `init_method` None runs a world
    of one rank on an in-process store."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..config import Config
    from ..core.camera import make_camera
    from ..data.ply import PointCloud
    from ..models.gaussians import create_from_pcd
    from ..train.state import init_train_state
    from .sharding import make_mesh, make_sharded_train_step

    torch.set_num_threads(1)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an init_method")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    try:
        mesh = make_mesh(dev)
        rng = np.random.default_rng(0)
        n = 256
        pts = rng.normal(size=(n, 3)) * 0.5 + [0, 0, 5.0]
        pcd = PointCloud(points=pts, colors=rng.random((n, 3)))
        model = create_from_pcd(pcd, spatial_lr_scale=1.0, max_sh_degree=1, capacity=256,
                                device=mesh.device)
        width, height = 64, height or 16 * max(world_size, 3)
        cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width, height, device=mesh.device)
        cfg = Config()
        step = make_sharded_train_step(cfg, mesh, width, height, 1.0, binocular=True)
        state = init_train_state(model)
        gt = torch.zeros(3, height, width, device=mesh.device)
        aw = torch.zeros(height, width, device=mesh.device)
        bg = torch.zeros(3, device=mesh.device)
        gen = torch.Generator().manual_seed(0)
        for i in range(steps):
            u, s = torch.rand(2, generator=gen).tolist()
            trans = u * cfg.train.cam_trans_dist * (1.0 if s < 0.5 else -1.0)
            state, metrics = step(state, cam, gt, aw, 1 + i, trans, bg)
        return float(metrics.loss)
    finally:
        dist.destroy_process_group()


def run_processes(commands: list[list[str]], timeout: float, env: dict | None = None) -> list[str]:
    """Start every command at once and wait for all of them, `timeout`
    seconds in all; returns their standard outputs. When one fails or time
    runs out, the others are killed (a rank left waiting in a collective
    would wait forever) and RuntimeError carries the failure's stderr."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    outs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in commands]
    procs = [subprocess.Popen(c, stdout=o, stderr=e, text=True, env=env)
             for c, (o, e) in zip(commands, outs)]
    deadline = time.monotonic() + timeout

    def text(f):
        f.seek(0)
        return f.read()

    try:
        while None in [p.poll() for p in procs]:  # poll every process each round
            failed = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed:
                i = failed[0]
                raise RuntimeError(f"process {i} ({' '.join(commands[i])}) exited "
                                   f"{procs[i].returncode}:\n{text(outs[i][1])[-3000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"processes still running after {timeout} s: "
                                   f"{[i for i, p in enumerate(procs) if p.poll() is None]}")
            time.sleep(0.05)
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"process {i} ({' '.join(commands[i])}) exited "
                                   f"{p.returncode}:\n{text(outs[i][1])[-3000:]}")
        return [text(o) for o, _ in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for o, e in outs:
            o.close()
            e.close()


def _loss(stdout: str) -> float:
    return float(stdout.strip().splitlines()[-1].split("loss=")[1])


def dryrun_multihost(
    num_processes: int = 2,
    local_ranks: int = 1,
    *,
    backend: str,
    device: str = "cuda",
    init_method: str | None = None,
    timeout: float = 900,
) -> float:
    """num_processes hosts of local_ranks rank processes each over one
    rendezvous (`init_method`, by default tcp://localhost on a free port):
    every rank's loss equal bit for bit, and within 1e-6 of a world-size-1
    run. Returns the loss."""
    world = num_processes * local_ranks
    height = 16 * max(world, 3)
    if init_method is None:
        with socket.socket() as s:  # a port free now
            s.bind(("localhost", 0))
            init_method = f"tcp://localhost:{s.getsockname()[1]}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = [sys.executable, "-m", "binocular3dgs_torch.parallel.multihost",
              "--backend", backend, "--device", device, "--height", str(height)]
    commands = [worker + ["--init_method", init_method, "--world_size", str(world),
                          "--rank", str(h * local_ranks + r), "--local_rank", str(r)]
                for h in range(num_processes) for r in range(local_ranks)]
    losses = [_loss(o) for o in run_processes(commands, timeout, env)]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"the ranks' losses differ: {losses}")
    ref = _loss(run_processes([worker + ["--world_size", "1", "--rank", "0"]], timeout,
                              env)[0])
    if not abs(ref - losses[0]) < 1e-6:
        raise AssertionError(f"{world} ranks: loss {losses[0]!r}, one rank: {ref!r}")
    print(f"dryrun_multihost: {num_processes} processes x {local_ranks} ranks ({backend}, "
          f"{device}) loss={losses[0]!r}, one rank {ref!r}")
    return losses[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="one rank of the multi-process dry run")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--init_method", default=None,
                    help="rendezvous URL (tcp://host:port or file://path); none: one rank")
    ap.add_argument("--world_size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--local_rank", type=int, default=0)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loss = run_worker(args.init_method, args.world_size, args.rank, backend=args.backend,
                      local_rank=args.local_rank, height=args.height,
                      device=args.device)
    print(f"loss={loss!r}")


if __name__ == "__main__":
    main()
