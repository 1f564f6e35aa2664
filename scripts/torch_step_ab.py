#!/usr/bin/env python3
"""Time the port's binocular training step (chip_smoke's phase-9 workload) on
one GPU, for the tree in --repo: a parent and a change compare when each is
run from its own checkout in turns (parent, change, change, parent, ...) in
one chip call.

    python scripts/torch_step_ab.py [--repo <checkout>] [--steps 30] [--seed 0]

The workload, its camera, shifts and step come from `<repo>/chip_smoke.py`
(`train_setup`, the bench.py workload: 100k gaussians, 1008x756), and the
port from `<repo>/binocular3dgs_torch`. After 5 warm-ups it times --steps
steps by CUDA events and the host clock, then profiles 10 more: kernel ms
per step, and the host ops with the most self CPU time per step (count and
ms). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("scripts/torch_step_ab.py needs a CUDA card")
    import chip_smoke
    from binocular3dgs_torch import resolve_device

    device = resolve_device("cuda")
    step, state, cam, gt, aw, bg, cfg = chip_smoke.train_setup(torch, args.seed, device)
    gen = torch.Generator().manual_seed(args.seed)
    it = 2

    def one():
        nonlocal state, it
        u, s = torch.rand(2, generator=gen).tolist()
        trans = u * cfg.train.cam_trans_dist * (1.0 if s < 0.5 else -1.0)
        state, _ = step(state, cam, gt, aw, it, trans, bg)
        it += 1

    for _ in range(5):
        one()
    torch.cuda.synchronize()
    events = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        one()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    step_ms = [s.elapsed_time(e) for s, e in events]

    reps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA) / 1e3 / reps
    host_ops = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:15]
    print(json.dumps({
        "repo": repo, "steps": args.steps,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_quartiles": [float(q) for q in np.percentile(step_ms, [25, 75])],
        "step_ms": step_ms, "host_ms_per_step": host_ms, "kernel_ms_per_step": kernel_ms,
        "host_ops_per_step": {e.key: [e.count / reps, e.self_cpu_time_total / 1e3 / reps]
                              for e in host_ops},
        "card": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
