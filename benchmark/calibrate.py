"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds <n>... \\
        --control-seeds <n>... [--out <file.jsonl>]

For each seed, set-up drives the program through its first steps and its
first densification as a run does, and the numbers of the comparison are
read (the sound runs: the lower readings). For each control seed, besides:

  * `control`: the reference computed with TF32 rounding (the precision
    next below the configuration's float32 with TF32 off), put in the
    program's place;
  * `half_batch`: the program with half of each image left out of its
    losses, the mean taken over the rest (planted in `train/step.py`'s
    loss functions);
  * `unchanged`: the program's state left unchanged by its steps (its
    readings zero) and by its densification (its state before it).

No window is run. One JSON line per seed and reading goes to `--out` and
to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run as run_mod
from .drivers import train_block as tb


def half_batch(torch_fn):
    """`torch_fn` on the top half of every image row range it is given."""

    def top(x):
        return x[..., : x.shape[-2] // 2, :] if torch.is_tensor(x) and x.ndim >= 2 else x

    def fn(*args, **kwargs):
        return torch_fn(*(top(a) for a in args), **{k: top(v) for k, v in kwargs.items()})

    return fn


def planted_half_batch(config, traffic, seed, device):
    import binocular3dgs_torch.train.step as step_mod

    saved = (step_mod.l1_loss, step_mod.ssim, step_mod.smooth_loss)
    step_mod.l1_loss, step_mod.ssim, step_mod.smooth_loss = (half_batch(f) for f in saved)
    try:
        return tb.setup(config, traffic, seed, device)
    finally:
        step_mod.l1_loss, step_mod.ssim, step_mod.smooth_loss = saved


def free(su):
    """Free the trainer; the start state stays for the reference."""
    su.trainer = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(workload: str, seeds: list, control_seeds: list, device, emit) -> None:
    _, config, traffic, _ = run_mod.cell(workload)
    for seed in dict.fromkeys(seeds + control_seeds):
        su = tb.setup(config, traffic, seed, device)
        free(su)
        nums, _ = tb.numbers(su, config)
        emit(dict(workload=workload, seed=seed, kind="sound", numbers=nums))
        if seed not in control_seeds:
            continue
        emit(dict(workload=workload, seed=seed, kind="control",
                  numbers=tb.numbers(su, config, prog=tb.reference_warmup(su, config, True),
                                     post=tb.reference_post(su, config, True),
                                     block=tb.reference_block(su, config, True))[0]))

        def zero(readings):
            return dict(readings, grad={k: 0.0 for k in readings["grad"]},
                        change={k: 0.0 for k in readings["change"]})

        emit(dict(workload=workload, seed=seed, kind="unchanged",
                  numbers=tb.numbers(su, config, prog=zero(su.prog), post=su.densify[0],
                                     block=zero(su.block))[0]))
        del su
        hb = planted_half_batch(config, traffic, seed, device)
        free(hb)
        emit(dict(workload=workload, seed=seed, kind="half_batch",
                  numbers=tb.numbers(hb, config)[0]))
        del hb


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        from binocular3dgs_torch import resolve_device

        readings(args.workload, args.seeds, args.control_seeds,
                 resolve_device(args.device), emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
