"""The comparison that decides `correct` for a training cell.

Two sets of readings meet here: the program's, taken from the trainer's
own state while set-up drives it through its first steps and its first
densification, and the reference's, worked out again from the cell's
inputs (reference.py). Each number below has a limit of its own in
`limits/<workload>.json`, set from the program's readings on sound runs
and the control's (PERF.md gives the readings and the limits):

  * `loss_gap`: over the first three steps, the largest relative gap of
    the photometric loss, the disparity loss or the alpha loss;
  * `grad_gap`: the first step's gradient as the optimiser got it (the
    program's worked out from its first Adam moment), by the worst leaf:
    the gap between the two norms over the larger of the reference's norm
    of that leaf and of the median leaf;
  * `change_gap`: the change of each leaf over the three steps, measured
    the same way, and of the densification statistic `grad_accum`; a leaf
    whose reference gradient is under a thousandth of the median leaf's
    moves by round-off alone and is left out;
  * `densify_rows`: the gap in the rows that the first densification keeps,
    and `densify_gap`: its parameters and Adam's two moments by the worst
    leaf (the norm of the difference over the larger of the reference
    leaf's norm and its tree's median leaf's), the reference run on the
    program's own state before it;
  * `block_loss_gap`, `block_grad_gap`, `block_change_gap`: the first three
    steps of a block, from the start state that every timed block restores
    (warm Adam moments, the densified rows), measured as the three above,
    the reference following from the program's own start state.
"""

from __future__ import annotations

import json
import math
import statistics

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
NOUGHT = 1e-3  # of the median leaf's gradient norm: the round-off leaves


def _worst(prog: dict, ref: dict, names) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def step_numbers(prog: dict, ref: dict) -> dict:
    """`loss_gap`, `grad_gap` and `change_gap` of the first three steps;
    each reading holds `loss`, `disparity_loss`, `alpha_loss` (per step),
    `grad` (per leaf norms) and `change` (per leaf norms and
    `grad_accum`)."""
    loss_gap = max(abs(p - r) / abs(r) if r else abs(p)
                   for key in ("loss", "disparity_loss", "alpha_loss")
                   for p, r in zip(prog[key], ref[key]))
    med = statistics.median(ref["grad"][n] for n in LEAVES)
    moved = [n for n in LEAVES if ref["grad"][n] >= NOUGHT * med]
    return dict(loss_gap=loss_gap, grad_gap=_worst(prog["grad"], ref["grad"], LEAVES),
                change_gap=_worst(prog["change"], ref["change"], moved + ["grad_accum"]))


def densify_numbers(prog_post: dict, ref_post: dict) -> dict:
    """`densify_rows` and `densify_gap` of the program's densification
    against the reference's from the same state; each holds `params`, `m`
    and `v` (per leaf tensors: the parameters and Adam's moments) and
    `rows` (the active count)."""
    gap = 0.0
    for tree in ("params", "m", "v"):
        prog, ref = prog_post[tree], ref_post[tree]
        diff = {n: float((prog[n] - ref[n]).double().norm()) for n in LEAVES}
        norm = {n: float(ref[n].double().norm()) for n in LEAVES}
        med = statistics.median(norm.values())
        gap = max([gap] + [diff[n] / max(norm[n], med) for n in LEAVES if max(norm[n], med) > 0])
    return dict(densify_rows=float(abs(prog_post["rows"] - ref_post["rows"])), densify_gap=gap)


def load_limits(path: str) -> dict:
    with open(path) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit, and every limit read."""
    checks = {name: {"value": numbers.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
