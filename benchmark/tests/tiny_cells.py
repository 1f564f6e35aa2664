"""The cells cut to a size that the CPU tests can run: the same
configurations and traffic with a few hundred gaussians at 64x48, larger
splats, and a 20-iteration block whose densification falls on its 19th
iteration. The port runs its kernels' plain versions on the CPU."""

from __future__ import annotations

import copy
import json
import os

import torch

from benchmark import run as run_mod

TRAFFIC = {"driver": "train_block", "iterations": 20, "start_after_binocular": 2}
CPU = torch.device("cpu")


def tiny_config(name: str) -> dict:
    with open(os.path.join(run_mod.HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    c["model"]["gaussians"] = 400
    c["scene"]["images"] = {"width": 64, "height": 48}
    c["scene"]["cloud"]["scale"] = [0.05, 0.15] if c["scene"]["cloud"]["kind"] == "slab" \
        else [0.08, 0.15]
    c["trainer"]["opt"].update(densification_interval=20, densify_from_iter=5, iterations=100)
    c["trainer"]["train"]["shift_cam_start"] = 20
    return c


def use_tiny_cells(monkeypatch) -> None:
    """Every workload of BENCHMARK.json runs its configuration cut to the
    tiny size, with its own limits."""
    real = run_mod.cell

    def cell(workload):
        entry, config, traffic, bench = real(workload)
        return entry, tiny_config(config["name"]), copy.deepcopy(TRAFFIC), bench

    monkeypatch.setattr(run_mod, "cell", cell)
    torch.set_num_threads(2)
