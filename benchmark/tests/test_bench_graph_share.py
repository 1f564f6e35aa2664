"""`train.graph_share`: the replayed share of the profiled block's steps,
on made-up ranges and counters, on a program without graphed steps or
without ranges, and on the tiny CPU cells, whose trainer never captures."""

import pytest

from benchmark import run as run_mod
from benchmark.tests.test_bench_ranges import ctr, made_up, rng
from benchmark.tests.tiny_cells import CPU, use_tiny_cells

NAME = "train.graph_share"
STEPS = [rng("trainer.train", 5, 170), rng("trainer.step", 6, 50), rng("trainer.step", 50, 90),
         rng("trainer.step", 90, 150), rng("step.replay", 60, 70), rng("step.replay", 95, 99)]


def test_replays_over_steps(monkeypatch):
    counters = [ctr("step.graph_replays", 1, 65), ctr("step.graph_replays", 1, 97),
                ctr("step.graph_captures", 1, 20)]
    assert run_mod.read_metric(NAME, made_up(monkeypatch, STEPS, counters)) == pytest.approx(
        100.0 * 2 / 3)
    assert run_mod.read_metric(NAME, made_up(monkeypatch, STEPS, [])) == 0.0


def test_nothing_to_read(monkeypatch):
    assert run_mod.read_metric(NAME, {"iterations_per_block": 100}) is None
    ctx = made_up(monkeypatch, [rng("trainer.train", 5, 170)], [])
    assert run_mod.read_metric(NAME, ctx) is None  # no step in the block
    from binocular3dgs_torch import tracing

    ctx = made_up(monkeypatch, STEPS, [ctr("step.graph_replays", 1, 65)])
    monkeypatch.delattr(tracing, "replayed")
    assert run_mod.read_metric(NAME, ctx) is None  # a program without graphed steps


@pytest.mark.parametrize("workload", ["llff3.train", "blender8.train"])
def test_the_tiny_cpu_cells_replay_nothing(monkeypatch, workload):
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell(workload, 2**31 + 11, 0.0, True, CPU)
    assert out["metrics"][NAME]["value"] == 0.0
