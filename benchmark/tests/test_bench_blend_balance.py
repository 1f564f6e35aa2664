"""`train.blend_balance`: the first render's slots over its walking work
items times the longest walk, on made-up counters, on a program without
the blend's counters or without ranges, and on the tiny CPU cells, whose
plain blend records no work items."""

import pytest

from benchmark import run as run_mod
from benchmark.tests.test_bench_ranges import ctr, made_up, rng
from benchmark.tests.tiny_cells import CPU, use_tiny_cells

NAME = "train.blend_balance"
RANGES = [rng("trainer.train", 5, 170), rng("trainer.step", 6, 150)]


def render(slots, chunks, longest, t):
    return [ctr("render.pairs_wanted", slots + 5, t), ctr("render.bin_slots", slots, t + 1),
            ctr("render.blend_chunks", chunks, t + 2),
            ctr("render.blend_longest_walk", longest, t + 3)]


def test_the_first_render_read(monkeypatch):
    counters = render(1000, 10, 200, 20) + render(900, 9, 100, 60)
    assert run_mod.read_metric(NAME, made_up(monkeypatch, RANGES, counters)) == pytest.approx(
        100.0 * 1000 / (10 * 200))
    # every item as long as the longest
    counters = render(2560, 10, 256, 20)
    assert run_mod.read_metric(NAME, made_up(monkeypatch, RANGES, counters)) == 100.0


def test_nothing_to_read(monkeypatch):
    assert run_mod.read_metric(NAME, {"iterations_per_block": 100}) is None
    ctx = made_up(monkeypatch, RANGES, [ctr("render.bin_slots", 1000, 20)])
    assert run_mod.read_metric(NAME, ctx) is None  # a blend without work items
    ctx = made_up(monkeypatch, RANGES, render(0, 0, 0, 20))
    assert run_mod.read_metric(NAME, ctx) is None  # a render with no pair
    ctx = made_up(monkeypatch, [], render(1000, 10, 200, 20))
    assert run_mod.read_metric(NAME, ctx) is None  # no range in the block


@pytest.mark.parametrize("workload", ["llff3.train", "blender8.train"])
def test_the_tiny_cpu_cells_read_nothing(monkeypatch, workload):
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell(workload, 2**31 + 13, 0.0, True, CPU)
    assert NAME not in out["metrics"]
