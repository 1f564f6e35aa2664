"""The readers of the program's own ranges and counters
(benchmark/ranges.py and the six metrics that read them): on made-up
ranges, counters and events, and on the tiny CPU cells, where the three
layers' idle time and the unattributed part add up to the block's."""

import pytest

from benchmark import ranges as ranges_mod, run as run_mod
from benchmark.tests.tiny_cells import CPU, use_tiny_cells

NEW = ("train.render_idle_ms", "train.step_idle_ms", "train.trainer_idle_ms",
       "train.pair_fill", "train.host_reads_per_block", "train.densify_span_ms")
IDLE = {"render": "train.render_idle_ms", "step": "train.step_idle_ms",
        "trainer": "train.trainer_idle_ms"}


def rng(name, start, end, thread=1):
    return dict(name=name, thread=thread, start_ns=start, end_ns=end, parent=None, attrs={},
                iteration=None)


def ctr(name, value, t):
    return dict(name=name, value=value, t_ns=t, thread=1, range=None, iteration=None)


# device events (ns): gaps 1-3 (ends in no range), 10-20 (ends inside
# step.forward), 30-50 (ends inside step.forward after render.bin closed;
# render.blend.backward opened later on another thread, but closed before
# 50), 60-100 (ends inside render.blend.backward on thread 2, the latest
# started), 110-150 (ends in trainer.train alone)
EVENTS = [(0, 1, "a"), (3, 10, "b"), (20, 30, "c"), (50, 60, "d"), (100, 110, "e"),
          (150, 160, "f")]
RANGES = [rng("trainer.train", 5, 170), rng("step.forward", 15, 55), rng("render.bin", 25, 45),
          rng("render.blend.backward", 40, 48, thread=2),
          rng("render.blend.backward", 90, 105, thread=2), rng("trainer.densify", 105, 115)]
COUNTERS = [ctr("render.pairs_wanted", 30, 22), ctr("render.pair_capacity", 100, 23),
            ctr("render.pairs_wanted", 150, 70), ctr("render.pair_capacity", 100, 71),
            ctr("trainer.host_reads", 1, 80), ctr("trainer.host_reads", 4, 165),
            ctr("trainer.host_reads", 1, 200)]


def made_up(monkeypatch, ranges=RANGES, counters=COUNTERS):
    from binocular3dgs_torch import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: dict(ranges=ranges, counters=counters))
    busy = 1e-9 * (1 + 7 + 10 + 10 + 10 + 10)
    # 4 unprofiled blocks of 2 iterations in 2 us: 500 ns a block, 452 ns idle
    return dict(iterations_per_block=2, blocks=4, window_s=2e-6, train_it_s=4e6,
                trace=dict(busy_s=busy, window_s=160e-9, launches=6, events=EVENTS))


def test_gaps_go_to_the_innermost_open_range_at_their_end():
    by_name = ranges_mod.idle_by_range(EVENTS, RANGES)
    assert by_name == {None: 2, "step.forward": 10 + 20, "render.blend.backward": 40,
                       "trainer.train": 40}
    assert ranges_mod.idle_gaps(EVENTS) == [(1, 3), (10, 20), (30, 50), (60, 100), (110, 150)]


def test_the_readers_scale_to_the_unprofiled_block(monkeypatch):
    ctx = made_up(monkeypatch)
    # the profiled block's idle 112 ns; the unprofiled block's 452 ns over 2 iterations
    per_it_ms = 452e-9 / 2 * 1e3
    read = {name: run_mod.read_metric(name, ctx) for name in NEW}
    assert read["train.render_idle_ms"] == pytest.approx(40 / 112 * per_it_ms)
    assert read["train.step_idle_ms"] == pytest.approx(30 / 112 * per_it_ms)
    assert read["train.trainer_idle_ms"] == pytest.approx(40 / 112 * per_it_ms)
    # the unattributed 2 ns are the rest
    assert sum(read[IDLE[k]] for k in IDLE) == pytest.approx(110 / 112 * per_it_ms)
    assert read["train.pair_fill"] == pytest.approx(100.0 * (30 + 100) / 200)
    # the count stamped after the block's last device event but inside its
    # ranges is the block's; the one after them is not
    assert read["train.host_reads_per_block"] == 5
    assert read["train.densify_span_ms"] == pytest.approx(10e-6)


def test_the_new_readers_read_nothing_without_ranges(monkeypatch):
    for name in NEW:
        assert run_mod.read_metric(name, {"iterations_per_block": 100, "train_it_s": 1.0}) is None
    ctx = made_up(monkeypatch, ranges=[rng("trainer.train", 500, 600)])
    for name in NEW:
        assert run_mod.read_metric(name, ctx) is None, name


def test_a_program_without_tracing_reads_none(monkeypatch):
    import sys

    import binocular3dgs_torch

    ctx = made_up(monkeypatch)
    monkeypatch.delattr(binocular3dgs_torch, "tracing")
    monkeypatch.setitem(sys.modules, "binocular3dgs_torch.tracing", None)
    for name in NEW:
        assert run_mod.read_metric(name, ctx) is None, name


@pytest.mark.parametrize("workload", ["llff3.train", "blender8.train"])
def test_the_tiny_cells_idle_adds_up(monkeypatch, workload):
    """A traced run of each tiny cell on the CPU (the host's operators
    standing in for the device's): the new metrics are read, the three
    layers' idle time and the unattributed part add up to train.device_idle
    times the unprofiled block over its iterations, and the block reads the
    trainer's two span reads and densification's five."""
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell(workload, 2**31 + 7, 0.0, True, CPU)
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(metrics)
    ctx = out["res"]["ctx"]
    by_name = ranges_mod.idle_by_range(ctx["trace"]["events"], ranges_mod.block(ctx)["ranges"])
    share_unattributed = by_name.get(None, 0) / sum(by_name.values())
    per_it_ms = 1e3 * ctx["window_s"] / ctx["blocks"] / ctx["iterations_per_block"]
    idle_ms = metrics["train.device_idle"] / 100 * per_it_ms
    unattributed_ms = share_unattributed * idle_ms
    assert sum(metrics[IDLE[k]] for k in IDLE) + unattributed_ms == pytest.approx(idle_ms,
                                                                                  rel=1e-9)
    assert share_unattributed < 0.05
    assert metrics["train.host_reads_per_block"] == 7
    assert 0 < metrics["train.pair_fill"] <= 100 and metrics["train.densify_span_ms"] > 0
