"""The trace's reduction and the per-layer readers, on made-up events."""

import pytest

from benchmark import run as run_mod, trace


def test_summarize_unions_the_intervals_and_labels_the_gaps():
    """Each idle gap is labelled by the name of the operation that ends it."""
    events = [(10, 20, "a"), (15, 30, "b"), (40, 50, "a"), (90, 100, "c")]
    out = trace.summarize(events, 0, 120)
    assert out["busy_s"] == pytest.approx(40e-9)
    assert out["window_s"] == pytest.approx(120e-9)
    assert out["launches"] == 4
    assert dict(out["device_ops"]) == pytest.approx({"a": 20e-9, "b": 15e-9, "c": 10e-9})
    assert dict(out["idle_gaps"]) == pytest.approx({"a": 20e-9, "c": 40e-9, "(end)": 20e-9})
    assert trace.first_durations_s(events, "a", 2) == pytest.approx([10e-9, 10e-9])


def test_the_readers_read_nothing_without_a_trace():
    for name in ("train.device_idle", "train.launches_per_it", "train.mfu", "train.b2_roofline",
                 "train.densify_ms"):
        assert run_mod.read_metric(name, {"iterations_per_block": 100, "train_it_s": 1.0}) is None


def test_the_readers():
    events = [(0, 10, "b3dgs::blend_backward_kernel(float const*)"), (10, 20, "x"),
              (20, 50, "b3dgs::blend_backward_kernel(float const*)")]
    ctx = dict(iterations_per_block=4, train_it_s=10.0, flops_per_it=6.7e12, b2_bound_ms=2e-5,
               densify_ms=[10.0, 20.0], blocks=5, window_s=10.0,
               trace=dict(busy_s=1.0, window_s=4.0, launches=8, events=events))
    # busy 1 s of the profiled block over the unprofiled blocks' 2 s each
    assert run_mod.read_metric("train.device_idle", ctx) == pytest.approx(50.0)
    assert run_mod.read_metric("train.launches_per_it", ctx) == pytest.approx(2.0)
    assert run_mod.read_metric("train.mfu", ctx) == pytest.approx(100.0)
    assert run_mod.read_metric("train.b2_roofline", ctx) == pytest.approx(50.0)
    assert run_mod.read_metric("train.densify_ms", ctx) == pytest.approx(15.0)
