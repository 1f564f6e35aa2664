"""The port's ranges and counters (binocular3dgs_torch/tracing.py) on the
CPU: off without a profiler, on under one; a traced binocular block of a
tiny trainer records the trainer's, step's and render's ranges and
counters; tracing changes no bit of the trained state; a range holds the
profiler's interval of the operation inside it."""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from binocular3dgs_torch import tracing
from binocular3dgs_torch.models import densify as densify_mod
from binocular3dgs_torch.train import loop
from binocular3dgs_torch.train.loop import Trainer
from test_torch_trainer import state_bits, toy_config, toy_scene

RENDER_RANGES = ("render.project", "render.bin", "render.gather", "render.blend",
                 "render.planes", "render.gather.backward", "render.blend.backward")
STEP_RANGES = ("step.forward", "step.loss.photo", "step.loss.disparity", "step.backward",
               "step.warp.backward", "step.update")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def since(t0: int) -> dict:
    """The snapshot's records that start at or after `t0`, each range with
    its parent range (`parent_range`) beside the parent's index."""
    snap = tracing.snapshot(since_ns=t0)
    ranges = [dict(r, parent_range=None if r["parent"] is None else snap["ranges"][r["parent"]])
              for r in snap["ranges"]]
    return dict(ranges=ranges, counters=snap["counters"])


def warm_trainer():
    """A toy trainer after 16 iterations: its next step is binocular, and a
    block of 17-25 densifies once, after 20."""
    trainer = Trainer(toy_config(), toy_scene(), device="cpu")
    trainer.train(16)
    return trainer


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    trainer = warm_trainer()
    t0 = time.time_ns()
    trainer.train(18, first_iteration=17)
    assert not tracing.enabled()
    assert since(t0) == dict(ranges=[], counters=[]) and entered == []
    with cpu_profile():
        assert tracing.enabled()
        trainer.train(19, first_iteration=19)
    assert not tracing.enabled()
    got = since(t0)
    assert entered and sorted(entered) == sorted(r["name"] for r in got["ranges"])


def count_reads(monkeypatch):
    """The reads of tensor values made in train/loop.py's and
    models/densify.py's frames (the CPU generator's draws in `_draw_trans`
    excluded), as tests/test_torch_trainer.py counts the loop's."""
    files = {loop.__file__, densify_mod.__file__}
    reads = []
    for name in ("tolist", "item", "__int__", "__float__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            f = sys._getframe(1).f_code
            if f.co_filename in files and f.co_name != "_draw_trans":
                reads.append(f.co_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


def test_a_traced_block_records_the_ranges_and_counters():
    trainer = warm_trainer()
    step_metrics = {}
    step = trainer.steps[True]

    def kept(state, cam, gt, aw, it, *args):
        state, metrics = step(state, cam, gt, aw, it, *args)
        step_metrics[it] = metrics
        return state, metrics

    trainer.steps = {**trainer.steps, True: kept}
    t0 = time.time_ns()
    with cpu_profile():
        trainer.train(25, first_iteration=17)
    got = since(t0)
    ranges, counters = got["ranges"], got["counters"]
    names = collections.Counter(r["name"] for r in ranges)
    assert names["trainer.train"] == 1 and names["trainer.densify"] == 1
    assert names["trainer.fused_span"] == names["trainer.read"] == 2
    assert names["trainer.grow_pairs"] == 2 and names["trainer.step"] == 9
    spans = [r["attrs"] for r in ranges if r["name"] == "trainer.fused_span"]
    assert spans == [dict(first=17, last=20), dict(first=21, last=25)]

    # each step: two renders' ranges, one of each step range, all carrying
    # the step's iteration
    for it in range(17, 26):
        mine = collections.Counter(r["name"] for r in ranges if r["iteration"] == it)
        assert {n: mine[n] for n in RENDER_RANGES} == dict.fromkeys(RENDER_RANGES, 2), it
        assert {n: mine[n] for n in STEP_RANGES} == dict.fromkeys(STEP_RANGES, 1), it
        assert mine["trainer.step"] == 1
    assert {r["iteration"] for r in ranges
            if r["name"].startswith(("render.", "step."))} == set(range(17, 26))

    # parents on one thread, holding their children
    for r in ranges:
        parent = r["parent_range"]
        if parent is None:
            assert r["name"] == "trainer.train"
            continue
        assert parent["thread"] == r["thread"]
        assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
    parent_of = {r["name"]: r["parent_range"]["name"] for r in ranges
                 if r["name"] != "trainer.train"}
    assert parent_of["trainer.step"] == parent_of["trainer.densify"] == "trainer.fused_span"
    assert parent_of["step.forward"] == parent_of["step.backward"] == "trainer.step"
    assert parent_of["render.bin"] in ("step.forward", "step.loss.disparity")

    # counters: the wanted pairs of the two renders are the step's own
    for it, metrics in step_metrics.items():
        wanted = [c["value"] for c in counters
                  if c["name"] == "render.pairs_wanted" and c["iteration"] == it]
        caps = [c["value"] for c in counters
                if c["name"] == "render.pair_capacity" and c["iteration"] == it]
        visible = [c["value"] for c in counters
                   if c["name"] == "step.visible" and c["iteration"] == it]
        assert len(wanted) == 2 and max(wanted) == int(metrics.num_pairs)
        assert caps == [metrics.pair_capacity] * 2 and visible == [int(metrics.n_visible)]
        # the plain version sorts and gathers every slot of the capacity
        slots = [c["value"] for c in counters
                 if c["name"] == "render.bin_slots" and c["iteration"] == it]
        assert slots == caps
    densified = {c["name"]: c["value"] for c in counters if c["name"].startswith("densify.")}
    assert set(densified) == {"densify.cloned", "densify.split", "densify.pruned"}
    assert all(isinstance(v, int) and v >= 0 for v in densified.values())


def test_host_reads_count_the_loops_and_densifications_reads(monkeypatch):
    """`trainer.host_reads` over a block equals the reads of device values
    made in the loop's and densification's frames: the span reads and the
    densification's five."""
    trainer = warm_trainer()
    reads = count_reads(monkeypatch)
    t0 = time.time_ns()
    with cpu_profile():
        trainer.train(25, first_iteration=17)
    monkeypatch.undo()
    counters = since(t0)["counters"]
    host_reads = sum(c["value"] for c in counters if c["name"] == "trainer.host_reads")
    assert len(reads) == host_reads == 7
    assert collections.Counter(reads) == {"train": 2, "densify_and_prune": 4,
                                          "_scatter_compact": 1}


def test_the_trained_state_is_the_same_with_tracing_on_and_off():
    states = []
    for traced in (False, True):
        trainer = warm_trainer()
        if traced:
            with cpu_profile():
                trainer.train(25, first_iteration=17)
        else:
            trainer.train(25, first_iteration=17)
        states.append(state_bits(trainer.state))
    for k, v in states[0].items():
        np.testing.assert_array_equal(v.view(np.uint8), states[1][k].view(np.uint8), err_msg=k)


def test_a_range_holds_the_profilers_interval_of_its_operation():
    a = torch.randn(256, 256)
    with cpu_profile() as prof:
        with tracing.region("probe.mm", n=256):
            torch.mm(a, a)
    probe = [r for r in tracing.snapshot()["ranges"] if r["name"] == "probe.mm"][-1]
    assert probe["attrs"] == {"n": 256}
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert probe["start_ns"] <= start and end <= probe["end_ns"]


def test_records_from_any_thread_and_device_values_read_once(monkeypatch):
    """A range on another thread has no parent there and takes the
    iteration of the step range open on the main thread; a tensor counter
    reads as a number; the buffer keeps the newest records."""
    def worker():
        with tracing.region("step.warp.backward"):
            tracing.count("step.visible", torch.tensor(5))

    t0 = time.time_ns()
    with cpu_profile():
        with tracing.region("trainer.step", iteration=7):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    got = since(t0)
    back = [r for r in got["ranges"] if r["name"] == "step.warp.backward"]
    step = [r for r in got["ranges"] if r["name"] == "trainer.step"]
    assert len(back) == len(step) == 1 and back[0]["thread"] != step[0]["thread"]
    assert back[0]["parent"] is None and back[0]["iteration"] == 7
    (c,) = [c for c in got["counters"] if c["name"] == "step.visible"]
    assert c["value"] == 5 and isinstance(c["value"], int) and c["iteration"] == 7

    monkeypatch.setattr(tracing, "_ranges", collections.deque(maxlen=3))
    with cpu_profile():
        for k in range(5):
            with tracing.region("render.bin", k=k):
                pass
    assert [r["attrs"]["k"] for r in tracing.snapshot()["ranges"]] == [2, 3, 4]


def test_launches_count_with_and_without_a_profiler(monkeypatch):
    monkeypatch.setattr(tracing, "_launches", collections.Counter())
    tracing.launched("warp_forward")
    t0 = time.time_ns()
    with cpu_profile():
        tracing.launched("warp_forward")
        tracing.launched("blend_backward")
    got = tracing.launches()
    assert got == collections.Counter(blend_backward=1, warp_forward=2)
    assert got["ssim_forward"] == 0  # a kernel never launched reads 0
    assert [(c["name"], c["value"]) for c in since(t0)["counters"]] == [
        ("kernel.warp_forward.launches", 1), ("kernel.blend_backward.launches", 1)]
