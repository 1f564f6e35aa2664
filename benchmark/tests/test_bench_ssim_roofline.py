"""train.ssim_roofline on made-up counters and device events."""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def reader():
    spec = importlib.util.spec_from_file_location(
        "ssim_roofline", os.path.join(HERE, "..", "metrics", "train.ssim_roofline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EVENTS = [(0, 100, "void at::native::reduce_kernel"),
          (200, 1200, "void b3dgs::ssim_forward_kernel<true>(float const*)"),
          (1300, 1310, "void b3dgs::ssim_forward_mean_kernel(float const*)"),
          (2000, 3190, "void b3dgs::ssim_backward_kernel(float const*)"),
          (4000, 9000, "void b3dgs::ssim_forward_kernel<true>(float const*)")]


def ctx_with(monkeypatch, counters, events=EVENTS):
    from binocular3dgs_torch import tracing

    ranges = [dict(name="step.forward", thread=1, start_ns=0, end_ns=9000, parent=None,
                   attrs={}, iteration=None)]
    monkeypatch.setattr(tracing, "snapshot", lambda: dict(ranges=ranges, counters=counters))
    return dict(trace=dict(events=events))


def ctr(value, t):
    return dict(name="loss.ssim_elems", value=value, t_ns=t, thread=1, range=None,
                iteration=None)


def test_the_first_call_over_its_three_kernels(monkeypatch):
    m = reader()
    elems = 9_144_576  # 3 x 1512 x 2016
    ctx = ctx_with(monkeypatch, [ctr(elems, 150), ctr(1, 3900)])
    bound, binds = m.bound_ms(elems)
    assert binds == "bytes"
    assert bound == pytest.approx(44 * elems / 3.35e12 * 1e3)
    assert m.INSTR_PER_ELEM * elems / 33.5e12 * 1e3 < bound
    # 1000 + 10 + 1190 ns of the first call's kernels
    assert m.read(ctx) == pytest.approx(100.0 * bound / 2.2e-3)


def test_nothing_to_read(monkeypatch):
    m = reader()
    assert m.read(ctx_with(monkeypatch, [])) is None  # a program without the counter
    plain = [e for e in EVENTS if "ssim" not in e[2]]
    assert m.read(ctx_with(monkeypatch, [ctr(5, 150)], plain)) is None
    assert m.read({}) is None
