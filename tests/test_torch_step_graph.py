"""What the CUDA-graph step rests on, on the CPU: the trainer's steps run
eagerly there and never capture; a shift given as a 0-d tensor moves the
camera as the number does; Adam with its bias corrections as factors (host
numbers or 0-d tensors) corrects the moments within two ulps of the
division on the CPU and gives the same bits either way; the tracing recording that a capture keeps,
and what a replay gives again from it. The graphs themselves run on a card
only (tests/test_torch_cuda.py)."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from binocular3dgs_torch import tracing
from binocular3dgs_torch.core.camera import make_camera, shift_camera
from binocular3dgs_torch.models.gaussians import PARAM_NAMES, GaussianParams
from binocular3dgs_torch.train.loop import Trainer
from binocular3dgs_torch.train.state import ADAM_EPS, adam_update, bias_corrections
from test_torch_trainer import toy_config, toy_scene


def test_the_cpu_trainer_never_captures():
    trainer = Trainer(toy_config(), toy_scene(), device="cpu")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(18)
    graphs = trainer.steps[True].graphs
    assert trainer.steps[False].graphs is graphs
    assert (graphs.captures, graphs.replays) == (0, 0)
    names = collections.Counter(c["name"] for c in tracing.snapshot(since_ns=t0)["counters"])
    assert names["step.graph_replays"] == names["step.graph_captures"] == 0
    assert names["step.visible"] == 18
    assert not any(r["name"] == "step.replay" for r in tracing.snapshot(since_ns=t0)["ranges"])


def test_a_given_render_fn_runs_eagerly():
    from binocular3dgs_torch.ops.rasterize_reference import render_dense

    trainer = Trainer(toy_config(), toy_scene(), device="cpu", render_fn=render_dense)
    assert not hasattr(trainer.steps[True], "graphs")


@pytest.mark.parametrize("trans", [0.0, 0.2, -0.37, 1e-7])
@pytest.mark.parametrize("angle", [0.0, 0.4, -1.1])
def test_shift_camera_with_a_tensor_shift_equals_the_number(trans, angle):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)], [0.0, np.sin(0.3), np.cos(0.3)]])
    cam = make_camera(R, np.array([0.3, -0.2, 4.0]), 0.9, 0.7, 64, 48, device="cpu")
    by_number = shift_camera(cam, trans)
    by_tensor = shift_camera(cam, torch.tensor(trans, dtype=torch.float32))
    for name in ("world_view", "full_proj", "cam_center", "proj", "tanfovx", "tanfovy"):
        a, b = getattr(by_number, name), getattr(by_tensor, name)
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), name
    moved = by_number.cam_center - cam.cam_center
    x_axis = cam.world_view[:3, 0]  # the camera's x axis in world space
    assert torch.allclose(moved, np.float32(trans) * x_axis, atol=1e-6)


def test_a_graphs_camera_keeps_the_layout_of_the_camera_it_is_given():
    """The graph's camera buffer, staged from another view's camera in one
    launch, holds that camera's values with make_camera's (column-major)
    strides, so a graph asks cuBLAS for the products an eager step asks
    for."""
    from binocular3dgs_torch.train.step import _camera_tensors, _stage_camera, _static_camera

    def cam(a):
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        return make_camera(R, np.array([0.1, a, 4.0]), 0.9, 0.7, 64, 48, device="cpu")

    first, other = cam(0.3), cam(-0.8)
    static, values, layout = _static_camera(first)
    assert values.numel() == 16 * 3 + 3 + 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stage_camera(other, values, layout)
    assert collections.Counter(e.name for e in prof.events())["aten::cat"] == 1
    for name, t in _camera_tensors(other).items():
        s = getattr(static, name)
        assert s.stride() == t.stride() and torch.equal(s, t), name
        assert s.untyped_storage().data_ptr() == values.untyped_storage().data_ptr()
    assert first.world_view.stride() == (1, 4)  # make_camera's layout, kept
    assert static.width == other.width and static.znear == other.znear


def adam_inputs(seed, n=4096):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(xyz=(n, 3), f_dc=(n, 1, 3), f_rest=(n, 3, 3), opacity=(n, 1),
                  scaling=(n, 3), rotation=(n, 4))

    def tree(scale, positive=False):
        return GaussianParams(**{
            k: (torch.rand(s, generator=g) * scale if positive
                else torch.randn(s, generator=g) * scale) for k, s in shapes.items()})

    active = torch.rand(n, generator=g) < 0.9
    return tree(1.0), tree(1e-3), tree(1e-3), tree(1e-6, positive=True), active


def parent_adam(params, grads, m, v, step, lrs, active):
    """The update as the port computed it before its step was graphed:
    the bias corrections host numbers computed inside."""
    t = step + 1
    b1t = 1.0 - float(np.float32(0.9) ** np.float32(t))
    b2t = 1.0 - float(np.float32(0.999) ** np.float32(t))
    for n in PARAM_NAMES:
        p, gr, mi, vi = (getattr(x, n) for x in (params, grads, m, v))
        mask = active.reshape((-1,) + (1,) * (p.ndim - 1))
        gr = torch.where(mask, gr, 0.0)
        mi.mul_(0.9).add_((1.0 - 0.9) * gr)
        vi.mul_(0.999).add_((1.0 - 0.999) * (gr * gr))
        p.copy_(torch.where(mask, p - lrs[n] * (mi / b1t) / (torch.sqrt(vi / b2t) + ADAM_EPS),
                            p))


def clone(tree):
    return GaussianParams(**{n: getattr(tree, n).clone() for n in PARAM_NAMES})


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 units in the last place between
    `a` and `b` (same signs)."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def spacing(x: torch.Tensor) -> torch.Tensor:
    """The float32 ulp at |x|."""
    x = x.abs()
    return torch.nextafter(x, torch.tensor(float("inf"))) - x


@pytest.mark.parametrize("step", [0, 1, 7, 4001, 4005, 20001])
def test_adam_with_factors_is_within_an_ulp_of_the_division(step):
    """The bias corrections as factors (the reciprocals of the parent's
    divisors, rounded from double, which a card's division by a host
    number multiplies by): on the CPU, which divides, the corrected moments
    within two ulps of the division and the parameters within the rounding
    those ulps pass through; host numbers and 0-d tensors the same bits."""
    params, grads, m, v, active = adam_inputs(step)
    lrs = dict(xyz=1.6e-4, f_dc=2.5e-3, f_rest=1.25e-4, opacity=0.05, scaling=5e-3,
               rotation=1e-3)
    b1t_inv, b2t_inv = bias_corrections(step)
    b1t = 1.0 - float(np.float32(0.9) ** np.float32(step + 1))
    b2t = 1.0 - float(np.float32(0.999) ** np.float32(step + 1))
    assert (b1t_inv, b2t_inv) == (float(np.float32(1.0 / b1t)), float(np.float32(1.0 / b2t)))

    ref = [clone(params), clone(m), clone(v)]
    parent_adam(ref[0], grads, ref[1], ref[2], step, lrs, active)
    runs = []
    for corrections in (None, tuple(torch.tensor(x) for x in (b1t_inv, b2t_inv))):
        p, mi, vi = clone(params), clone(m), clone(v)
        lr = lrs if corrections is None else dict(lrs, xyz=torch.tensor(lrs["xyz"]))
        assert adam_update(p, grads, mi, vi, step, lr, active, corrections) == step + 1
        runs.append((p, mi, vi))
    for n in PARAM_NAMES:
        mi, vi = getattr(runs[0][1], n), getattr(runs[0][2], n)
        assert torch.equal(mi, getattr(ref[1], n)) and torch.equal(vi, getattr(ref[2], n))
        # the bias-corrected moments: the factor against the division, an
        # ulp for the factor's rounding and one for the product's
        assert ulps(mi * b1t_inv, mi / b1t) <= 2 and ulps(vi * b2t_inv, vi / b2t) <= 2, n
        # the parameters: those ulps pass through the square root, the
        # ratio, the learning rate and the difference, so within 8 ulps of
        # the larger of the value before and after
        a, b, before = getattr(runs[0][0], n), getattr(ref[0], n), getattr(params, n)
        bound = 8 * spacing(torch.maximum(before.abs(), b.abs()))
        assert bool(((a - b).abs() <= bound).all()), n
        # host numbers and 0-d tensors give the same bits
        for x, y in zip(runs[0], runs[1]):
            assert torch.equal(getattr(x, n), getattr(y, n)), n


def test_a_recording_keeps_counters_and_launches_off_the_totals():
    t0 = time.time_ns()
    before = tracing.launches()
    value = torch.tensor(5, dtype=torch.int32)
    with tracing.recording() as rec:
        tracing.count("probe.rows", 7)
        tracing.count("probe.value", value)
        tracing.launched("probe_kernel")
        tracing.launched("probe_kernel")
    assert tracing.launches() == before
    assert rec.launches == collections.Counter(probe_kernel=2)
    assert rec.counters == [("probe.rows", 7), ("probe.value", value),
                            ("kernel.probe_kernel.launches", 1),
                            ("kernel.probe_kernel.launches", 1)]
    assert tracing.snapshot(since_ns=t0)["counters"] == []
    with pytest.raises(RuntimeError):
        with rec, tracing.recording():
            pass

    tracing.replayed(rec)  # the recorder off: the totals only
    assert tracing.launches() - before == collections.Counter(probe_kernel=2)
    assert tracing.snapshot(since_ns=t0)["counters"] == []
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.replayed(rec)
        value.fill_(9)  # a later replay writes the static value again
    assert tracing.launches() - before == collections.Counter(probe_kernel=4)
    got = [(c["name"], c["value"]) for c in tracing.snapshot(since_ns=t0)["counters"]]
    assert got == [("probe.rows", 7), ("probe.value", 5), ("kernel.probe_kernel.launches", 1),
                   ("kernel.probe_kernel.launches", 1)]


def test_copies_are_fresh_and_take_one_launch_a_dtype():
    ts = [torch.tensor(1.5), torch.tensor(2, dtype=torch.int32), torch.tensor(-0.25),
          torch.tensor(7, dtype=torch.int64), torch.tensor(3, dtype=torch.int32)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tracing.copies(ts)
    for t, c in zip(ts, out):
        assert c.dtype == t.dtype and c.shape == () and torch.equal(c, t)
        assert c.data_ptr() != t.data_ptr()
    for t in ts:
        t.fill_(0)
    assert [c.item() for c in out] == [1.5, 2, -0.25, 7, 3]
    ops = collections.Counter(e.name for e in prof.events())
    assert ops["aten::stack"] == 2 and ops["aten::clone"] == 1
