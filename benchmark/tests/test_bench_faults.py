"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at
the tiny size on the CPU, judged by the cell's own limits. Once for each
fault a training cell on one card can have (no exchange between chips
exists in it), and for the control: the reference computed with TF32
rounding, put in the program's place."""

import pytest

from benchmark import calibrate, compare, run as run_mod
from benchmark.drivers import train_block as tb
from benchmark.tests.tiny_cells import CPU, TRAFFIC, tiny_config, use_tiny_cells

SEED = 2**31 + 4242


def limits(workload):
    return compare.load_limits(f"{run_mod.HERE}/limits/{workload}.json")


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    import binocular3dgs_torch.train.loop as loop_mod

    real = loop_mod.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def unchanged(state, *a):
            _, metrics = step(tb.clone_state(state), *a)
            return state.replace(adam_step=state.adam_step + 1), metrics

        return unchanged

    monkeypatch.setattr(loop_mod, "make_train_step", make)
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell("llff3.train", SEED, 0.0, False, CPU)
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    import binocular3dgs_torch.train.step as step_mod

    for name in ("l1_loss", "ssim", "smooth_loss"):
        monkeypatch.setattr(step_mod, name, calibrate.half_batch(getattr(step_mod, name)))
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell("llff3.train", SEED, 0.0, False, CPU)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


def test_a_densification_that_leaves_the_state_unchanged(monkeypatch):
    import binocular3dgs_torch.models.densify as densify_mod

    def unchanged(state, *args, **kwargs):
        n = int(state.model.active.sum())
        return densify_mod.DensifyResult(state, n, n, n)

    monkeypatch.setattr(densify_mod, "densify_and_prune", unchanged)
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell("blender8.train", SEED, 0.0, False, CPU)
    assert not out["correct"]
    assert out["checks"]["densify_rows"]["value"] > 0


def test_a_densification_that_drops_the_adam_moments(monkeypatch):
    """The moments that densification carries into the start state of
    every timed block are compared with the reference's."""
    import binocular3dgs_torch.models.densify as densify_mod
    from binocular3dgs_torch.train.state import zeros_like_params

    real = densify_mod.densify_and_prune

    def dropped(*args, **kwargs):
        out = real(*args, **kwargs)
        state = out.state.replace(adam_m=zeros_like_params(out.state.adam_m))
        return densify_mod.DensifyResult(state, *out[1:])

    monkeypatch.setattr(densify_mod, "densify_and_prune", dropped)
    use_tiny_cells(monkeypatch)
    out = run_mod.run_cell("llff3.train", SEED, 0.0, False, CPU)
    assert not out["correct"]
    assert out["checks"]["densify_gap"]["value"] > out["checks"]["densify_gap"]["limit"]


@pytest.mark.parametrize("workload,name", [("llff3.train", "llff_3view"),
                                           ("blender8.train", "blender_8view")])
def test_the_control_is_not_correct(workload, name):
    config = tiny_config(name)
    su = tb.setup(config, TRAFFIC, SEED, CPU)
    sound, _ = tb.numbers(su, config)
    assert compare.judge(sound, limits(workload))[0], sound
    nums, _ = tb.numbers(su, config, prog=tb.reference_warmup(su, config, True),
                         post=tb.reference_post(su, config, True),
                         block=tb.reference_block(su, config, True))
    ok, checks = compare.judge(nums, limits(workload))
    assert not ok, checks
