"""Scenes and blocks repeat from a seed."""

import pytest
import torch

from benchmark import scene
from benchmark.drivers import train_block as tb
from benchmark.tests.tiny_cells import CPU, tiny_config

BIG_SEED = 2**31 + 12345  # seeds run a little over 32 signed bits


@pytest.mark.parametrize("name", ["llff_3view", "blender_8view"])
def test_a_scene_repeats_from_its_seed(name):
    a = scene.make_scene(tiny_config(name), BIG_SEED, CPU)
    b = scene.make_scene(tiny_config(name), BIG_SEED, CPU)
    c = scene.make_scene(tiny_config(name), BIG_SEED + 1, CPU)
    for n in a.model:
        assert torch.equal(a.model[n], b.model[n])
    for x, y in zip(a.gt, b.gt):
        assert torch.equal(x, y)
    assert not torch.equal(a.model["xyz"], c.model["xyz"])
    assert not torch.equal(a.gt[0], c.gt[0])
    assert a.extent == b.extent > 0
    assert int(a.active.sum()) == 400 and a.active.shape[0] == 1024


def test_sub_seeds_take_large_seeds_and_differ():
    s = {scene.sub_seed(seed, k) for seed in (0, 2**31 + 7, 2**40) for k in range(4)}
    assert len(s) == 12 and all(0 <= x < 2**63 for x in s)


def test_the_draws_of_a_block_repeat():
    assert tb.draws(BIG_SEED, 3, 0.4, 5) == tb.draws(BIG_SEED, 3, 0.4, 5)
    views = [v for v, _ in tb.draws(BIG_SEED, 8, 0.4, 50)]
    shifts = [t for _, t in tb.draws(BIG_SEED, 8, 0.4, 50)]
    assert set(views) <= set(range(8)) and all(abs(t) <= 0.4 for t in shifts)


def test_the_trainer_draws_what_the_reference_works_out(monkeypatch):
    """The views and shifts that the reference follows are those the
    program's trainer draws: its view RNG and its shift generator, step by
    step."""
    config = tiny_config("llff_3view")
    sd = scene.make_scene(config, BIG_SEED, CPU)
    trainer = tb.build_trainer(tb.port_config(config, 99), sd, CPU)
    got = [(trainer.rng.randrange(len(sd.cams)), trainer._draw_trans())
           for _ in range(4)]
    assert got == tb.draws(99, len(sd.cams), 0.4, 4)


def test_blocks_repeat_from_the_start_state():
    """Two blocks from the same start end in the same state: each block
    restores the state and reseeds the draws."""
    config = tiny_config("blender_8view")
    from benchmark.tests.tiny_cells import TRAFFIC

    su = tb.setup(config, TRAFFIC, BIG_SEED, CPU)
    ends = []
    for _ in range(2):
        tb.restore(su.trainer, su.start)
        su.trainer.train(iterations=su.first + su.n_it - 1, first_iteration=su.first)
        ends.append(tb.clone_state(su.trainer.state))
    for n in ("xyz", "opacity", "f_dc"):
        assert torch.equal(getattr(ends[0].model.params, n), getattr(ends[1].model.params, n))
    assert torch.equal(ends[0].model.active, ends[1].model.active)
