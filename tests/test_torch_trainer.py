"""The port's trainer (train/loop.py) against the JAX trainer's protocol:
`_fused_span` equal to JAX `Trainer._fused_span` over a grid of iterations
and configs; spans of one step (`fused_steps=1`) and the default spans give
the per-step trajectory bit for bit when the pair capacity does not grow;
the default spans read the device once per span (counted against the renders
of a wrapped `render_fn`); and `Trainer(render_fn=render_dense)` trains, as
JAX `tests/test_trainer_e2e.py` does."""

import itertools
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.train.loop import Trainer as JaxTrainer
from binocular3dgs_torch.config import Config
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.data.dataset import Scene, View
from binocular3dgs_torch.data.ply import PointCloud
from binocular3dgs_torch.data.readers import SceneInfo
from binocular3dgs_torch.models.gaussians import PARAM_NAMES
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.ops.rasterize_reference import render_dense
from binocular3dgs_torch.train import loop
from binocular3dgs_torch.train.loop import Trainer

SPAN_CONFIGS = [
    dict(fused_steps=f, densification_interval=di, densify_from_iter=df,
         shift_cam_start=sc, binocular_consistency=bc, opacity_decay=od,
         densify_until_iter=du, marks=mk)
    for f, di, df, sc, bc, od, du, mk in [
        (0, 100, 500, 20_000, True, True, 15_000, ((), (), ())),
        (0, 10, 5, 15, True, True, 15_000, ((1, 40), (40,), (10, 20))),
        (0, 20, 20, 20, True, False, 45, ((60,), (60,), (30, 60))),
        (1, 10, 5, 15, True, True, 15_000, ((25,), (), ())),
        (7, 10, 0, 33, True, False, 3000, ((17, 999), (1001,), ())),
        (3, 100, 500, 20_000, False, True, 15_000, ((2000,), (), (1500,))),
        (0, 7, 13, 0, True, True, 15_000, ((), (50,), (51,))),
    ]
]


def set_span_config(cfg, c):
    cfg.train.fused_steps = c["fused_steps"]
    cfg.opt.densification_interval = c["densification_interval"]
    cfg.opt.densify_from_iter = c["densify_from_iter"]
    cfg.opt.densify_until_iter = c["densify_until_iter"]
    cfg.train.shift_cam_start = c["shift_cam_start"]
    cfg.train.binocular_consistency = c["binocular_consistency"]
    cfg.train.opacity_decay = c["opacity_decay"]
    (cfg.train.test_iterations, cfg.train.save_iterations,
     cfg.train.checkpoint_iterations) = c["marks"]
    return cfg


@pytest.mark.parametrize("k", range(len(SPAN_CONFIGS)))
def test_fused_span_matches_jax(k):
    c = SPAN_CONFIGS[k]
    cfg, jcfg = set_span_config(Config(), c), set_span_config(JaxConfig(), c)
    frm = c["shift_cam_start"] + 1
    for iterations, it in itertools.product((60, 1200, 2500), range(1, 2501, 1)):
        if it > iterations:
            continue
        want = JaxTrainer._fused_span(SimpleNamespace(cfg=jcfg), it, iterations, frm)
        got = Trainer._fused_span(SimpleNamespace(cfg=cfg), it, iterations, frm)
        assert got == want, (iterations, it)


# -- training -------------------------------------------------------------------


def toy_scene(n=30, w=40, h=30, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.4 + [0, 0, 4]
    views = []
    for i, tx in enumerate((-0.1, 0.0, 0.1)):
        cam = make_camera(np.eye(3), np.array([tx, 0.0, 0.0]), 0.9, 0.7, w, h, device="cpu")
        views.append(View(cam, rng.random((h, w, 3)).astype(np.float32), None, f"v{i}", i, i))
    info = SceneInfo(PointCloud(points=pts, colors=rng.random((n, 3))), [], [],
                     {"radius": 1.0, "translate": np.zeros(3)}, None)
    return Scene(views, [], 1.0, info)


def toy_config(fused_steps=0):
    cfg = Config()
    cfg.opt.densify_from_iter, cfg.opt.densification_interval = 5, 10
    cfg.opt.densify_grad_threshold = 1e-5
    cfg.train.shift_cam_start = 15
    cfg.train.test_iterations = cfg.train.save_iterations = ()
    cfg.train.fused_steps = fused_steps
    return cfg


def per_step(trainer, iterations):
    """The trainer's loop before spans: a step, the pair-capacity check and
    densification after every iteration."""
    cfg, opt = trainer.cfg, trainer.cfg.opt
    for it in range(1, iterations + 1):
        if it % 1000 == 0:
            trainer.state = trainer.state.replace(model=trainer.state.model.one_up_sh_degree())
        binocular = cfg.train.binocular_consistency and it > cfg.train.shift_cam_start
        view = trainer.rng.randrange(len(trainer.views))
        trans = trainer._draw_trans() if binocular else None
        trainer.state, m = trainer.steps[binocular](
            trainer.state, trainer.cams[view], trainer.gt_images[view],
            trainer.alpha_weights[view], it, trans, trainer.bg)
        trainer._maybe_grow_pair_capacity(int(m.num_pairs), int(m.max_tile_pairs),
                                          m.pair_capacity, it)
        if opt.densify_from_iter < it < iterations and it % opt.densification_interval == 0:
            trainer._densify()
    return trainer.state


def state_bits(state):
    out = {"active": state.model.active.numpy()}
    for prefix, tree in (("params", state.model.params), ("adam_m", state.adam_m),
                         ("adam_v", state.adam_v)):
        out.update({f"{prefix}.{n}": getattr(tree, n).numpy() for n in PARAM_NAMES})
    out.update({n: getattr(state, n).numpy() for n in ("grad_accum", "denom", "max_radii2d")})
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (see tests/test_torch_checkpoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spans_give_the_per_step_trajectory_bit_for_bit():
    """25 iterations (densification at 10 and 20, the binocular branch from
    16): the per-step loop, spans of one step and the default spans (1-10,
    11-15, 16-20, 21-25) end in the same state, every bit, and log the same
    losses; the pair capacity never nears its limit here."""
    scene = toy_scene()
    ref = per_step(Trainer(toy_config(), scene, device="cpu"), 25)
    logs = []
    for fused in (1, 0):
        trainer = Trainer(toy_config(fused), scene, device="cpu")
        got = trainer.train(25, progress=lambda e: None)
        assert trainer.raster.pairs_per_gaussian == 12
        want_bits = state_bits(ref)
        for k, v in state_bits(got).items():
            assert v.dtype == want_bits[k].dtype and v.shape == want_bits[k].shape, k
            np.testing.assert_array_equal(v.view(np.uint8), want_bits[k].view(np.uint8),
                                          err_msg=k)
        assert got.adam_step == ref.adam_step == 25
        logs.append([(e.iteration, e.loss, e.disparity_loss, e.points) for e in trainer.log])
    assert logs[0] == logs[1] and [x[0] for x in logs[0]] == [10, 20]
    assert logs[0][1][2] > 0 and logs[0][1][3] > logs[0][0][3]  # binocular; densified at 20


def count_reads(monkeypatch):
    """Counts the trainer loop's reads of tensor values (loop.py's frames;
    its host draws from the CPU generator in `_draw_trans` excluded)."""
    reads = []
    for name in ("tolist", "item", "__int__", "__float__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            f = sys._getframe(1).f_code
            if f.co_filename == loop.__file__ and f.co_name != "_draw_trans":
                reads.append(f.co_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


@pytest.mark.parametrize("fused_steps", [0, 1])
def test_spans_read_the_device_once_per_span(monkeypatch, fused_steps):
    """The reads counted against a wrapped render_fn's calls (one per
    iteration with the binocular branch off): with the default spans the
    loop reads once after each span's last step and never inside a span;
    with fused_steps=1 once after every step."""
    cfg = toy_config(fused_steps)
    cfg.train.binocular_consistency = False
    reads = count_reads(monkeypatch)
    reads_before_render = []

    def render_fn(cam, model, bg, mean2d_carrier=None):
        reads_before_render.append(len(reads))
        return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)

    trainer = Trainer(cfg, toy_scene(), device="cpu", render_fn=render_fn)
    trainer.train(25)
    reads_before_render.append(len(reads))
    after = np.diff(reads_before_render)  # reads after each iteration's step
    assert len(after) == 25
    ends = [10, 20, 25] if fused_steps == 0 else list(range(1, 26))
    assert [i + 1 for i in np.flatnonzero(after)] == ends
    assert set(after[np.flatnonzero(after)]) == {1} and set(reads) == {"train"}


def test_trainer_trains_with_the_dense_oracle():
    """Trainer(render_fn=render_dense): 60 iterations (densification at 20
    and 40, the binocular branch from 31) lower the L1 on the training
    views and never call render_tiled."""
    scene = toy_scene(n=40, seed=3)
    cfg = toy_config()
    cfg.opt.densification_interval, cfg.train.shift_cam_start = 20, 30
    calls = []

    def render_fn(cam, model, bg, mean2d_carrier=None):
        calls.append(1)
        return render_dense(cam, model, bg, mean2d_carrier=mean2d_carrier)

    trainer = Trainer(cfg, scene, device="cpu", render_fn=render_fn)
    tiled = loop.render_tiled
    loop.render_tiled = None  # the trainer must not reach it
    try:
        before = trainer.report(0)["train"]["l1"]
        trainer.train(60)
        after = trainer.report(60)["train"]["l1"]
    finally:
        loop.render_tiled = tiled
    assert after < 0.9 * before, (before, after)
    assert len(calls) == 5 + 30 + 2 * 30 + 5  # reports, 30 steps, 30 binocular steps
    assert int(trainer.state.model.count()) <= trainer.state.model.capacity
