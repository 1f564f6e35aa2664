"""Checkpoints: the port's npz against the JAX package's on the same state
(keys, dtypes, shapes and values, padded rows included), both directions
of interchange, one binocular step from a JAX checkpoint in both packages,
`find_latest_checkpoint`, and `cli train --device cpu` with
`--checkpoint_iterations`, `--start_checkpoint`, `--profile_dir` and
`--debug`."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.data.ply import PointCloud as JaxPointCloud
from binocular3dgs_tpu.models.gaussians import create_from_pcd as jax_create_from_pcd
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_tpu.train import loop as jax_loop
from binocular3dgs_tpu.train import state as jax_state
from binocular3dgs_tpu.train.step import make_train_step as jax_make_train_step
from binocular3dgs_torch import cli
from binocular3dgs_torch.config import Config
from binocular3dgs_torch.models.gaussians import PARAM_NAMES
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.train import loop
from binocular3dgs_torch.train.step import make_train_step

from test_torch_project import camera_pair
from test_torch_train import (
    JAX_XLA, STEP_ITER, jax_trans, step_inputs, to_port_state, write_trainable_scene,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module (and OMP_NUM_THREADS=1 for the
    processes it starts): its loops of small ops otherwise starve the
    OpenMP barriers of the other test workers running beside it, and
    theirs its own (minutes per test under six workers, seconds alone)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def jax_train_state(seed=0, n=20, cap=64, max_sh=2, active_sh=1, step=7, scale=2.5):
    """A JAX TrainState mid-run: a padded capacity, active_sh_degree > 0,
    nonzero moments on the active rows, statistics and a step count."""
    rng = np.random.default_rng(seed)
    pcd = JaxPointCloud(points=rng.normal(size=(n, 3)) + [0, 0, 4], colors=rng.random((n, 3)))
    model = jax_create_from_pcd(pcd, scale, max_sh_degree=max_sh, capacity=cap)
    rest = np.zeros(model.params.f_rest.shape, np.float32)
    rest[:n] = rng.normal(size=(n,) + rest.shape[1:]) * 0.1
    model = model.replace(active_sh_degree=active_sh,
                          params=model.params.replace(f_rest=jnp.asarray(rest)))
    st = jax_state.init_train_state(model)

    def moments(power):
        return jax.tree.map(lambda a: jnp.asarray(np.where(
            np.arange(cap).reshape((-1,) + (1,) * (a.ndim - 1)) < n,
            (rng.normal(size=a.shape) * 1e-3) ** power, 0.0).astype(np.float32)), st.adam_m)

    def row_stat():
        out = np.zeros(cap, np.float32)
        out[:n] = rng.random(n)
        return jnp.asarray(out)

    return st.replace(adam_m=moments(1), adam_v=moments(2), adam_step=jnp.int32(step),
                      grad_accum=row_stat(), denom=row_stat(), max_radii2d=row_stat())


STATE_CASES = {
    "padded_sh1_of_2": dict(seed=0, n=20, cap=64, max_sh=2, active_sh=1, step=7),
    "full_sh3": dict(seed=1, n=32, cap=32, max_sh=3, active_sh=3, step=1500, scale=0.7),
    "fresh_sh0": dict(seed=2, n=5, cap=16, max_sh=1, active_sh=0, step=0, scale=1.0),
}


def read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_npz_matches_jax(case, tmp_path):
    st = jax_train_state(**STATE_CASES[case])
    jax_loop.save_checkpoint(st, 1234, str(tmp_path / "jax.npz"))
    loop.save_checkpoint(to_port_state(st), 1234, str(tmp_path / "port.npz"))
    want, got = read_npz(tmp_path / "jax.npz"), read_npz(tmp_path / "port.npz")
    assert sorted(got) == sorted(want)
    for k in want:  # exact: the same buffers, written as they are
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["adam_step"].shape == () and want["adam_step"].dtype == np.int32
    assert want["params.xyz"].shape[0] == STATE_CASES[case]["cap"]


def assert_states_equal(port, jst):
    """Every buffer and setting of the port's state equal to the JAX
    state's, bit for bit."""
    pm, jm = port.model, jst.model
    assert (pm.max_sh_degree, pm.active_sh_degree, pm.spatial_lr_scale) == (
        jm.max_sh_degree, jm.active_sh_degree, jm.spatial_lr_scale)
    assert port.adam_step == int(jst.adam_step)
    np.testing.assert_array_equal(pm.active.numpy(), np.asarray(jm.active))
    for name, tree, jtree in (("params", pm.params, jm.params), ("adam_m", port.adam_m, jst.adam_m),
                              ("adam_v", port.adam_v, jst.adam_v)):
        for n in PARAM_NAMES:
            g, w = getattr(tree, n).numpy(), np.asarray(getattr(jtree, n))
            assert g.dtype == w.dtype == np.float32, f"{name}.{n}"
            np.testing.assert_array_equal(g, w, err_msg=f"{name}.{n}")
    for n in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(port, n).numpy(), np.asarray(getattr(jst, n)))


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_jax_checkpoint_loads_in_port(case, tmp_path):
    st = jax_train_state(**STATE_CASES[case])
    path = str(tmp_path / "chkpnt99.npz")
    jax_loop.save_checkpoint(st, 99, path)
    got, it = loop.load_checkpoint(path, device="cpu")
    assert it == 99
    assert_states_equal(got, st)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_port_checkpoint_loads_in_jax(case, tmp_path):
    st = jax_train_state(**STATE_CASES[case])
    path = str(tmp_path / "chkpnt42.npz")
    loop.save_checkpoint(to_port_state(st), 42, path)
    want, it = jax_loop.load_checkpoint(path)
    assert it == 42
    assert_states_equal(to_port_state(want), st)
    back, _ = loop.load_checkpoint(path, device="cpu")  # and the port reads its own
    assert_states_equal(back, st)


def test_step_from_jax_checkpoint_matches_jax(tmp_path):
    """One binocular step from a JAX checkpoint with Adam moments, a step
    count and statistics, in both packages, at the tolerances of
    test_torch_train.py::test_binocular_step_matches_jax."""
    m, gt, aw = step_inputs()
    rng = np.random.default_rng(11)
    st = jax_state.init_train_state(m.replace(active_sh_degree=1))
    act = np.asarray(m.active)

    def moments(power):
        return jax.tree.map(lambda a: jnp.asarray(np.where(
            act.reshape((-1,) + (1,) * (a.ndim - 1)), (rng.normal(size=a.shape) * 1e-3) ** power,
            0.0).astype(np.float32)), st.adam_m)

    st = st.replace(adam_m=moments(1), adam_v=moments(2), adam_step=jnp.int32(5),
                    denom=jnp.asarray(act.astype(np.float32) * 2))
    path = str(tmp_path / "chkpnt600.npz")
    jax_loop.save_checkpoint(st, 600, path)

    jst, jit_ = jax_loop.load_checkpoint(path)
    pst, pit = loop.load_checkpoint(path, device="cpu")
    assert jit_ == pit == 600
    jcam, pcam = camera_pair()
    cfg, key = Config(), jax.random.PRNGKey(5)
    trans = jax_trans(key, cfg.train.cam_trans_dist)

    def jax_render(cam, model, bg, mean2d_carrier=None):
        return jax_render_tiled(cam, model, bg, mean2d_carrier=mean2d_carrier, raster=JAX_XLA)

    def port_render(cam, model, bg, mean2d_carrier=None):
        return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)

    jstep = jax_make_train_step(jax_render, JaxConfig(), jst.model.spatial_lr_scale,
                                binocular=True, use_alpha_weight=True)
    want, wm = jstep(jst, jcam, jnp.asarray(gt), jnp.asarray(aw), jnp.int32(STEP_ITER), key,
                     jnp.zeros(3))
    step = make_train_step(port_render, cfg, pst.model.spatial_lr_scale, binocular=True,
                           use_alpha_weight=True)
    got, gm = step(pst, pcam, torch.from_numpy(gt), torch.from_numpy(aw), STEP_ITER, trans,
                   torch.zeros(3))

    for k in ("loss", "l1", "disparity_loss", "alpha_loss"):
        assert abs(float(getattr(gm, k)) - float(getattr(wm, k))) <= 1e-5 * abs(
            float(getattr(wm, k))), k
    assert float(gm.disparity_loss) > 0
    assert got.adam_step == int(want.adam_step) == 6
    for n in PARAM_NAMES:
        # active rows: at SH degree 1 a padded row at the camera centre has a
        # NaN view-direction gradient, which the JAX Adam multiplies by its
        # mask (NaN) and the port's replaces by 0
        g, w = getattr(got.adam_m, n).numpy(), np.asarray(getattr(want.adam_m, n))
        assert not g[~act].any() and np.isnan(w[~act]).any() == (n == "xyz")
        g, w = g[act], w[act]
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w) + 1e-12, n
        gv, wv = getattr(got.adam_v, n).numpy()[act], np.asarray(getattr(want.adam_v, n))[act]
        assert np.linalg.norm(gv - wv) <= 2e-3 * np.linalg.norm(wv) + 1e-20, n
        grad = (w - 0.9 * np.asarray(getattr(jst.adam_m, n))[act]) / 0.1
        sel = np.abs(grad) > 1e-2 * np.abs(grad).max()
        np.testing.assert_allclose(getattr(got.model.params, n).numpy()[act][sel],
                                   np.asarray(getattr(want.model.params, n))[act][sel],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    ga, wa = got.grad_accum.numpy(), np.asarray(want.grad_accum)
    assert np.linalg.norm(ga - wa) <= 1e-3 * np.linalg.norm(wa)
    np.testing.assert_array_equal(got.denom.numpy(), np.asarray(want.denom))
    np.testing.assert_array_equal(got.max_radii2d.numpy(), np.asarray(want.max_radii2d))


LATEST_CASES = {
    "several": ["chkpnt5.npz", "chkpnt30.npz", "chkpnt100.npz", "chkpnt7.npz",
                "chkpnt200.npz.bak", "anomaly_300.npz", "chkpntX.npz", "cfg_args.json"],
    "one": ["chkpnt0.npz"],
    "none": ["anomaly_3.npz", "point_cloud"],
    "empty": [],
    "missing": None,
}


@pytest.mark.parametrize("case", sorted(LATEST_CASES))
def test_find_latest_checkpoint_matches_jax(case, tmp_path):
    d = tmp_path / "model"
    if LATEST_CASES[case] is not None:
        d.mkdir()
        for name in LATEST_CASES[case]:
            (d / name).write_bytes(b"")
    got = loop.find_latest_checkpoint(str(d))
    assert got == jax_loop.find_latest_checkpoint(str(d))
    want = {"several": "chkpnt100.npz", "one": "chkpnt0.npz"}.get(case)
    assert got == (str(d / want) if want else None)
    assert loop.find_latest_checkpoint("") is None


def test_resumed_trainer_takes_the_checkpoint_state(tmp_path):
    """A checkpoint with another capacity, SH degree and spatial_lr_scale
    than the fresh model: the trainer steps at the checkpoint's capacity
    and degree, its step uses the checkpoint's xyz learning-rate scale, and
    the pair capacity, restarted from the config, grows at the first step."""
    from binocular3dgs_torch.data.dataset import Scene
    from binocular3dgs_torch.train.loop import Trainer

    scene, out = str(tmp_path / "scene"), str(tmp_path / "model")
    write_trainable_scene(scene)
    cfg = Config()
    cfg.model.source_path, cfg.model.model_path = scene, out
    cfg.train.binocular_consistency = False
    cfg.train.test_iterations = cfg.train.save_iterations = ()
    cfg.raster.pairs_per_gaussian = 1
    trainer = Trainer(cfg, Scene.load(cfg, device="cpu"), device="cpu")
    fresh = trainer.state.model
    jst = jax_train_state(seed=3, n=40, cap=2 * fresh.capacity, max_sh=1, active_sh=1,
                          step=3, scale=7.0)
    jax_loop.save_checkpoint(jst, 600, str(tmp_path / "c.npz"))
    it = trainer.load_checkpoint(str(tmp_path / "c.npz"))
    assert trainer.state.model.spatial_lr_scale == 7.0 != fresh.spatial_lr_scale
    xyz0 = trainer.state.model.params.xyz.clone()
    trainer.train(it + 1, first_iteration=it + 1)
    st = trainer.state
    assert st.model.capacity == 2 * fresh.capacity and st.model.active_sh_degree == 1
    assert st.adam_step == 4 and int(st.model.count()) == 40
    # Adam moves xyz by lr(it) * m_hat / sqrt(v_hat); the checkpoint's moments
    # put that ratio near 1 somewhere, far above the fresh scale's lr (~60x
    # smaller than the checkpoint's)
    from binocular3dgs_torch.train.state import xyz_lr_fn

    moved = float((st.model.params.xyz - xyz0).abs().max())
    assert moved > 10 * xyz_lr_fn(cfg.opt, fresh.spatial_lr_scale)(it + 1)
    assert trainer.raster.pairs_per_gaussian == 2 and cfg.raster.pairs_per_gaussian == 1


# -- cli train ---------------------------------------------------------------


def train_argv(scene, out, iterations, *extra):
    return ["train", "-s", scene, "-m", out, "--device", "cpu", "--iterations", str(iterations),
            "--shift_cam_start", "15", "--densify_from_iter", "5",
            "--densification_interval", "10", "--densify_grad_threshold", "0.005",
            "--test_iterations", str(iterations), "--save_iterations", str(iterations),
            "--seed", "1", "-q", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli train for 20 iterations with checkpoints at 10 and 20."""
    root = tmp_path_factory.mktemp("ckpt_cli")
    scene, out = str(root / "scene"), str(root / "model")
    write_trainable_scene(scene)
    assert cli.main(train_argv(scene, out, 20, "--checkpoint_iterations", "10", "20")) == 0
    return scene, out


def test_cli_writes_checkpoints(trained):
    scene, out = trained
    assert sorted(f for f in os.listdir(out) if f.startswith("chkpnt")) == [
        "chkpnt10.npz", "chkpnt20.npz"]
    st, it = loop.load_checkpoint(os.path.join(out, "chkpnt20.npz"), device="cpu")
    assert it == 20 and st.adam_step == 20
    st10, _ = loop.load_checkpoint(os.path.join(out, "chkpnt10.npz"), device="cpu")
    assert st10.adam_step == 10 and int(st10.model.count()) > 80  # densified at 10
    with open(os.path.join(out, "cfg_args.json")) as f:
        assert json.load(f)["train"]["checkpoint_iterations"] == [10, 20]


def test_cli_resumes_from_latest(trained, tmp_path, capsys):
    scene, out = trained
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    for name in ("chkpnt10.npz", "chkpnt20.npz"):
        with open(os.path.join(out, name), "rb") as src, \
                open(os.path.join(resumed, name), "wb") as dst:
            dst.write(src.read())
    capsys.readouterr()
    assert cli.main(train_argv(scene, resumed, 30, "--start_checkpoint", "latest",
                               "--checkpoint_iterations", "30")) == 0
    text = capsys.readouterr().out
    assert f"Resumed from {os.path.join(resumed, 'chkpnt20.npz')} at iteration 20" in text
    with open(os.path.join(resumed, "train_log.json")) as f:
        assert [e["iteration"] for e in json.load(f)] == [30]  # 21..30 ran
    st, it = loop.load_checkpoint(os.path.join(resumed, "chkpnt30.npz"), device="cpu")
    assert it == 30 and st.adam_step == 30
    assert os.path.exists(os.path.join(resumed, "point_cloud", "iteration_30", "point_cloud.ply"))


def test_cli_resumes_from_a_path_and_starts_fresh_without_one(trained, tmp_path, capsys):
    scene, out = trained
    capsys.readouterr()
    fresh = str(tmp_path / "fresh")
    assert cli.main(train_argv(scene, fresh, 2, "--start_checkpoint", "latest")) == 0
    assert "No checkpoint found; starting fresh" in capsys.readouterr().out
    other = str(tmp_path / "other")
    ckpt = os.path.join(out, "chkpnt10.npz")
    assert cli.main(train_argv(scene, other, 12, "--start_checkpoint", ckpt)) == 0
    assert f"Resumed from {ckpt} at iteration 10" in capsys.readouterr().out


def test_cli_profile_dir_writes_a_trace(trained, tmp_path, capsys):
    scene, _ = trained
    out, prof = str(tmp_path / "model"), str(tmp_path / "prof")
    assert cli.main(train_argv(scene, out, 10, "--profile_dir", prof)) == 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::index_select" in names  # the record gathers of the renders
    # the program's own ranges, in the trace and with its counters beside it
    assert {"trainer.step", "step.backward", "render.blend", "trainer.read"} <= names
    with open(os.path.join(prof, "ranges.json")) as f:
        snap = json.load(f)
    assert sum(r["name"] == "trainer.step" for r in snap["ranges"]) == 10
    assert {"render.pairs_wanted", "trainer.host_reads"} <= {c["name"] for c in snap["counters"]}
    with open(os.path.join(out, "train_log.json")) as f:
        assert [e["iteration"] for e in json.load(f)] == [10]  # all 10 ran, profiled


def test_cli_debug_dumps_the_state_on_a_non_finite_loss(trained, tmp_path):
    scene, _ = trained
    out = str(tmp_path / "model")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        cli.main(train_argv(scene, out, 10, "--debug", "--lambda_dssim", "nan"))
    st, it = loop.load_checkpoint(os.path.join(out, "anomaly_1.npz"), device="cpu")
    assert it == 1 and st.adam_step == 1
    want, _ = jax_loop.load_checkpoint(os.path.join(out, "anomaly_1.npz"))  # a JAX npz too
    assert int(want.adam_step) == 1
