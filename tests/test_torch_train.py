"""The port's training pieces against the JAX package on the same numpy
inputs: masked Adam, densification (with the JAX split normals fed in),
opacity decay and reset, the 3-NN init distances, create_from_pcd, one
whole binocular train step against make_train_step, and an end-to-end
`cli train --device cpu` on a tiny fabricated scene (its checkpoints,
resume, trace and anomaly dump: test_torch_checkpoint.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.config import RasterConfig as JaxRasterConfig
from binocular3dgs_tpu.data.ply import PointCloud as JaxPointCloud
from binocular3dgs_tpu.models import densify as jax_densify
from binocular3dgs_tpu.models.gaussians import GaussianParams as JaxParams
from binocular3dgs_tpu.models.gaussians import create_from_pcd as jax_create_from_pcd
from binocular3dgs_tpu.ops.knn import mean_sq_dist_3nn as jax_knn
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_tpu.train import state as jax_state
from binocular3dgs_tpu.train.step import make_train_step as jax_make_train_step
from binocular3dgs_torch import cli
from binocular3dgs_torch.config import Config
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.data import colmap
from binocular3dgs_torch.data.ply import PointCloud
from binocular3dgs_torch.models import densify
from binocular3dgs_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    create_from_pcd,
    grow_capacity,
)
from binocular3dgs_torch.ops.knn import mean_sq_dist_3nn
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.train import state as state_mod
from binocular3dgs_torch.train.state import adam_update, group_lrs, init_train_state
from binocular3dgs_torch.train.step import make_train_step

from test_rasterize_tiled import random_scene
from test_torch_project import camera_pair


def np_tree(tree):
    return {n: np.asarray(getattr(tree, n)) for n in PARAM_NAMES}


def to_port_state(st):
    """The JAX TrainState `st` as the port's (same buffers, same step)."""
    m = st.model
    return state_mod.from_numpy(
        np_tree(m.params), np.asarray(m.active), np_tree(st.adam_m), np_tree(st.adam_v),
        int(st.adam_step), np.asarray(st.grad_accum), np.asarray(st.denom),
        np.asarray(st.max_radii2d), m.max_sh_degree, m.active_sh_degree, m.spatial_lr_scale,
        device="cpu",
    )


def assert_state_close(got, want, atol=1e-6, rtol=1e-6):
    """Every buffer of the port's state against the JAX state's."""
    assert got.model.capacity == want.model.capacity
    np.testing.assert_array_equal(got.model.active.numpy(), np.asarray(want.model.active))
    for tree in ("params", "adam_m", "adam_v"):
        g = got.model.params if tree == "params" else getattr(got, tree)
        w = want.model.params if tree == "params" else getattr(want, tree)
        for n in PARAM_NAMES:
            np.testing.assert_allclose(getattr(g, n).numpy(), np.asarray(getattr(w, n)),
                                       atol=atol, rtol=rtol, err_msg=f"{tree}.{n}")
    for n in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(want, n)),
                                   atol=atol, rtol=rtol, err_msg=n)


# -- Adam ---------------------------------------------------------------------


def test_adam_matches_jax():
    rng = np.random.default_rng(0)
    n, n_active = 16, 12
    shapes = dict(xyz=(3,), f_dc=(1, 3), f_rest=(3, 3), opacity=(1,), scaling=(3,), rotation=(4,))
    vals = {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in vals.items()}
             for _ in range(3)]
    active = np.arange(n) < n_active
    lrs = group_lrs(Config().opt, 1.6e-4)
    jlrs = jax_state.group_lrs(JaxConfig().opt, 1.6e-4)

    jp = JaxParams(**{k: jnp.asarray(v) for k, v in vals.items()})
    jm, jv = jax_state.zeros_like_params(jp), jax_state.zeros_like_params(jp)
    jt = jnp.zeros((), jnp.int32)
    p = GaussianParams(**{k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    m, v = state_mod.zeros_like_params(p), state_mod.zeros_like_params(p)
    t = 0
    for g in grads:
        jp, jm, jv, jt = jax_state.adam_update(
            jp, JaxParams(**{k: jnp.asarray(x) for k, x in g.items()}), jm, jv, jt, jlrs,
            jnp.asarray(active))
        t = adam_update(p, GaussianParams(**{k: torch.from_numpy(x) for k, x in g.items()}),
                        m, v, t, lrs, torch.from_numpy(active))
    assert t == int(jt) == 3
    # the same float32 expressions; XLA may fuse them with other roundings
    for name, got, want in (("params", p, jp), ("m", m, jm), ("v", v, jv)):
        for k in PARAM_NAMES:
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{name}.{k}")
    for k in PARAM_NAMES:  # padded rows keep their values
        np.testing.assert_array_equal(getattr(p, k).numpy()[n_active:], vals[k][n_active:])


def test_adam_on_the_cpu_is_the_plain_composition(monkeypatch):
    """On CPU tensors `adam_update` runs `adam_update_torch` (the plain
    composition the JAX comparison above holds) and launches no kernel."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU update launched a kernel")

    monkeypatch.setattr(state_mod, "launch", no_launch)
    rng = np.random.default_rng(1)
    shapes = dict(xyz=(3,), f_dc=(1, 3), f_rest=(3, 3), opacity=(1,), scaling=(3,), rotation=(4,))

    def tree(scale=1.0):
        return {k: (rng.normal(size=(32,) + s) * scale).astype(np.float32)
                for k, s in shapes.items()}

    vals, g, m0, v0 = tree(), tree(), tree(1e-3), {k: np.abs(x) for k, x in tree(1e-6).items()}
    active = torch.from_numpy(rng.random(32) < 0.7)
    lrs = group_lrs(Config().opt, 1.6e-4)
    runs = []
    for fn in (adam_update, state_mod.adam_update_torch):
        p, mi, vi = (GaussianParams(**{k: torch.from_numpy(x.copy()) for k, x in t.items()})
                     for t in (vals, m0, v0))
        grads = GaussianParams(**{k: torch.from_numpy(x) for k, x in g.items()})
        assert fn(p, grads, mi, vi, 41, lrs, active) == 42
        runs.append([getattr(t, k) for t in (p, mi, vi) for k in PARAM_NAMES])
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))


def test_adam_on_another_device_raises():
    p = GaussianParams(**{k: torch.empty(4, 3, device="meta") for k in PARAM_NAMES})
    with pytest.raises(ValueError, match="unsupported device meta"):
        adam_update(p, p, p, p, 0, group_lrs(Config().opt, 1e-4),
                    torch.ones(4, dtype=torch.bool, device="meta"))


# -- densification --------------------------------------------------------------


def toy_state(n=10, cap=32, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.5 + [0, 0, 5.0]
    pcd = JaxPointCloud(points=pts, colors=rng.random((n, 3)))
    return jax_state.init_train_state(
        jax_create_from_pcd(pcd, spatial_lr_scale=1.0, max_sh_degree=1, capacity=cap))


def with_params(st, **fields):
    return st.replace(model=st.model.replace(params=st.model.params.replace(**fields)))


def hot(st, idx):
    return st.replace(grad_accum=st.grad_accum.at[idx].set(1.0), denom=st.denom.at[idx].set(1.0))


def _scaled(st, v):
    return with_params(st, scaling=jnp.full_like(st.model.params.scaling, v))


DENSIFY_CASES = {
    # the cases of tests/test_train.py::TestDensify
    "noop": lambda: (toy_state(), None),
    "clone": lambda: (hot(_scaled(toy_state(), -10.0), slice(0, 10)), None),
    "split": lambda: (hot(_scaled(toy_state(), np.log(0.5)), slice(0, 10)), None),
    "prune": lambda: (with_params(toy_state(), opacity=toy_state().model.params.opacity
                                  .at[:5, 0].set(-10.0)), None),
    "moments": lambda: (hot(with_params(
        toy_state().replace(adam_m=jax.tree.map(lambda a: a + 2.0, toy_state().adam_m)),
        scaling=toy_state().model.params.scaling.at[0].set(-10.0)), 0), None),
    "overflow": lambda: (hot(_scaled(toy_state(cap=16), -10.0), slice(0, 10)), None),
    "size_threshold": lambda: (toy_state().replace(
        max_radii2d=toy_state().max_radii2d.at[0].set(100.0)), 20.0),
    "mixed": lambda: (hot(with_params(toy_state(n=12, cap=32), scaling=jnp.asarray(
        np.log(np.random.default_rng(3).uniform(0.001, 0.05, (32, 3))).astype(np.float32))),
        slice(0, 8)), None),
}


@pytest.mark.parametrize("case", sorted(DENSIFY_CASES))
def test_densify_matches_jax(case):
    st, max_screen = DENSIFY_CASES[case]()
    if case == "size_threshold":  # one big-in-world point as well
        sc = jnp.full_like(st.model.params.scaling, -5.0)
        st = with_params(st, scaling=sc.at[1].set(np.log(0.5)))
    key = jax.random.PRNGKey(0)
    want = jax_densify.densify_and_prune(st, 2e-4, 0.005, 1.0, 0.01, key,
                                         max_screen_size=max_screen)
    # the normals the JAX version draws (densify.py:154-156)
    k1, k2 = jax.random.split(key)
    cap = st.model.capacity
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (cap, 3)))) for k in (k1, k2))
    got = densify.densify_and_prune(to_port_state(st), 2e-4, 0.005, 1.0, 0.01,
                                    max_screen_size=max_screen, noise=noise)
    assert (got.n_before, got.n_after, got.n_wanted) == (
        int(want.n_before), int(want.n_after), int(want.n_wanted))
    # elementwise float32 algebra (exp, log, a 3x3 rotation of the noise)
    assert_state_close(got.state, want.state, atol=1e-5, rtol=1e-5)
    expected_after = {"noop": 10, "clone": 20, "split": 20, "prune": 5, "moments": 11,
                      "overflow": 16, "size_threshold": 8}
    if case in expected_after:
        assert got.n_after == expected_after[case]


def test_opacity_decay_and_reset_match_jax():
    st = with_params(toy_state(), opacity=toy_state().model.params.opacity.at[:10, 0].set(
        jnp.linspace(-3.0, 3.0, 10)))
    st = st.replace(adam_m=jax.tree.map(lambda a: a + 2.0, st.adam_m))
    for fn_j, fn_p in ((lambda s: jax_densify.opacity_decay(s, 0.995),
                        lambda s: densify.opacity_decay(s, 0.995)),
                       (jax_densify.reset_opacity, densify.reset_opacity)):
        want = fn_j(st)
        got = fn_p(to_port_state(st))
        # sigmoid and its inverse in float32 (logit of p*0.995 near 1 is
        # ill-conditioned)
        assert_state_close(got, want, atol=1e-5, rtol=1e-5)


def test_grow_capacity_pads_with_sentinels():
    st = to_port_state(toy_state(n=10, cap=16))
    grown = grow_capacity(st.model, 32)
    assert grown.capacity == 32 and int(grown.count()) == 10
    for n in PARAM_NAMES:
        assert torch.equal(getattr(grown.params, n)[:16], getattr(st.model.params, n))
    assert (grown.params.scaling[16:] == -20.0).all()
    assert (grown.params.rotation[16:] == torch.tensor([1.0, 0, 0, 0])).all()
    with pytest.raises(ValueError):
        grow_capacity(grown, 16)


# -- initialisation ---------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(300, 128), (50, 1024)])
def test_knn_matches_jax(n, block):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = mean_sq_dist_3nn(torch.from_numpy(pts), block_size=block).numpy()
    want = np.asarray(jax_knn(jnp.asarray(pts), block_size=block))
    # |a|^2 + |b|^2 - 2 a.b in float32 in both: cancellation for near points
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_allclose(got, np.sort(d2, axis=1)[:, :3].mean(1), rtol=1e-4, atol=1e-6)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(7)
    pts, cols = rng.normal(size=(40, 3)) + [0, 0, 4], rng.random((40, 3))
    want = jax_create_from_pcd(JaxPointCloud(points=pts, colors=cols), 2.5, max_sh_degree=2)
    got = create_from_pcd(PointCloud(points=pts, colors=cols), 2.5, max_sh_degree=2,
                          device="cpu")
    assert got.capacity == want.capacity == 128
    assert (got.max_sh_degree, got.active_sh_degree, got.spatial_lr_scale) == (2, 0, 2.5)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for n in PARAM_NAMES:
        # log-scales from the 3-NN distances (see test_knn_matches_jax)
        np.testing.assert_allclose(getattr(got.params, n).numpy(),
                                   np.asarray(getattr(want.params, n)), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# -- one binocular train step -------------------------------------------------------


JAX_XLA = JaxRasterConfig(backend="xla", max_pairs_per_tile=256, chunk=8)
STEP_ITER = 501  # > densify_from_iter (500): opacity decay on


def step_inputs(seed=4, n=40, cap=48, w=64, h=48):
    m = random_scene(seed=seed, n=n, cap=cap)
    rng = np.random.default_rng(seed)
    gt = rng.random((3, h, w)).astype(np.float32)
    aw = rng.random((h, w)).astype(np.float32)
    return m, gt, aw


def jax_trans(key, dist):
    """The shift the JAX step draws from its key (step.py:88-91)."""
    k1, k2 = jax.random.split(key)
    d = jax.random.uniform(k1, ()) * dist
    return float(d * jnp.where(jax.random.bernoulli(k2), 1.0, -1.0))


def test_binocular_step_matches_jax():
    m, gt, aw = step_inputs()
    jcam, pcam = camera_pair()
    jcfg, cfg = JaxConfig(), Config()
    key = jax.random.PRNGKey(3)
    trans = jax_trans(key, cfg.train.cam_trans_dist)
    assert trans != 0.0

    def jax_render(cam, model, bg, mean2d_carrier=None):
        return jax_render_tiled(cam, model, bg, mean2d_carrier=mean2d_carrier, raster=JAX_XLA)

    jstep = jax_make_train_step(jax_render, jcfg, 1.0, binocular=True, use_alpha_weight=True)
    st0 = jax_state.init_train_state(m)
    want, wm = jstep(st0, jcam, jnp.asarray(gt), jnp.asarray(aw), jnp.int32(STEP_ITER), key,
                     jnp.zeros(3))

    def port_render(cam, model, bg, mean2d_carrier=None):
        return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)

    step = make_train_step(port_render, cfg, 1.0, binocular=True, use_alpha_weight=True)
    got, gm = step(to_port_state(st0), pcam, torch.from_numpy(gt), torch.from_numpy(aw),
                   STEP_ITER, trans, torch.zeros(3))

    # loss terms: float32 renders and losses in another order
    for k in ("loss", "l1", "disparity_loss", "alpha_loss"):
        assert abs(float(getattr(gm, k)) - float(getattr(wm, k))) <= 1e-5 * abs(
            float(getattr(wm, k))), k
    assert float(gm.disparity_loss) > 0 and float(gm.alpha_loss) > 0
    assert int(gm.n_visible) == int(wm.n_visible)
    assert int(gm.num_pairs) == int(wm.num_pairs) and gm.pair_capacity == int(wm.pair_capacity)
    assert got.adam_step == int(want.adam_step) == 1
    assert_first_step_state_close(got, want, m)


def assert_first_step_state_close(got, want, m):
    """The port's state after a first binocular step from the JAX model `m`
    against the JAX step's state."""
    # adam_m of the first step is 0.1 * grad: each field within 1e-3 of its
    # own norm (the render gradients agree to ~1e-5 of their largest entry,
    # test_torch_render_grad.py; the warp and losses add float32 sums)
    for n in PARAM_NAMES:
        g, w = getattr(got.adam_m, n).numpy(), np.asarray(getattr(want.adam_m, n))
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w) + 1e-12, n
        gv, wv = getattr(got.adam_v, n).numpy(), np.asarray(getattr(want.adam_v, n))
        assert np.linalg.norm(gv - wv) <= 2e-3 * np.linalg.norm(wv) + 1e-20, n
        # params: Adam's first step is lr * sign(g) wherever g != 0, so a
        # rounding-level g flips a parameter by 2 lr; compare where the
        # gradient is clearly nonzero
        sel = np.abs(w) > 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(getattr(got.model.params, n).numpy()[sel],
                                   np.asarray(getattr(want.model.params, n))[sel],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    # densification statistics: the carrier gradient norms (same reasoning)
    ga, wa = got.grad_accum.numpy(), np.asarray(want.grad_accum)
    assert np.linalg.norm(ga - wa) <= 1e-3 * np.linalg.norm(wa)
    np.testing.assert_array_equal(got.denom.numpy(), np.asarray(want.denom))
    np.testing.assert_array_equal(got.max_radii2d.numpy(), np.asarray(want.max_radii2d))
    assert got.denom.sum() > 0
    # padded rows are untouched
    n_active = int(np.asarray(m.active).sum())
    for n in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(got.model.params, n).numpy()[n_active:],
                                      np.asarray(getattr(m.params, n))[n_active:])


def test_step_without_binocular_skips_the_shift():
    m, gt, aw = step_inputs(seed=5)
    _, pcam = camera_pair()

    def port_render(cam, model, bg, mean2d_carrier=None):
        return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)

    step = make_train_step(port_render, Config(), 1.0, binocular=False, use_alpha_weight=False)
    st = init_train_state(to_port_state(jax_state.init_train_state(m)).model)
    st, metrics = step(st, pcam, torch.from_numpy(gt), torch.from_numpy(aw), 1, 0.3,
                       torch.zeros(3))
    assert float(metrics.disparity_loss) == 0.0 and float(metrics.alpha_loss) == 0.0
    assert st.adam_step == 1 and torch.isfinite(st.model.params.xyz).all()


# -- cli train end to end -------------------------------------------------------------


W, H = 64, 48


def write_trainable_scene(root, n_views=3):
    """A COLMAP scene whose images are renders of a ground-truth cloud, and
    whose points3D are that cloud with noise (so training has signal)."""
    os.makedirs(f"{root}/sparse/0", exist_ok=True)
    os.makedirs(f"{root}/images", exist_ok=True)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(80, 3)) * 0.5 + [0, 0, 5]
    cols = rng.random((80, 3))
    gt_model = create_from_pcd(PointCloud(points=pts, colors=cols), 1.0, device="cpu")
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([60.0, 60.0, W / 2, H / 2]))}
    images = {}
    for i in range(1, n_views + 1):
        ang = (i - 2) * 0.05
        q = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0.0])
        t = np.array([0.1 * (i - 2), 0.0, 0.0])
        images[i] = colmap.ColmapImage(i, q, t, 1, f"im_{i:02d}.png", np.zeros((0, 2)),
                                       np.zeros(0, dtype=np.int64))
        fov = 2 * np.arctan(W / (2 * 60.0)), 2 * np.arctan(H / (2 * 60.0))
        cam = make_camera(colmap.qvec2rotmat(q).T, t, fov[0], fov[1], W, H, device="cpu")
        with torch.no_grad():
            img = render_tiled(cam, gt_model, [0.0, 0.0, 0.0], device="cpu").image
        arr = (np.clip(img.numpy().transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(f"{root}/images/im_{i:02d}.png")
    noisy = pts + rng.normal(size=pts.shape) * 0.05
    colmap.write_cameras_binary(f"{root}/sparse/0/cameras.bin", cams)
    colmap.write_images_binary(f"{root}/sparse/0/images.bin", images)
    colmap.write_points3d_binary(f"{root}/sparse/0/points3D.bin", noisy,
                                 (np.clip(cols + 0.1, 0, 1) * 255).astype(np.uint8),
                                 np.zeros((80, 1)))


def test_cli_train_end_to_end(tmp_path, capsys):
    """40 iterations: densification at 20 (a few points split), the
    binocular branch from 31."""
    scene, out = str(tmp_path / "scene"), str(tmp_path / "model")
    write_trainable_scene(scene)
    argv = ["train", "-s", scene, "-m", out, "--device", "cpu", "--iterations", "40",
            "--shift_cam_start", "30", "--densify_from_iter", "10",
            "--densification_interval", "20", "--densify_grad_threshold", "0.005",
            "--test_iterations", "1", "40", "--save_iterations", "40", "--seed", "1"]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    psnr = [float(line.split("PSNR")[1]) for line in text.splitlines()
            if "Evaluating train" in line]
    assert len(psnr) == 2 and psnr[1] > psnr[0] + 0.5, psnr  # train views improved
    with open(os.path.join(out, "train_log.json")) as f:
        log = json.load(f)
    assert [e["iteration"] for e in log] == [10, 20, 30, 40]
    assert log[2]["disparity_loss"] == 0.0 and log[3]["disparity_loss"] > 0  # binocular
    assert log[1]["points"] > log[0]["points"]  # densified at iteration 20
    with open(os.path.join(out, "cfg_args.json")) as f:
        cfg = json.load(f)
    assert cfg["opt"]["iterations"] == 40 and cfg["train"]["shift_cam_start"] == 30
    assert cfg["train"]["save_iterations"] == [40, 40]
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_40", "point_cloud.ply"))
    # the trained model serves through the port's render
    assert cli.main(["render", "-m", out, "--device", "cpu", "--skip_test"]) == 0
    assert len(os.listdir(os.path.join(out, "train", "ours_40", "renders"))) == 3


# -- trainer ----------------------------------------------------------------------------


def test_alpha_weights_match_jax():
    from binocular3dgs_tpu.config import Config as JCfg
    from binocular3dgs_tpu.train.loop import alpha_weight_for_view as jax_alpha_weight
    from binocular3dgs_torch.data.dataset import View
    from binocular3dgs_torch.train.loop import alpha_weight_for_view

    rng = np.random.default_rng(5)
    img = (rng.random((30, 40, 3)) * np.where(rng.random((30, 1, 1)) > 0.5, 1.0, 0.05)).astype(
        np.float32)
    alpha = rng.random((30, 40, 1)).astype(np.float32)
    _, pcam = camera_pair(w=40, h=30)
    for dataset, mask, source in (("LLFF", None, "x"), ("DTU", None, "scan110"),
                                  ("DTU", None, "scan8"), ("Blender", alpha, "x")):
        cfg, jcfg = Config(), JCfg()
        cfg.train.dataset_name = jcfg.train.dataset_name = dataset
        cfg.model.source_path = jcfg.model.source_path = source
        view = View(pcam, img, mask, "v", 0, 0)
        np.testing.assert_array_equal(alpha_weight_for_view(cfg, view),
                                      jax_alpha_weight(jcfg, view))


def test_trainer_grows_both_capacities():
    """Densifying everything with 5% headroom grows the gaussian capacity
    (every state buffer re-padded); a pair capacity of one pair per gaussian
    grows pairs_per_gaussian at the first step."""
    from binocular3dgs_torch.data.dataset import Scene, View
    from binocular3dgs_torch.data.readers import SceneInfo
    from binocular3dgs_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(30, 3)) * 0.4 + [0, 0, 4]
    views = []
    for i, tx in enumerate((-0.1, 0.0, 0.1)):
        cam = make_camera(np.eye(3), np.array([tx, 0.0, 0.0]), 0.9, 0.7, 40, 30, device="cpu")
        views.append(View(cam, rng.random((30, 40, 3)).astype(np.float32), None, f"v{i}", i, i))
    info = SceneInfo(PointCloud(points=pts, colors=rng.random((30, 3))), [], [],
                     {"radius": 1.0, "translate": np.zeros(3)}, None)
    cfg = Config()
    cfg.capacity.initial_margin = 1.05
    cfg.raster.pairs_per_gaussian = 1
    cfg.opt.densify_from_iter, cfg.opt.densification_interval = 5, 10
    cfg.opt.densify_grad_threshold = 1e-12
    cfg.train.binocular_consistency = False
    cfg.train.test_iterations = cfg.train.save_iterations = ()
    trainer = Trainer(cfg, Scene(views, [], 1.0, info), device="cpu")
    cap0 = trainer.state.model.capacity
    trainer.train(25)
    st = trainer.state
    assert st.model.capacity > cap0 and int(st.model.count()) <= st.model.capacity
    for tree in (st.model.params, st.adam_m, st.adam_v):
        assert all(getattr(tree, n).shape[0] == st.model.capacity for n in PARAM_NAMES)
    assert st.grad_accum.shape[0] == st.denom.shape[0] == st.max_radii2d.shape[0] == \
        st.model.capacity
    assert trainer.raster.pairs_per_gaussian > 1 and cfg.raster.pairs_per_gaussian == 1
    assert torch.isfinite(st.model.params.xyz).all()
