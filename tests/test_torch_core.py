"""Port core (cameras, the binocular camera shift, spherical harmonics,
quaternions, transforms, the xyz LR schedule) against binocular3dgs_tpu.core
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.core import sh as jsh
from binocular3dgs_tpu.core import transforms as jtf
from binocular3dgs_tpu.core.camera import make_camera as jax_make_camera
from binocular3dgs_tpu.core.camera import shift_camera as jax_shift_camera
from binocular3dgs_torch.core import sh, transforms
from binocular3dgs_torch.core.camera import make_camera, shift_camera

CAMERAS = [
    dict(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7, width=64, height=48),
    dict(
        R=np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]]),
        T=np.array([0.3, -0.1, 2.0]), fovx=1.1, fovy=0.8, width=1008, height=756,
    ),
    dict(
        R=np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]]),
        T=np.array([0.3, -0.1, 2.0]), fovx=1.1, fovy=0.8, width=50, height=38,
        trans=np.array([0.1, 0.2, -0.3]), scale=1.5, znear=0.05, zfar=50.0,
    ),
]


@pytest.mark.parametrize("i", range(len(CAMERAS)))
def test_make_camera_matches_jax(i):
    # both packages build the matrices with the same float32/float64 numpy
    # host code, so every entry is bit-identical
    jc = jax_make_camera(**CAMERAS[i])
    pc = make_camera(**CAMERAS[i], device="cpu")
    for name in ("world_view", "proj", "full_proj", "cam_center", "tanfovx", "tanfovy"):
        got = getattr(pc, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, name)), err_msg=name)
    assert (pc.width, pc.height, pc.znear, pc.zfar) == (jc.width, jc.height, jc.znear, jc.zfar)
    np.testing.assert_allclose(float(pc.focal_x), float(jc.focal_x), rtol=1e-7)
    np.testing.assert_allclose(float(pc.focal_y), float(jc.focal_y), rtol=1e-7)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(size=(200, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = sh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(dirs)[:, None, :])
    want = jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)[:, None, :])
    # float32 polynomial of degree <= 3 in unit components: a few ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sh_rgb_roundtrip():
    rgb = np.random.default_rng(0).random((10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sh.rgb_to_sh(torch.from_numpy(rgb)).numpy(), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(sh.sh_to_rgb(sh.rgb_to_sh(torch.from_numpy(rgb))).numpy(), rgb,
                               atol=1e-6)


def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(1).normal(size=(100, 4)).astype(np.float32)
    got = transforms.quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtf.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    # orthonormal
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)


def test_host_transforms_match_jax():
    R = CAMERAS[1]["R"]
    t = CAMERAS[1]["T"]
    for kw in ({}, dict(translate=np.array([0.1, 0.0, -0.2]), scale=2.0)):
        np.testing.assert_array_equal(transforms.world_to_view(R, t, **kw),
                                      jtf.world_to_view(R, t, **kw))
    np.testing.assert_array_equal(transforms.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                  jtf.projection_matrix(0.01, 100.0, 0.9, 0.7))
    assert transforms.fov2focal(0.9, 64) == jtf.fov2focal(0.9, 64)
    assert transforms.focal2fov(60.0, 64) == jtf.focal2fov(60.0, 64)
    x = np.array([0.1, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(transforms.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jtf.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)


def test_config_interchange(tmp_path):
    """A cfg_args.json written by the JAX package loads in the port (its
    backend choice and TPU knobs dropped); the port's own round-trips."""
    from binocular3dgs_tpu.config import Config as JaxConfig
    from binocular3dgs_tpu.config import save_config as jax_save_config
    from binocular3dgs_torch.config import RasterConfig, load_config, save_config

    jcfg = JaxConfig()
    jcfg.model.eval, jcfg.train.n_views = True, 5
    jcfg.raster.backend, jcfg.raster.pairs_per_gaussian = "pallas", 7
    jcfg.raster.chunk, jcfg.raster.pallas_chunk = 8, 256
    jax_save_config(jcfg, str(tmp_path / "jax.json"))
    cfg = load_config(str(tmp_path / "jax.json"))
    assert cfg.model.eval and cfg.train.n_views == 5
    assert cfg.raster == RasterConfig(pairs_per_gaussian=7)
    assert cfg.train.test_iterations == (30_000,)
    cfg.raster.tile_size = 8
    save_config(cfg, str(tmp_path / "port.json"))
    assert load_config(str(tmp_path / "port.json")) == cfg
    with pytest.raises(TypeError):
        RasterConfig(backend="torch")  # one blend path: chosen by the tensors' device


@pytest.mark.parametrize("i", range(len(CAMERAS)))
@pytest.mark.parametrize("trans", [0.0, 0.3, -0.17])
def test_shift_camera_matches_jax(i, trans):
    jc = jax_shift_camera(jax_make_camera(**CAMERAS[i]), np.float32(trans))
    pc = shift_camera(make_camera(**CAMERAS[i], device="cpu"), trans)
    # float32 3x3 and 4x4 products on the device: XLA's CPU dot and
    # PyTorch's matmul may round the last bit differently
    for name in ("world_view", "full_proj", "cam_center", "proj"):
        got = getattr(pc, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jc, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert (pc.width, pc.height) == (jc.width, jc.height)
    if trans == 0.0:
        base = make_camera(**CAMERAS[i], device="cpu")
        np.testing.assert_allclose(pc.world_view.numpy(), base.world_view.numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=500),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_schedule_matches_jax(kw):
    got = transforms.expon_lr_schedule(**kw)
    want = jtf.expon_lr_schedule(**kw)
    for step in (-1, 0, 1, 50, 100, 499, 500, 15_000, 30_000, 40_000):
        g, w = got(step), float(want(step))
        assert isinstance(g, float)
        # float64 on the host against float32 under JAX
        assert abs(g - w) <= 1e-6 * abs(w), (step, g, w)
