"""Port vertex stage (binocular3dgs_torch.ops.project) against the JAX
project_gaussians, field by field, on the random_scene shapes of
test_rasterize_tiled. Also holds the helpers that carry a JAX model and
camera into the port, used by the other test_torch_* files."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.core.camera import make_camera as jax_make_camera
from binocular3dgs_tpu.ops.rasterize import project_for_render as jax_project_for_render
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.models.gaussians import PARAM_NAMES, from_numpy
from binocular3dgs_torch.ops.rasterize import project_for_render

from test_rasterize_tiled import random_scene

W, H = 64, 48
FOVX, FOVY = 0.9, 0.7


def to_port(m, device="cpu"):
    """The JAX GaussianModel `m` as the port's model (same buffers)."""
    params = {n: np.asarray(getattr(m.params, n)) for n in PARAM_NAMES}
    return from_numpy(
        params, np.asarray(m.active), m.max_sh_degree, m.active_sh_degree,
        m.spatial_lr_scale, device=device,
    )


def camera_pair(R=None, T=None, fovx=FOVX, fovy=FOVY, w=W, h=H):
    """The same camera built by both packages."""
    R = np.eye(3) if R is None else R
    T = np.zeros(3) if T is None else T
    return (
        jax_make_camera(R, T, fovx, fovy, w, h),
        make_camera(R, T, fovx, fovy, w, h, device="cpu"),
    )


def sh1_scene(seed, n=32):
    m = random_scene(seed=seed, n=n)
    rest = np.random.default_rng(seed + 100).normal(size=(n, 3, 3)) * 0.1
    return m.replace(active_sh_degree=1, params=m.params.replace(f_rest=jnp.asarray(rest)))


def behind_scene():
    """Some gaussians behind the camera or inside the z <= 0.2 cull."""
    m = random_scene(seed=9, n=40)
    xyz = np.asarray(m.params.xyz).copy()
    xyz[:8] = 0.0
    xyz[:8, 2] = np.linspace(-2.0, 0.0, 8)
    return m.replace(params=m.params.replace(xyz=jnp.asarray(xyz)))


SCENES = {
    "seed0": lambda: random_scene(seed=0),
    "seed1": lambda: random_scene(seed=1),
    "sh1": lambda: sh1_scene(3),
    "inactive": lambda: random_scene(seed=5, n=16, cap=32),
    "culled": behind_scene,
}

# float32 elementwise algebra in the same order in both packages; the
# tolerances cover the last bits of XLA's fused CPU code against PyTorch's
# (4-term camera matmuls, exp/log/sqrt implementations)
TOL = {
    "mean2d": dict(rtol=1e-5, atol=1e-4),  # pixels
    "depth": dict(rtol=1e-6, atol=1e-6),
    "conic": dict(rtol=1e-4, atol=1e-6),
    "color": dict(rtol=1e-6, atol=1e-6),
    "opacity": dict(rtol=1e-6, atol=1e-7),
    "radius": dict(rtol=0, atol=0),
    "bin_extent": dict(rtol=1e-5, atol=1e-4),  # pixels
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_project_matches_jax(scene):
    m = SCENES[scene]()
    R = np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]])
    jcam, pcam = camera_pair(R=R, T=np.array([0.05, -0.02, 0.1]))
    pj = jax_project_for_render(jcam, m)
    pt = project_for_render(pcam, to_port(m))
    np.testing.assert_array_equal(pt.visible.numpy(), np.asarray(pj.visible))
    for name, tol in TOL.items():
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), err_msg=name, **tol
        )
    assert pt.visible.any()
    if scene == "culled":
        assert not pt.visible[:8].any()


def test_from_numpy_keeps_buffers():
    m = random_scene(seed=5, n=16, cap=32)
    pm = to_port(m)
    assert pm.capacity == 32 and int(pm.count()) == 16
    for n in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(pm.params, n).numpy(), np.asarray(getattr(m.params, n)))
    np.testing.assert_allclose(
        pm.get_opacity().numpy(), np.asarray(m.get_opacity()), rtol=1e-6
    )
    assert pm.params.xyz.dtype == torch.float32 and pm.active.dtype == torch.bool
