"""The port's render_tiled on the CPU against the JAX render_tiled with the
pallas backend in interpret mode, the port's dense oracle against the JAX
one and against the port's tiled render, and PLY interchange between the
packages."""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import RasterConfig as JaxRasterConfig
from binocular3dgs_tpu.models.gaussians import load_ply as jax_load_ply
from binocular3dgs_tpu.models.gaussians import save_ply as jax_save_ply
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_tpu.ops.rasterize_reference import render_dense as jax_render_dense
from binocular3dgs_torch.config import RasterConfig
from binocular3dgs_torch.models.gaussians import load_ply, save_ply
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.ops.rasterize_reference import render_dense

from test_rasterize_tiled import random_scene
from test_torch_project import camera_pair, sh1_scene, to_port
from test_torch_render import ALPHA, DEPTH, IMG, PORT, assert_render_close

JAX_PALLAS = JaxRasterConfig(backend="pallas", pallas_chunk=8, pairs_per_gaussian=16)


def test_render_matches_jax_pallas_interpret():
    # the overdraw/termination scene is held against the Pallas kernel at
    # the blend level in test_torch_blend.py
    m = random_scene(seed=0, n=24, spread=0.8)
    jcam, pcam = camera_pair(w=48, h=32)
    bg = [0.15, 0.3, 0.45]
    want = jax_render_tiled(jcam, m, jnp.asarray(bg), raster=JAX_PALLAS)
    got = render_tiled(pcam, to_port(m), bg, raster=RasterConfig(pairs_per_gaussian=16),
                       device="cpu")
    # the xla tolerances hold here too: the Pallas kernel's split-bf16
    # exponent and log-space transmittance scan stay within them (image
    # 1.9e-5, depth 1.1e-4 at max depth 6.3 on this scene)
    assert_render_close(got, want)


@pytest.mark.parametrize("seed", [0, 2])
def test_render_matches_dense_oracles(seed):
    m = random_scene(seed=seed, n=40)
    jcam, pcam = camera_pair()
    bg = [0.3, 0.1, 0.2]
    pm = to_port(m)
    dense = render_dense(pcam, pm, torch.tensor(bg))
    assert_render_close(dense, jax_render_dense(jcam, m, jnp.asarray(bg)))
    tiled = render_tiled(pcam, pm, bg, raster=PORT, device="cpu")
    np.testing.assert_allclose(tiled.image.numpy(), dense.image.numpy(), atol=IMG)
    np.testing.assert_allclose(tiled.depth.numpy(), dense.depth.numpy(), atol=DEPTH)
    np.testing.assert_allclose(tiled.alpha.numpy(), dense.alpha.numpy(), atol=ALPHA)


def test_ply_interchange(tmp_path):
    """A PLY written by the JAX package loads into the port with the JAX
    loader's buffers and renders the same image (bit for bit: the same
    buffers through the same port code as the model the xla tests hold
    against the JAX render); the port's save_ply writes the same bytes."""
    m = sh1_scene(4, n=40)
    jax_ply, port_ply = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_save_ply(m, jax_ply)
    pm = load_ply(jax_ply, max_sh_degree=1, device="cpu")
    jm = to_port(jax_load_ply(jax_ply, max_sh_degree=1))
    assert pm.capacity == jm.capacity == 128 and pm.active_sh_degree == jm.active_sh_degree == 1
    for name in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        assert torch.equal(getattr(pm.params, name), getattr(jm.params, name)), name
    assert torch.equal(pm.active, jm.active)
    _, pcam = camera_pair()
    got = render_tiled(pcam, pm, [0.0, 0.0, 0.0], raster=PORT, device="cpu")
    want = render_tiled(pcam, jm, [0.0, 0.0, 0.0], raster=PORT, device="cpu")
    assert torch.equal(got.image, want.image) and got.image.abs().max() > 0
    save_ply(pm, port_ply)
    assert filecmp.cmp(port_ply, jax_ply, shallow=False)
    jax_save_ply(m.replace(active=m.active.at[:5].set(False)), jax_ply)  # inactive rows skipped
    save_ply(to_port(m.replace(active=m.active.at[:5].set(False))), port_ply)
    assert filecmp.cmp(port_ply, jax_ply, shallow=False)
