"""The port's render_tiled on the CPU against the JAX render_tiled with the
xla backend (the pallas-interpret backend, the dense oracles and PLY
interchange are in test_torch_render_oracles.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import RasterConfig as JaxRasterConfig
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_torch.config import RasterConfig
from binocular3dgs_torch.ops.rasterize import render_tiled

from test_rasterize_tiled import random_scene
from test_render_dense import make_model
from test_torch_project import camera_pair, sh1_scene, to_port

# the tolerances of test_rasterize_tiled (tiled vs dense oracle): float32
# compositing in another order; depth is alpha-weighted view z (up to ~12)
IMG, DEPTH, ALPHA = 2e-5, 2e-4, 2e-5

JAX_XLA = JaxRasterConfig(backend="xla", max_pairs_per_tile=256, chunk=8)
PORT = RasterConfig()


def termination_scene():
    """The opaque-termination scene of test_rasterize_tiled, at the 48-row
    capacity of the other cases (one JAX compile serves them all)."""
    n = 48
    rng = np.random.default_rng(6)
    xyz = np.stack(
        [rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n), np.linspace(2, 12, n)], axis=1
    )
    return make_model(xyz, rng.random((n, 3)), np.full(n, 0.97), np.full((n, 3), 1.0))


def assert_render_close(got, want):
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), atol=IMG)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=DEPTH)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=ALPHA)


XLA_CASES = {
    # name: (model factory, width, height, background)
    "seed0": (lambda: random_scene(seed=0, n=48), 64, 48, [0.1, 0.2, 0.3]),
    "seed1": (lambda: random_scene(seed=1, n=48), 64, 48, [0.1, 0.2, 0.3]),
    "sh1": (lambda: sh1_scene(3, n=48), 64, 48, [0.0, 0.0, 0.0]),
    "inactive": (lambda: random_scene(seed=5, n=24, cap=48), 64, 48, [1.0, 1.0, 1.0]),
    "termination": (termination_scene, 64, 48, [0.0, 0.0, 0.0]),
    "odd_size": (lambda: random_scene(seed=8, n=24), 50, 38, [0.0, 0.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_render_matches_jax_xla(case):
    factory, w, h, bg = XLA_CASES[case]
    m = factory()
    jcam, pcam = camera_pair(w=w, h=h)
    want = jax_render_tiled(jcam, m, jnp.asarray(bg), raster=JAX_XLA)
    got = render_tiled(pcam, to_port(m), bg, raster=PORT, device="cpu")
    assert got.image.shape == (3, h, w)
    assert_render_close(got, want)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert int(got.num_pairs) == int(want.num_pairs)
    assert got.pair_capacity == int(want.pair_capacity)
    if case == "termination":  # opaque pixels: the T < 1e-4 cut really ran
        assert float(got.alpha.max()) > 0.999


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = random_scene(seed=1, n=8)
    _, pcam = camera_pair()
    with pytest.raises(RuntimeError, match="cuda"):
        render_tiled(pcam, to_port(m), [0.0, 0.0, 0.0], device="cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
