"""The port's dense-init geometry and correlation against the JAX package's
on seeded numpy inputs: the float64 numpy functions within 1e-9 relative,
the torch counterparts of the jitted ones (float32) within 1e-5, the
correlations within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init import correlation as jax_corr
from binocular3dgs_tpu.init import geometry as jax_geo
from binocular3dgs_torch.init import correlation, geometry

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)


def cameras():
    K = np.array([[100.0, 0, 32.0], [0, 100.0, 24.0], [0, 0, 1]])
    c2w1 = np.eye(4)
    c2w1[:3, 3] = [0.5, 0.1, 0.0]
    return K, np.eye(4), c2w1


def world_points(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(4, 8, n)], 1)


def test_dlt_and_projections():
    K, c2w0, c2w1 = cameras()
    rng = np.random.default_rng(1)
    pts = world_points()
    K34 = np.concatenate([K, np.zeros((3, 1))], 1)
    P0, P1 = K34 @ np.linalg.inv(c2w0), K34 @ np.linalg.inv(c2w1)
    uv0 = geometry.project_points(pts, K, np.linalg.inv(c2w0))[0] + rng.normal(size=(60, 2))
    uv1 = geometry.project_points(pts, K, np.linalg.inv(c2w1))[0] + rng.normal(size=(60, 2))
    np.testing.assert_allclose(geometry.triangulate_points_dlt(P0, P1, uv0, uv1),
                               jax_geo.triangulate_points_dlt(P0, P1, uv0, uv1), **F64)
    for a, b in zip(geometry.project_points(pts, K, np.linalg.inv(c2w1)),
                    jax_geo.project_points(pts, K, np.linalg.inv(c2w1))):
        np.testing.assert_allclose(a, b, **F64)
    depth = rng.uniform(2, 9, (12, 16))
    np.testing.assert_allclose(geometry.backproject_depth(depth, K, c2w1),
                               jax_geo.backproject_depth(depth, K, c2w1), **F64)


def test_sampling_and_ssim_float64():
    rng = np.random.default_rng(2)
    img = rng.random((20, 30, 3))
    grid = rng.random((40, 2)) * 2.4 - 1.2  # out of bounds included
    np.testing.assert_allclose(geometry.grid_sample_bilinear(img, grid),
                               jax_geo.grid_sample_bilinear(img, grid), **F64)
    uv = rng.uniform(-2, 31, (25, 2))
    np.testing.assert_allclose(geometry.sample_colors_at(img, uv),
                               jax_geo.sample_colors_at(img, uv), **F64)
    a, b = rng.random((6, 121, 3)), rng.random((6, 121, 3))
    np.testing.assert_allclose(geometry.patch_ssim(a, b, 5), jax_geo.patch_ssim(a, b, 5), **F64)
    np.testing.assert_array_equal(geometry._blur_matrix(11), jax_geo._blur_matrix(11))
    # the torch versions in float64 (the growth's colours) against the numpy ones
    t = torch.from_numpy
    np.testing.assert_allclose(geometry.sample_colors_at_torch(t(img), t(uv)).numpy(),
                               jax_geo.sample_colors_at(img, uv), **F64)


def test_torch_scorer_parts_match_jax():
    """grid_sample / sample_patches / patch_ssim in float32 torch against the
    jitted JAX versions."""
    rng = np.random.default_rng(3)
    img = rng.random((48, 64, 3)).astype(np.float32)
    uv = rng.uniform(-8, 70, (200, 2)).astype(np.float32)
    grid = (rng.random((50, 2)) * 2.4 - 1.2).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(geometry.grid_sample_bilinear_torch(t(img), t(grid)).numpy(),
                               np.asarray(jax_geo.grid_sample_bilinear_jax(img, grid)), **F32)
    pt = geometry.sample_patches_torch(t(img), t(uv), 5)
    pj = jax_geo.sample_patches_jax(jnp.asarray(img), jnp.asarray(uv), 5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **F32)
    other = geometry.sample_patches_torch(t(img[::-1].copy()), t(uv), 5)
    np.testing.assert_allclose(
        geometry.patch_ssim_torch(other, pt, 5).numpy(),
        np.asarray(jax_geo.patch_ssim_jax(jnp.asarray(other.numpy()), pj, 5)), **F32)


@pytest.mark.parametrize("md", [2, 4])
def test_local_correlation_and_transpose(md):
    rng = np.random.default_rng(5 + md)
    ref, qry = (rng.random((2, 10, 12, 4)).astype(np.float32) for _ in range(2))
    v = rng.random((2, 10, 12, (2 * md + 1) ** 2)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        correlation.local_correlation(t(ref), t(qry), md).numpy(),
        np.asarray(jax_corr.local_correlation(jnp.asarray(ref), jnp.asarray(qry), md)), **F32)
    np.testing.assert_allclose(
        correlation.local_correlation_transpose(t(v), t(qry), md).numpy(),
        np.asarray(jax_corr.local_correlation_transpose(jnp.asarray(v), jnp.asarray(qry), md)),
        **F32)


def test_global_correlation():
    rng = np.random.default_rng(6)
    ref, qry = (rng.random((2, 4, 5, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        correlation.global_correlation(torch.from_numpy(ref), torch.from_numpy(qry)).numpy(),
        np.asarray(jax_corr.global_correlation(jnp.asarray(ref), jnp.asarray(qry))), **F32)
