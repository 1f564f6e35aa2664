"""The port's image metrics (l1_loss, ssim, psnr) against the JAX package's
on the same numpy-seeded images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops import losses as jax_losses
from binocular3dgs_torch.ops import losses

# float32 sums over a few thousand pixels in another order (and, for SSIM,
# a convolution against the JAX package's banded matmuls)
TOL = 1e-5


def images(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape).astype(np.float32), 0, 1)
    mask = (rng.random((1,) + shape[-2:]) > 0.3).astype(np.float32)
    return a, b, mask


@pytest.mark.parametrize("shape", [(3, 40, 52), (2, 3, 33, 24)])
def test_ssim_matches_jax(shape):
    a, b, _ = images(0, shape)
    want = jax_losses.ssim(jnp.asarray(a), jnp.asarray(b))
    got = losses.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert abs(float(got) - float(want)) <= TOL
    if len(shape) == 4:
        per = losses.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False)
        want_per = jax_losses.ssim(jnp.asarray(a), jnp.asarray(b), size_average=False)
        np.testing.assert_allclose(per.numpy(), np.asarray(want_per), atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_and_l1_match_jax(masked):
    a, b, mask = images(1, (3, 40, 52))
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    want = jax_losses.psnr(jnp.asarray(a), jnp.asarray(b), mask=m_j)
    got = losses.psnr(torch.from_numpy(a), torch.from_numpy(b), mask=m_t)
    assert abs(float(got) - float(want)) <= 1e-4  # dB: 20*log10 of a float32 mean
    want_l1 = jax_losses.l1_loss(jnp.asarray(a), jnp.asarray(b), mask=m_j)
    got_l1 = losses.l1_loss(torch.from_numpy(a), torch.from_numpy(b), mask=m_t)
    assert abs(float(got_l1) - float(want_l1)) <= TOL
