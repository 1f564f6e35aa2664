"""The port's image metrics and losses (l1_loss, ssim, psnr, smooth_loss)
against the JAX package's on the same numpy-seeded images."""

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


@pytest.mark.parametrize("shape", [(3, 40, 52), (3, 7, 5)])
def test_smooth_loss_matches_jax(shape):
    a, _, mask = images(2, shape)
    disp = np.random.default_rng(3).normal(size=shape[1:]).astype(np.float32) * 5
    for d_np in (disp * mask[0], disp):  # masked as in the train step, and dense
        want = jax_losses.smooth_loss(jnp.asarray(d_np), jnp.asarray(a))
        got = losses.smooth_loss(torch.from_numpy(d_np), torch.from_numpy(a))
        assert abs(float(got) - float(want)) <= TOL * max(1.0, abs(float(want)))
    # gradients away from |x|'s kink at 0 (the masked zeros), where JAX and
    # PyTorch pick different subgradients
    import jax

    g_want = jax.grad(lambda x: jax_losses.smooth_loss(x, jnp.asarray(a)))(jnp.asarray(disp))
    d = torch.from_numpy(disp).requires_grad_()
    (g_got,) = torch.autograd.grad(losses.smooth_loss(d, torch.from_numpy(a)), [d])
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), atol=1e-7)


@pytest.mark.parametrize("shape", [(1, 3, 37, 29), (2, 3, 16, 48), (3, 21, 12)])
@pytest.mark.parametrize("size_average", [True, False], ids=["mean", "per_image"])
def test_ssim_analytic_gradient_matches_autograd(shape, size_average):
    """The kernels' formulas (ssim_maps_torch, ssim_backward_torch) against
    autograd of the plain composition, at odd sizes where every pixel is
    within the window's reach of a border (zero padding)."""
    a, b, _ = images(4, shape)
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b)
    value = losses.ssim(x, y, size_average=size_average)
    up = torch.from_numpy(np.random.default_rng(5).normal(size=value.shape).astype(np.float32))
    (want,) = torch.autograd.grad(value, [x], grad_outputs=up)
    got_value, maps = losses.ssim_maps_torch(x.detach(), y, size_average=size_average)
    assert torch.equal(got_value, value.detach())  # the same operations in the same order
    assert all(m.shape == x.shape for m in maps)
    got = losses.ssim_backward_torch(x.detach(), y, maps, up, size_average=size_average)
    # float32 sums of the same terms in another grouping, where the three
    # blurred terms nearly cancel: ~3e-6 of the largest entry; a wrong
    # factor, a term left out or the maps unblurred read 0.4-4
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_ssim_on_the_cpu_launches_no_kernel():
    from binocular3dgs_torch import tracing

    a, b, _ = images(6, (3, 20, 24))
    before = tracing.launches()
    x = torch.from_numpy(a).requires_grad_()
    torch.autograd.grad(losses.ssim(x, torch.from_numpy(b)), [x])
    assert tracing.launches() == before
