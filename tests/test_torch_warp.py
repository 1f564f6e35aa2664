"""The port's warp (binocular3dgs_torch.ops.warp) against the JAX package on
the same numpy inputs: values, d_image and d_disparity of
`inverse_warp_image` against the JAX `_warp_xla` (autodiff) and the Pallas
path in interpret mode, and the plain W1/W2 versions against
`warp_forward_pallas` / `warp_backward_pallas(interpret=True)`. The CUDA
kernels themselves are held against the plain versions in
test_torch_cuda.py (on a card) and in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops.warp import inverse_warp_image as jax_warp
from binocular3dgs_tpu.ops.warp import warp_mask as jax_warp_mask
from binocular3dgs_tpu.ops.warp_pallas import warp_backward_pallas, warp_forward_pallas
from binocular3dgs_torch.ops import warp
from binocular3dgs_torch.ops.warp import (
    inverse_warp_image,
    warp_backward,
    warp_backward_torch,
    warp_forward,
    warp_forward_torch,
    warp_mask,
)

C, H, W = 3, 10, 24


def disparities(kind, rng):
    base = rng.random((H, W)).astype(np.float32)
    return {
        "zero": np.zeros((H, W), np.float32),
        "integer": np.round((base - 0.5) * 10).astype(np.float32),
        "fractional": ((base - 0.5) * 8).astype(np.float32),
        "large": ((base - 0.5) * 60).astype(np.float32),  # most taps out of range
        "out_of_range": np.where(base > 0.5, 40.0, -40.0).astype(np.float32),
    }[kind]


KINDS = ["zero", "integer", "fractional", "large", "out_of_range"]


def case(kind, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((C, H, W)).astype(np.float32)
    ct = rng.normal(size=(C, H, W)).astype(np.float32)
    return img, disparities(kind, rng), ct


def port_vjp(img, disp, ct):
    i = torch.from_numpy(img).requires_grad_()
    d = torch.from_numpy(disp).requires_grad_()
    out = inverse_warp_image(i, d)
    d_img, d_disp = torch.autograd.grad(out, [i, d], torch.from_numpy(ct))
    return out.detach().numpy(), d_img.numpy(), d_disp.numpy()


def jax_vjp(img, disp, ct, backend):
    out, vjp = jax.vjp(lambda i, d: jax_warp(i, d, backend=backend),
                       jnp.asarray(img), jnp.asarray(disp))
    d_img, d_disp = vjp(jnp.asarray(ct))
    return np.asarray(out), np.asarray(d_img), np.asarray(d_disp)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_warp_matches_jax(kind, backend):
    img, disp, ct = case(kind)
    got = port_vjp(img, disp, ct)
    want = jax_vjp(img, disp, ct, backend)
    # values: the same two float32 products against the xla gather; the
    # Pallas shift-accumulate adds zero-weighted taps, exact too. d_image
    # sums a few weighted taps per column in another order (1e-6); d_disp is
    # the same per-channel sum of diff * d_out (1e-6).
    for name, g, w in zip(("out", "d_image", "d_disp"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)
    if kind == "out_of_range":
        assert (got[0] == 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_kernels_match_pallas(kind):
    img, disp, ct = case(kind, seed=1)
    out, diff = warp_forward_torch(torch.from_numpy(img), torch.from_numpy(disp))
    out_p, diff_p = warp_forward_pallas(jnp.asarray(img), jnp.asarray(disp), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_p), atol=1e-6)
    # diff is defined on valid pixels only: the Pallas kernel leaves partial
    # sums on invalid ones (its d_disp is masked by validity afterwards),
    # the port writes 0 there
    valid = np.asarray(jax_warp_mask(jnp.asarray(disp), H, W)).astype(bool)
    np.testing.assert_allclose(diff.numpy()[:, valid], np.asarray(diff_p)[:, valid], atol=1e-6)
    assert (diff.numpy()[:, ~valid] == 0).all()
    d_img = warp_backward_torch(torch.from_numpy(disp), torch.from_numpy(ct))
    d_img_p = warp_backward_pallas(jnp.asarray(disp), jnp.asarray(ct), interpret=True)
    # a few weighted taps per column summed in another order
    np.testing.assert_allclose(d_img.numpy(), np.asarray(d_img_p), atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_mask_matches_jax(kind):
    _, disp, _ = case(kind, seed=2)
    got = warp_mask(torch.from_numpy(disp), H, W)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_warp_mask(jnp.asarray(disp), H, W)))


def test_backward_is_the_transpose():
    """<warp(x), y> == <x, warp^T(y)> for the plain W1/W2 pair."""
    img, disp, ct = case("fractional", seed=3)
    out, _ = warp_forward_torch(torch.from_numpy(img), torch.from_numpy(disp))
    d_img = warp_backward_torch(torch.from_numpy(disp), torch.from_numpy(ct))
    lhs = float((out.double() * torch.from_numpy(ct).double()).sum())
    rhs = float((torch.from_numpy(img).double() * d_img.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))  # float32 products, float64 sums


def test_wrappers_cpu_are_plain_versions():
    img, disp, ct = case("fractional", seed=4)
    i, d, g = (torch.from_numpy(x) for x in (img, disp, ct))
    before = (warp.warp_forward_launches, warp.warp_backward_launches)
    out, diff = warp_forward(i, d)
    want_out, want_diff = warp_forward_torch(i, d)
    assert torch.equal(out, want_out) and torch.equal(diff, want_diff)
    assert torch.equal(warp_backward(d, g), warp_backward_torch(d, g))
    assert (warp.warp_forward_launches, warp.warp_backward_launches) == before
    with pytest.raises(ValueError):
        warp_forward(i.double(), d)
    with pytest.raises(ValueError):
        warp_forward(i, d[:, :-1])
    with pytest.raises(ValueError):
        warp_backward(d[:-1], g)
