"""The port's warp (binocular3dgs_torch.ops.warp) against the JAX package on
the same numpy inputs: values, d_image and d_disparity of
`inverse_warp_image` against the JAX `_warp_xla` (autodiff) and the Pallas
path in interpret mode, and the plain W1/W2 versions against
`warp_forward_pallas` / `warp_backward_pallas(interpret=True)`. The CUDA
kernels themselves are held against the plain versions in
test_torch_cuda.py (on a card) and in chip_smoke.py."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops.warp import inverse_warp_image as jax_warp
from binocular3dgs_tpu.ops.warp import warp_mask as jax_warp_mask
from binocular3dgs_tpu.ops.warp_pallas import warp_backward_pallas, warp_forward_pallas
from binocular3dgs_torch import tracing
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
    # Pallas shift-accumulate adds zero-weighted taps, exact too. d_image is
    # the port's fixed-point sum, the exact sum rounded once, against float32
    # sums in another order (1e-6); d_disp is the same per-channel sum of
    # diff * d_out (1e-6).
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
    # the exact sum of a few weighted taps per column rounded once, against
    # float32 sums in the Pallas kernel's order
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


def exact_backward(disp, ct):
    """(sums, counts): d_image as exact rationals, each valid pixel's float32
    terms w * d_out (the products the port forms) added without rounding,
    and the number of terms on each column."""
    Cc, Hh, Ww = ct.shape
    c0, c1, w0, w1, valid = (t.numpy() for t in warp._taps(torch.from_numpy(disp), Ww))
    terms = ((w0 * ct).astype(np.float32), (w1 * ct).astype(np.float32))
    out = [[[Fraction(0)] * Ww for _ in range(Hh)] for _ in range(Cc)]
    count = np.zeros(ct.shape, np.int64)
    for c, r, x in zip(*np.nonzero(np.broadcast_to(valid, ct.shape))):
        for tap, col in ((0, c0[r, x]), (1, c1[r, x])):
            out[c][r][col] += Fraction(float(terms[tap][c, r, x]))
            count[c, r, col] += 1
    return out, count


def stress_rows(kind, rng, h=4, w=24):
    """(disparity, d_out) of rows built to stress the fixed-point scale."""
    disp = ((rng.random((h, w)) - 0.5) * 6).astype(np.float32)
    ct = rng.normal(size=(2, h, w))
    if kind == "zero_row":
        ct[:, 1] = 0.0
    elif kind == "huge_among_tiny":  # 2^30 above the rest of its row
        ct[:, 2] *= 1e-3
        ct[0, 2, 5] = 2.0 ** 30 * 1e-3
    elif kind == "huge_1e20":  # 66 binades above the rest of its row
        ct[0, 3, 0] = 1e20
    elif kind == "subnormal":  # the scale 2^-s falls into float32 subnormals
        ct *= 1e-42
    elif kind == "s_above_127":  # M ~ 1e-36: s = 62 - e - 5 > 127
        ct *= 1e-36
    elif kind == "width_not_multiple_of_4":
        disp, ct = disp[:, :23], ct[:, :, :23]
    return np.ascontiguousarray(disp), np.ascontiguousarray(ct).astype(np.float32)


@pytest.mark.parametrize("kind", ["zero_row", "huge_among_tiny", "huge_1e20", "subnormal",
                                  "s_above_127", "width_not_multiple_of_4"])
def test_backward_is_the_exact_sum_rounded(kind):
    """Each column within one float32 rounding of its exact sum plus the
    fixed-point grid's rounding: half a step 2^-s per term, s = 62 - e -
    ceil(log2 W) with e from frexp of the row's max |d_out| over valid
    pixels. The grid follows the row's max, so a column far below it (the
    1e20 row) is exact only to that absolute step, not to float32's
    relative one; elsewhere the grid term is far below an ulp."""
    disp, ct = stress_rows(kind, np.random.default_rng(7))
    got = warp_backward_torch(torch.from_numpy(disp), torch.from_numpy(ct)).numpy()
    want, count = exact_backward(disp, ct)
    Ww = ct.shape[2]
    valid = warp._taps(torch.from_numpy(disp), Ww)[4].numpy()
    row_max = np.where(valid, np.abs(ct), 0).max(axis=(0, 2))
    step = [2.0 ** -(62 - np.frexp(m)[1] - int(np.ceil(np.log2(Ww)))) for m in row_max]
    if kind == "zero_row":
        assert (got[:, 1].view(np.int32) == 0).all()  # +0.0
    if kind == "subnormal":
        assert (np.abs(got[got != 0]) < np.finfo(np.float32).tiny).any()
    for c, r, x in np.ndindex(got.shape):
        e = want[c][r][x]
        tol = Fraction(float(np.spacing(np.float32(abs(float(e)))))) \
            + Fraction(step[r]) * int(count[c, r, x]) / 2
        assert abs(Fraction(float(got[c, r, x])) - e) <= tol, (c, r, x)


def test_backward_non_finite_rule():
    """A non-finite d_out at a valid pixel makes the columns it reaches what
    a float sum would (+inf, -inf, NaN; 0 * inf is NaN); at an invalid pixel
    it is ignored; the row's other columns keep their finite sums."""
    Hh, Ww = 5, 16
    disp = np.zeros((Hh, Ww), np.float32)
    disp[:, 1] = 0.5  # pixel 1 taps columns 1 (w0) and 2 (w1), both 0.5
    disp[:, 2] = 0.5
    disp[:, 6] = 1.0  # pixel 6: w0 = 1 on column 7, w1 = 0 on column 8
    disp[:, 15] = 3.0  # invalid
    ct = np.random.default_rng(9).normal(size=(1, Hh, Ww)).astype(np.float32)
    ct[0, 0, 1] = np.inf
    ct[0, 1, 1] = -np.inf
    ct[0, 2, 1], ct[0, 2, 2] = np.inf, -np.inf  # +inf and -inf meet on column 2
    ct[0, 3, 1] = np.nan
    ct[0, 4, 6] = np.inf  # w1 = 0 on column 8: 0 * inf
    ct[0, :, 15] = np.inf  # invalid pixel
    got = warp_backward_torch(torch.from_numpy(disp), torch.from_numpy(ct)).numpy()
    # the float64 scatter of the same float32 terms: what a float sum gives
    c0, c1, w0, w1, valid = (t.numpy() for t in warp._taps(torch.from_numpy(disp), Ww))
    want = np.zeros((1, Hh, Ww))
    with np.errstate(invalid="ignore"):
        for r, x in zip(*np.nonzero(valid)):
            want[0, r, c0[r, x]] += np.float32(w0[r, x] * ct[0, r, x])
            want[0, r, c1[r, x]] += np.float32(w1[r, x] * ct[0, r, x])
    assert np.isnan(got[0, 2, 2]) and np.isnan(got[0, 3, 1]) and np.isnan(got[0, 4, 8])
    assert got[0, 0, 1] == np.inf and got[0, 1, 1] == -np.inf and got[0, 4, 7] == np.inf
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)
    assert np.isfinite(got[0, :, 14]).all()  # the invalid pixel's inf reaches nothing


def test_backward_cpu_calls_are_bit_identical():
    img, disp, ct = case("fractional", seed=5)
    d, g = torch.from_numpy(disp), torch.from_numpy(ct)
    a, b = warp_backward_torch(d, g), warp_backward_torch(d, g)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_wrappers_cpu_are_plain_versions():
    img, disp, ct = case("fractional", seed=4)
    i, d, g = (torch.from_numpy(x) for x in (img, disp, ct))
    before = tracing.launches()
    out, diff = warp_forward(i, d)
    want_out, want_diff = warp_forward_torch(i, d)
    assert torch.equal(out, want_out) and torch.equal(diff, want_diff)
    assert torch.equal(warp_backward(d, g), warp_backward_torch(d, g))
    assert tracing.launches() == before
    with pytest.raises(ValueError):
        warp_forward(i.double(), d)
    with pytest.raises(ValueError):
        warp_forward(i, d[:, :-1])
    with pytest.raises(ValueError):
        warp_backward(d[:-1], g)
