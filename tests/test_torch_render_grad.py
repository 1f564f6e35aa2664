"""Gradients of the port's render_tiled on the CPU (the plain blend backward
inside the blend's autograd, plain autograd of the record gather, depth
reorder and vertex stage) against jax.grad through the JAX render_tiled
with the xla backend, parameters and the mean2d carrier; and against the
port's own dense oracle. The JAX suite marks its Pallas gradient test slow
(tests/test_blend_pallas.py), so the plain reference is the comparison here.
The record-level plain backward is held against the CUDA kernel B2 in
test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import RasterConfig as JaxRasterConfig
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_torch import tracing
from binocular3dgs_torch.models.gaussians import PARAM_NAMES, GaussianParams
from binocular3dgs_torch.ops import blend_cuda
from binocular3dgs_torch.ops.blend_cuda import blend_backward, blend_backward_torch
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.ops.rasterize_reference import render_dense

from test_rasterize_tiled import random_scene
from test_torch_blend import jax_records, overdraw_scene
from test_torch_project import camera_pair, to_port

JAX_XLA = JaxRasterConfig(backend="xla", max_pairs_per_tile=256, chunk=8)
BG = [0.3, 0.1, 0.2]

SCENES = {
    # name: (model factory, width, height)
    "normal": (lambda: random_scene(seed=0, n=40), 64, 48),
    "overdraw": (overdraw_scene, 64, 48),  # pixels end at T < 1e-4
    "odd_size": (lambda: random_scene(seed=8, n=24), 50, 38),
    "inactive": (lambda: random_scene(seed=5, n=24, cap=40), 64, 48),
}


def loss_terms(image, depth, alpha, tgt):
    """The loss of test_rasterize_tiled's gradient test (JAX or torch arrays)."""
    return ((image - tgt) ** 2).mean() + 0.05 * depth.mean() + 0.1 * (alpha ** 2).mean()


def target(h, w):
    return np.random.default_rng(100 + w).random((3, h, w)).astype(np.float32)


def jax_grads(m, w, h):
    jcam, _ = camera_pair(w=w, h=h)
    tgt = jnp.asarray(target(h, w))

    def loss(params, carrier):
        out = jax_render_tiled(jcam, m.replace(params=params), jnp.asarray(BG),
                               mean2d_carrier=carrier, raster=JAX_XLA)
        return loss_terms(out.image, out.depth, out.alpha, tgt)

    g, c = jax.grad(loss, argnums=(0, 1))(m.params, jnp.zeros((m.capacity, 2)))
    return {n: np.asarray(getattr(g, n)) for n in PARAM_NAMES} | {"carrier": np.asarray(c)}


def port_grads(pm, w, h, render):
    _, pcam = camera_pair(w=w, h=h)
    tgt = torch.from_numpy(target(h, w))
    leaves = {n: getattr(pm.params, n).clone().requires_grad_() for n in PARAM_NAMES}
    carrier = torch.zeros(pm.capacity, 2, requires_grad=True)
    out = render(pcam, dataclasses.replace(pm, params=GaussianParams(**leaves)), carrier)
    grads = torch.autograd.grad(loss_terms(out.image, out.depth, out.alpha, tgt),
                                [*leaves.values(), carrier])
    return dict(zip([*PARAM_NAMES, "carrier"], (g.numpy() for g in grads)))


def tiled(pcam, model, carrier):
    return render_tiled(pcam, model, BG, device="cpu", mean2d_carrier=carrier)


def dense(pcam, model, carrier):
    return render_dense(pcam, model, torch.tensor(BG), mean2d_carrier=carrier)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_grads_match_jax_xla(scene):
    factory, w, h = SCENES[scene]
    m = factory()
    want = jax_grads(m, w, h)
    got = port_grads(to_port(m), w, h, tiled)
    # Both rebuild T by division from T_final in float32 and sum the pair
    # cotangents per gaussian, in other orders (chunked cumulative products
    # and a scatter-add here, a chunked scan and a segment sum there);
    # 1e-4 of each field's largest gradient covers that drift.
    for name, g in got.items():
        scale = np.abs(want[name]).max() + 1e-8
        np.testing.assert_allclose(g, want[name], atol=1e-4 * scale, err_msg=name)
    assert np.abs(got["carrier"]).max() > 0 and np.abs(got["xyz"]).max() > 0
    if scene == "inactive":  # padded rows receive nothing
        for name, g in got.items():
            assert not g[24:].any(), name


@pytest.mark.parametrize("scene", ["normal", "overdraw"])
def test_tiled_grads_match_dense_oracle(scene):
    factory, w, h = SCENES[scene]
    pm = to_port(factory())
    got = port_grads(pm, w, h, tiled)
    want = port_grads(pm, w, h, dense)
    # test_rasterize_tiled's tolerance: the tiled backward rebuilds T by
    # division, the oracle differentiates its cumulative products
    for name, g in got.items():
        scale = np.abs(want[name]).max() + 1e-8
        np.testing.assert_allclose(g, want[name], atol=1e-2 * scale, err_msg=name)


def test_backward_wrapper_cpu_is_plain_version():
    records, ts_j, tc_j, TW, TH = jax_records(random_scene(seed=0, n=24, spread=0.8))
    args = [torch.from_numpy(np.array(x)) for x in (records, ts_j, tc_j)]
    out5, nc = blend_cuda.blend_forward_torch(*args, TW, TH, 16)
    d_out5 = torch.from_numpy(np.random.default_rng(0).normal(size=out5.shape).astype(np.float32))
    before = tracing.launches()["blend_backward"]
    got = blend_backward(*args, out5, nc, d_out5, TW, TH, 16)
    want = blend_backward_torch(*args, out5, nc, d_out5, TW, TH, 16)
    assert torch.equal(got, want) and got.shape == args[0].shape
    assert tracing.launches()["blend_backward"] == before
    # rows past the 10 live ones and slots past the walked pairs stay 0
    assert not got[10:].any()
    walked = torch.zeros(got.shape[1], dtype=torch.bool)
    for t in range(TW * TH):
        n = min(int(nc[t].max()), int(args[2][t]))
        walked[int(args[1][t]):int(args[1][t]) + n] = True
    assert not got[:, ~walked].any() and got[:, walked].any()
    with pytest.raises(ValueError):
        blend_backward(*args, out5, nc, d_out5[:4], TW, TH, 16)


@pytest.mark.parametrize("chunk", [1, 7])
def test_plain_backward_chunk_invariant(chunk):
    """The chunking bounds the plain backward's temporaries only: any chunk
    gives the default's result up to float32 regrouping of the products and
    suffix sums (1e-5 of the largest cotangent)."""
    records, ts_j, tc_j, TW, TH = jax_records(overdraw_scene())
    args = [torch.from_numpy(np.array(x)) for x in (records, ts_j, tc_j)]
    out5, nc = blend_cuda.blend_forward_torch(*args, TW, TH, 16)
    d_out5 = torch.from_numpy(np.random.default_rng(1).normal(size=out5.shape).astype(np.float32))
    want = blend_backward_torch(*args, out5, nc, d_out5, TW, TH, 16)
    got = blend_backward_torch(*args, out5, nc, d_out5, TW, TH, 16, chunk=chunk)
    scale = want.abs().amax(dim=1, keepdim=True) + 1e-8
    assert ((got - want).abs() <= 1e-5 * scale).all()
