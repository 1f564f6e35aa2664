"""The PDCNet+ port's building blocks (binocular3dgs_torch/init/pdcnet/
layers, vgg, gocor, decoders, uncertainty) against the JAX package's, on the
CPU, with seeded random weights and inputs made with numpy.

The JAX side reads its params through the port's converter
(`jax_params_from_state_dict`), so each test also holds the names and
layouts of one module. Tolerances: single convolutions, resizes and warps
agree to float32 rounding of sums taken in another order (2e-5 relative to
the output's scale); the GOCor optimizers unroll several steepest-descent
steps whose step length divides two sums, so 2e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init.pdcnet import decoders as jdec
from binocular3dgs_tpu.init.pdcnet import gocor as jgocor
from binocular3dgs_tpu.init.pdcnet import layers as jlayers
from binocular3dgs_tpu.init.pdcnet import uncertainty as junc
from binocular3dgs_tpu.init.pdcnet.vgg import vgg_pyramid
from binocular3dgs_torch.init.pdcnet import decoders, gocor, layers, uncertainty
from binocular3dgs_torch.init.pdcnet.convert import jax_params_from_state_dict
from binocular3dgs_torch.init.pdcnet.vgg import VGGPyramid

OP_RTOL, GOCOR_RTOL = 2e-5, 2e-4


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def randomize(module, seed=1):
    """Seeded BN statistics (so eval-mode BN is not the identity) and
    seeded weights everywhere; returns the module in eval mode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.3 if p.dim() > 1 else 0.5))
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return module.eval()


def jparams(module, prefix):
    sd = {f"{prefix}.{k}" if prefix else k: v for k, v in module.state_dict().items()}
    return {k: jnp.asarray(v) for k, v in jax_params_from_state_dict(sd).items()}


def assert_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("ks,dilation,act", [(3, 1, True), (3, 2, False), (1, 1, False)])
def test_conv_block(ks, dilation, act):
    pad = dilation if ks == 3 else 0
    block = randomize(layers.conv_block(5, 7, ks, padding=pad, dilation=dilation, act=act))
    x = rand(2, 11, 13, 5, seed=2)
    want = jlayers.conv_block(jnp.asarray(x), jparams(block, "blk"), "blk", padding=pad,
                              dilation=dilation, act="leaky" if act else None)
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    assert_close(got, want, OP_RTOL)


@pytest.mark.parametrize("name,cin,cout", [("deconv4", 2, 2), ("deconv2", 2, 2),
                                           ("upfeat2", 32, 2)])
def test_deconv(name, cin, cout):
    """nn.ConvTranspose2d(k4, s2, p1) against the JAX deconv reading the
    converter's pre-flipped HWIO weights."""
    deconv = randomize(torch.nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1))
    x = rand(1, 16, 16, cin, seed=3, scale=20.0)
    want = jlayers.conv_transpose2d(jnp.asarray(x), jparams(deconv, name), name)
    with torch.no_grad():
        got = nhwc(deconv(nchw(x)))
    assert got.shape == (1, 32, 32, cout)
    assert_close(got, want, OP_RTOL)


@pytest.mark.parametrize("size,align", [((7, 9), False), ((33, 41), False), ((33, 41), True),
                                        ((16, 16), False)])
def test_resize_bilinear(size, align):
    x = rand(2, 16, 20, 3, seed=4)
    want = jlayers.resize_bilinear(jnp.asarray(x), size, align_corners=align)
    got = nhwc(layers.resize_bilinear(nchw(x), size, align_corners=align))
    assert_close(got, want, OP_RTOL)


@pytest.mark.parametrize("size", [(8, 10), (7, 9), (40, 52), (256, 256)])
def test_resize_area(size):
    x = rand(1, 37, 53, 3, seed=5, scale=100.0)
    want = jlayers.resize_area(jnp.asarray(x), size)
    got = nhwc(layers.resize_area(nchw(x), size))
    assert_close(got, want, OP_RTOL)


def test_warp_and_flow_conversions():
    x = rand(2, 12, 15, 4, seed=6)
    flow = rand(2, 12, 15, 2, seed=7, scale=3.0)
    want = jlayers.warp(jnp.asarray(x), jnp.asarray(flow))
    got = nhwc(layers.warp(nchw(x), nchw(flow)))
    assert_close(got, want, OP_RTOL)
    nmap = np.tanh(rand(2, 12, 15, 2, seed=8))
    assert_close(nhwc(layers.unnormalise_mapping_and_convert_to_flow(nchw(nmap))),
                 jlayers.unnormalise_mapping_and_convert_to_flow(jnp.asarray(nmap)), OP_RTOL)
    assert_close(nhwc(layers.convert_flow_to_mapping(nchw(flow))),
                 jlayers.convert_flow_to_mapping(jnp.asarray(flow)), OP_RTOL)
    assert_close(nhwc(layers.convert_mapping_to_flow(nchw(flow))),
                 jlayers.convert_mapping_to_flow(jnp.asarray(flow)), OP_RTOL)
    assert_close(nhwc(layers.l2norm(nchw(x))), jlayers.l2norm(jnp.asarray(x)), OP_RTOL)


@pytest.mark.parametrize("n_levels", [4, 5])
def test_vgg_pyramid(n_levels):
    """The image pyramid (4 levels, to 1/8) and the 256x256 one (5)."""
    pyr = VGGPyramid(n_levels)
    torch.manual_seed(0)
    pyr.eval()
    x = rand(1, 48, 64, 3, seed=9)
    want = vgg_pyramid(jnp.asarray(x), jparams(pyr, "pyramid"), "pyramid",
                       eigth_resolution=n_levels == 4)
    with torch.no_grad():
        got = pyr(nchw(x))
    if n_levels == 4:  # the JAX list: full, 1/4, 1/8
        got = [got[0], got[2], got[3]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(nhwc(g), w, OP_RTOL)


def test_distance_bins():
    offs = torch.arange(-5.0, 6.0)
    want = jgocor.distance_bins(jnp.asarray(offs.numpy()), jnp.asarray(offs.numpy()))
    assert_close(gocor.distance_bins(offs, offs).numpy(), want, 1e-6)


def test_separable_conv4d():
    reg = gocor.SeparableConv4d()
    with torch.no_grad():
        reg.weight1.normal_(0, 0.1)
        reg.weight2.normal_(0, 0.1)
    p = jparams(reg, "r")
    x = rand(2, 6, 5, 6, 5, seed=10)
    assert_close(reg(torch.from_numpy(x)).detach().numpy(),
                 jgocor.separable_conv4d(jnp.asarray(x), p, "r"), OP_RTOL)
    y = rand(2, 6, 5, 16, 6, 5, seed=11)
    assert_close(reg.transpose(torch.from_numpy(y)).detach().numpy(),
                 jgocor.separable_conv4d_transpose(jnp.asarray(y), p, "r"), OP_RTOL)


@pytest.mark.parametrize("num_iter", [0, 3])
def test_global_gocor(num_iter):
    """GlobalGOCor (its constructor's values, the 4D regularizer enlarged so
    the query loss weighs) on L2-normed features, 6x5 reference and 5x6
    query positions, d = 24."""
    mod = gocor.GlobalCorr(feature_dim=24, num_iter=num_iter)
    with torch.no_grad():
        mod.corr_module.filter_optimizer.reg_layer.weight1.normal_(0, 0.2)
        mod.corr_module.filter_optimizer.reg_layer.weight2.normal_(0, 0.2)
        mod.corr_module.filter_initializer.target_bg.fill_(0.3)
    ref = np.asarray(jlayers.l2norm(jnp.asarray(rand(2, 6, 5, 24, seed=12))))
    qry = np.asarray(jlayers.l2norm(jnp.asarray(rand(2, 5, 6, 24, seed=13))))
    want = jgocor.global_gocor(jnp.asarray(ref), jnp.asarray(qry), jparams(mod, "corr"),
                               prefix="corr.corr_module", num_iter=num_iter)
    with torch.no_grad():
        got = nhwc(mod(nchw(ref), nchw(qry)))
    assert got.shape == (2, 6, 5, 30)
    assert_close(got, want, GOCOR_RTOL)


@pytest.mark.parametrize("num_iter", [1, 7])
def test_local_gocor(num_iter):
    mod = gocor.LocalGOCor(num_iter=num_iter)
    with torch.no_grad():
        mod.filter_initializer.scaling.fill_(0.7)
    ref, qry = rand(1, 10, 12, 16, seed=14), rand(1, 10, 12, 16, seed=15)
    want = jgocor.local_gocor(jnp.asarray(ref), jnp.asarray(qry), jparams(mod, "local_corr"),
                              num_iter=num_iter)
    with torch.no_grad():
        got = nhwc(mod(nchw(ref), nchw(qry)))
    assert got.shape == (1, 10, 12, 81)
    assert_close(got, want, GOCOR_RTOL)


@pytest.mark.parametrize("kind,cin", [("cmd_top", 258), ("flow", 87), ("flow", 89)])
def test_decoders(kind, cin):
    cls = decoders.CMDTopResidual if kind == "cmd_top" else decoders.FlowEstimatorResidual
    dec = randomize(cls(cin), seed=cin)
    x = rand(1, 9, 11, cin, seed=16)
    jfn = jdec.cmd_top_residual if kind == "cmd_top" else jdec.flow_estimator_residual
    want_x, want_f = jfn(jnp.asarray(x), jparams(dec, "decoder"), "decoder")
    with torch.no_grad():
        got_x, got_f = dec(nchw(x))
    assert got_x.shape[1] == 32 and got_f.shape[1] == 2
    assert_close(nhwc(got_x), want_x, OP_RTOL)
    assert_close(nhwc(got_f), want_f, OP_RTOL)


@pytest.mark.parametrize("stem", ["dc_conv", "l_dc_conv"])
def test_pwc_refinement(stem):
    holder = torch.nn.Module()
    decoders.add_pwc_refinement(holder, stem, 34)
    randomize(holder, seed=17)
    x = rand(1, 40, 36, 34, seed=18)  # over 2 x the largest dilation, 16
    want_x, want_r = jdec.pwc_refinement(jnp.asarray(x), jparams(holder, ""), stem)
    with torch.no_grad():
        got_x, got_r = decoders.pwc_refinement(holder, stem, nchw(x))
    assert_close(nhwc(got_x), want_x, OP_RTOL)
    assert_close(nhwc(got_r), want_r, OP_RTOL)


@pytest.mark.parametrize("search_size", [9, 16])
def test_corr_uncertainty_decoder(search_size):
    dec = randomize(uncertainty.CorrUncertaintyDecoder(search_size), seed=search_size)
    corr = rand(1, 5, 7, search_size ** 2, seed=19)
    want = junc.corr_uncertainty_decoder(jnp.asarray(corr), jparams(dec, "cud"), "cud",
                                         search_size)
    with torch.no_grad():
        got = nhwc(dec(nchw(corr)))
    assert got.shape == (1, 5, 7, 6)
    assert_close(got, want, OP_RTOL)


def test_uncertainty_heads():
    pred = randomize(uncertainty.UncertaintyPredictor(44), seed=20)
    x = rand(1, 8, 9, 44, seed=21)
    want_l, want_w = junc.uncertainty_predictor(jnp.asarray(x), jparams(pred, "ud"), "ud")
    with torch.no_grad():
        got_l, got_w = pred(nchw(x))
    assert_close(nhwc(got_l), want_l, OP_RTOL)
    assert_close(nhwc(got_w), want_w, OP_RTOL)

    large = rand(1, 8, 9, 1, seed=22, scale=5.0)
    for vmax in (256.0 ** 2, 520.0 ** 2):
        assert_close(uncertainty.constrain_large_log_var_map(2.0, vmax, torch.from_numpy(large)),
                     junc.constrain_large_log_var_map(2.0, vmax, jnp.asarray(large)), OP_RTOL)
    log_var = np.concatenate([np.zeros_like(large), np.log(2.0 + np.exp(large))], -1)
    weight = rand(1, 8, 9, 2, seed=23)
    for R in (1.0, 3.0):
        for gaussian in (False, True):
            got = uncertainty.p_r_of_mixture(torch.from_numpy(weight), torch.from_numpy(log_var),
                                             R=R, gaussian=gaussian, dim=-1)
            assert_close(got, junc.p_r_of_mixture(jnp.asarray(weight), jnp.asarray(log_var), R=R,
                                                  gaussian=gaussian), OP_RTOL)
    assert_close(uncertainty.average_variance_of_mixture(torch.from_numpy(weight),
                                                         torch.from_numpy(log_var), dim=-1),
                 junc.average_variance_of_mixture(jnp.asarray(weight), jnp.asarray(log_var)),
                 OP_RTOL)
