"""The PDCNet+ port's inference (binocular3dgs_torch/init/pdcnet/inference.py)
and matcher against the JAX package's, on the CPU, with seeded random
weights (no checkpoint is in the repository).

  * the network path, mode `d` with cyclic consistency, 96x128 images (the
    network sees 256x256), iterations cut to 1 global and 2 local (one JAX
    compile per module): `_direct`'s flow, log-variances, weights, P_R and
    variance, the cyclic error, and `get_matches_and_confidence`'s rows
    compared as sets (numpy's argsort leaves ties in an order of its own),
    within 1e-4 of each map's largest value;
  * the 2-stage paths, `h` and `ms`, with `_direct` replaced in both
    packages by the same synthetic flow of a known homography (random
    weights make RANSAC's input noise): the composed flow within 1e-3 px
    and the visibility mask equal on >= 99.9% of pixels (the two RANSACs'
    H differ by float rounding);
  * the matcher's convention against the pipeline's, on a plane seen by two
    cameras: the port triangulates it in front of the cameras, the JAX
    package's matcher hands `triangulate_pairs` its points the other way
    round and they land behind them (ROADMAP C);
  * the converter CLI's npz runs in the JAX package to the same flow as
    the weights it was made from (`cli triangulate --matcher pdcnet`:
    tests/test_torch_pdcnet_cli.py).
"""

import functools

import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init import pipeline as jax_pipeline
from binocular3dgs_tpu.init.matchers import PDCNetPlusMatcher as JaxMatcher
from binocular3dgs_tpu.init.pdcnet.inference import PDCNetPlus as JaxNet
from binocular3dgs_torch.init import pipeline
from binocular3dgs_torch.init.matchers import PDCNetPlusMatcher
from binocular3dgs_torch.init.pdcnet import convert, inference
from binocular3dgs_torch.init.pdcnet.inference import PDCNetPlus
from binocular3dgs_torch.init.pdcnet.model import random_model

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

RTOL, FLOW_ATOL, MASK_SHARE = 1e-4, 1e-3, 0.999
ITERS = dict(global_optim_iter=1, local_optim_iter=2)
H_IMG, W_IMG = 96, 128
H_TRUE = np.array([[1.02, 0.03, 2.0], [-0.02, 0.98, -1.5], [1e-4, -5e-5, 1.0]])


def textured(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H_IMG, 0:W_IMG]
    checker = (((yy // 8) + (xx // 8)) % 2)[..., None] * 120
    return np.clip(rng.random((H_IMG, W_IMG, 3)) * 80 + checker, 0, 255).astype(np.uint8)


SRC, TGT = textured(1), textured(2)


@pytest.fixture(scope="module")
def weights():
    return random_model(0).state_dict()


@pytest.fixture(scope="module")
def nets(weights):
    params = convert.jax_params_from_state_dict(weights)
    cyc = {"multi_stage_type": "d", "compute_cyclic_consistency_error": True}
    return JaxNet(params, cyc, **ITERS), PDCNetPlus(weights, cyc, device="cpu", **ITERS)


def np_(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(got, want, rtol=RTOL):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()), 1e-6))


def test_direct(nets):
    jnet, tnet = nets
    fj, uj = jnet._direct(SRC, TGT, (24, 32))
    ft, ut = tnet._direct(SRC, TGT, (24, 32))
    assert tuple(ft.shape) == (1, 24, 32, 2)
    assert_close(ft, fj)
    for k in ("log_var_map", "weight_map", "p_r", "variance"):
        assert_close(ut[k], uj[k])
    p_r = np_(ut["p_r"])
    assert p_r.std() > 0 and np_(ft).std() > 0
    assert (p_r >= 0.1).mean() > 0.5  # proba_interval_1_above_10 leaves matches


def test_cyclic_consistency(nets):
    jnet, tnet = nets
    fj, uj = jnet.estimate_flow_and_confidence_map(SRC, TGT, scaling=0.25)
    ft, ut = tnet.estimate_flow_and_confidence_map(SRC, TGT, scaling=0.25)
    assert_close(ft, fj)
    for k in ("cyclic_consistency_error", "inv_cyclic_consistency_error", "p_r"):
        assert_close(ut[k], uj[k])


def test_get_matches_and_confidence(nets):
    jnet, tnet = nets
    want = jnet.get_matches_and_confidence(TGT, SRC)
    got = tnet.get_matches_and_confidence(TGT, SRC)
    assert {k: v.dtype for k, v in got.items() if k.startswith(("kp", "conf"))} == {
        "kp_source": np.float32, "kp_target": np.float32, "confidence_value": np.float32}
    assert len(want["kp_target"]) >= 200
    assert np.all(np.diff(got["confidence_value"]) <= 0)
    rows_w = {tuple(t): (s, c) for s, t, c in zip(want["kp_source"], want["kp_target"],
                                                  want["confidence_value"])}
    rows_g = {tuple(t): (s, c) for s, t, c in zip(got["kp_source"], got["kp_target"],
                                                  got["confidence_value"])}
    # a row may be in one set only where its confidence sits at the 0.1 cut
    for only in (rows_w.keys() - rows_g.keys(), rows_g.keys() - rows_w.keys()):
        assert all(abs(float({**rows_w, **rows_g}[k][1]) - 0.1) < 1e-5 for k in only)
    shared = rows_w.keys() & rows_g.keys()
    assert len(shared) >= 0.99 * len(rows_w)
    s_w = np.array([rows_w[k][0] for k in shared])
    s_g = np.array([rows_g[k][0] for k in shared])
    assert_close(s_g, s_w)
    np.testing.assert_allclose([rows_g[k][1] for k in shared], [rows_w[k][1] for k in shared],
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the 2-stage paths on a synthetic homography flow
# ---------------------------------------------------------------------------


def homography_flow(M, out_hw, scaling):
    """The flow of the mapping M (target image pixel -> source image pixel)
    on an out_hw grid whose pixel is `scaling` (x, y) image pixels."""
    oh, ow = out_hw
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    p = np.stack([xs * scaling[0], ys * scaling[1], np.ones_like(xs)], -1) @ M.T
    m = p[..., :2] / p[..., 2:] / np.asarray(scaling)
    return (m - np.stack([xs, ys], -1))[None].astype(np.float32)


def residual_flow(out_hw, seed=5):
    oh, ow = out_hw
    ys, xs = np.mgrid[0:oh, 0:ow] / max(oh, ow)
    rng = np.random.default_rng(seed)
    a = rng.normal(size=4)
    f = np.stack([a[0] * np.sin(3 * xs) + a[1] * ys, a[2] * np.cos(2 * ys) + a[3] * xs], -1)
    return (0.8 * f)[None].astype(np.float32)


def fake_uncertainty(out_hw, seed):
    rng = np.random.default_rng(seed)
    oh, ow = out_hw
    log_var = np.concatenate([np.zeros((1, oh, ow, 1)), rng.uniform(1, 8, (1, oh, ow, 1))], -1)
    weight = rng.normal(size=(1, oh, ow, 2)) + np.array([2.0, 0.0])
    p_r = np.full((1, oh, ow, 1), 0.9)
    return {"log_var_map": log_var.astype(np.float32), "weight_map": weight.astype(np.float32),
            "p_r": p_r.astype(np.float32), "variance": np.exp(log_var[..., 1:]).astype(np.float32)}


def fake_direct(flows, torch_out):
    """A `_direct` that returns flows[i] at the i-th call, each a function
    of the output shape; the same numbers in both packages."""
    calls = []

    def direct(self, source, target, output_shape):
        shape = tuple(int(s) for s in (output_shape or target.shape[:2]))
        flow = flows[len(calls)](shape)
        unc = fake_uncertainty(shape, len(calls))
        calls.append(shape)
        if torch_out:
            return torch.from_numpy(flow), {k: torch.from_numpy(v) for k, v in unc.items()}
        return flow, unc

    return direct, calls


def compare_two_stage(monkeypatch, weights, mode, flows):
    params = {"multi_stage_type": mode, "compute_cyclic_consistency_error": False}
    jnet = JaxNet(convert.jax_params_from_state_dict(weights), params)
    tnet = PDCNetPlus(weights, params, device="cpu")
    jd, jcalls = fake_direct(flows, False)
    td, tcalls = fake_direct(flows, True)
    monkeypatch.setattr(JaxNet, "_direct", jd)
    monkeypatch.setattr(PDCNetPlus, "_direct", td)
    fj, uj = jnet.estimate_flow_and_confidence_map(SRC, TGT, scaling=0.25)
    ft, ut = tnet.estimate_flow_and_confidence_map(SRC, TGT, scaling=0.25)
    assert jcalls == tcalls and len(tcalls) == len(flows)  # the 2nd pass ran in both
    mj, mt = np.asarray(uj["warping_mask"]), np_(ut["warping_mask"])
    assert mt.shape == mj.shape and 0.2 < mt.mean() < 1.0
    assert (mt == mj).mean() >= MASK_SHARE
    both = mt & mj
    np.testing.assert_allclose(np_(ft)[both], fj[both], rtol=0, atol=FLOW_ATOL)
    np.testing.assert_allclose(np_(ft)[~mt & ~mj], fj[~mt & ~mj], rtol=0, atol=FLOW_ATOL)
    assert_close(ut["p_r"], uj["p_r"])


def test_with_homo(monkeypatch, weights):
    """Mode h: the first pass gives the flow of inv(H_TRUE) at a quarter of
    the image, RANSAC recovers H_TRUE, the source is warped by it, and the
    second pass's (residual) flow is composed through the mapping."""
    quarter = (W_IMG / 32, H_IMG / 24)
    flows = [lambda s: homography_flow(np.linalg.inv(H_TRUE), s, quarter),
             lambda s: residual_flow(s)]
    compare_two_stage(monkeypatch, weights, "h", flows)


def test_with_multiscale(monkeypatch, weights):
    """Mode ms: each resizing ratio's pass gives the flow of its own resized
    pair (Hs inv(H_TRUE) inv(Ht)), so every candidate votes H_TRUE; the best
    normalized inlier fraction wins and the second pass composes as in h."""
    ratios = inference.DEFAULT_INFERENCE_PARAMETERS["list_resizing_ratios"]
    quarter = (W_IMG / 32, H_IMG / 24)
    flows = []
    for r in ratios:
        Ht, Hs = np.eye(3), np.eye(3)
        if r < 1:
            Ht = np.diag([int(W_IMG * r) / W_IMG, int(H_IMG * r) / H_IMG, 1.0])
        elif r > 1:
            Hs = np.diag([int(W_IMG / r) / W_IMG, int(H_IMG / r) / H_IMG, 1.0])
        M = Hs @ np.linalg.inv(H_TRUE) @ np.linalg.inv(Ht)
        flows.append(functools.partial(lambda s, M: homography_flow(M, s, quarter), M=M))
    flows.append(lambda s: residual_flow(s))
    compare_two_stage(monkeypatch, weights, "ms", flows)


# ---------------------------------------------------------------------------
# the matcher in the pipeline, the converter
# ---------------------------------------------------------------------------


def test_matcher_convention_against_the_pipeline(weights):
    """Two cameras 0.3 apart see the plane z = 5; each matcher's flow is
    the plane's exact one. `triangulate_pairs` pairs kp_source with the
    reference camera: the port's matcher hands it the reference view's
    points there and the plane comes out at z = +5; the JAX package's
    PDCNet+ matcher hands it the source view's, and every point that
    passes the reprojection filter is the plane's mirror at z = -5."""
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    c2ws = [np.eye(4), np.eye(4)]
    c2ws[1][:3, 3] = [0.3, 0.05, 0.0]
    imgs = [np.zeros((H_IMG, W_IMG, 3), np.uint8), np.zeros((H_IMG, W_IMG, 3), np.uint8)]

    def plane_flow(ref, src, out_hw):
        s = W_IMG / out_hw[1]
        ys, xs = np.mgrid[0:out_hw[0], 0:out_hw[1]].astype(np.float64)
        rays = np.stack([(xs * s - K[0, 2]) / K[0, 0], (ys * s - K[1, 2]) / K[1, 1],
                         np.ones_like(xs)], -1) * 5.0
        world = rays @ c2ws[ref][:3, :3].T + c2ws[ref][:3, 3]
        w2c = np.linalg.inv(c2ws[src])
        cam = world @ w2c[:3, :3].T + w2c[:3, 3]
        q = cam[..., :2] / cam[..., 2:] * [K[0, 0], K[1, 1]] + K[:2, 2]
        return (q / s - np.stack([xs, ys], -1))[None].astype(np.float32)

    def estimate(to):
        def est(source, target, output_shape=None, scaling=1.0):
            ref = 0 if target is imgs[0] else 1
            shape = (int(H_IMG * scaling), int(W_IMG * scaling))
            return to(plane_flow(ref, 1 - ref, shape)), {"p_r": to(np.ones(shape + (1,))[None])}
        return est

    jm = JaxMatcher.__new__(JaxMatcher)
    jm.net = JaxNet(convert.jax_params_from_state_dict(weights))
    jm.net.estimate_flow_and_confidence_map = estimate(lambda a: a)
    tm = PDCNetPlusMatcher.__new__(PDCNetPlusMatcher)
    tm.net = PDCNetPlus(weights, device="cpu")
    tm.net.estimate_flow_and_confidence_map = estimate(torch.from_numpy)
    kw = dict(growth_iterations=0)
    pts_j, _ = jax_pipeline.triangulate_pairs(imgs, K, c2ws, [0, 1], jm,
                                              jax_pipeline.TriangulateConfig(**kw))
    pts_t, _ = pipeline.triangulate_pairs(imgs, K, c2ws, [0, 1], tm,
                                          pipeline.TriangulateConfig(**kw))
    assert len(pts_t) > 1000 and np.allclose(pts_t[:, 2], 5.0, atol=1e-6)
    assert len(pts_j) > 1000 and np.allclose(pts_j[:, 2], -5.0, atol=1e-6)


def test_converter_cli_npz_runs_in_jax(tmp_path, weights, nets):
    jnet, tnet = nets
    pth, npz = str(tmp_path / "w.pth"), str(tmp_path / "w.npz")
    torch.save({"state_dict": weights}, pth)
    convert.main([pth, npz])
    from_file = JaxNet(npz, {"multi_stage_type": "d"}, **ITERS)
    f_file, _ = from_file._direct(SRC, TGT, (24, 32))
    f_mem, _ = jnet._direct(SRC, TGT, (24, 32))
    np.testing.assert_array_equal(f_file, f_mem)
    assert_close(tnet._direct(SRC, TGT, (24, 32))[0], f_file)
