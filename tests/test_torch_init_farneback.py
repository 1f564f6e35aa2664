"""The port's Farneback flow (binocular3dgs_torch/init/farneback.py) against
`cv2.calcOpticalFlowFarneback` with the matcher's settings, and the port's
FarnebackMatcher against the JAX package's (which is OpenCV).

A rebuild of OpenCV's algorithm differs from it only in the order of its
float sums, so the flows must agree far below a pixel: median end-point
error <= 0.01 px and 99th percentile <= 0.1 px, on textured images at two
sizes each (one over 500 px wide), so that the pyramid is cut at several
depths."""

import cv2
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from binocular3dgs_tpu.init.matchers import FarnebackMatcher as JaxMatcher
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.init.farneback import calc_optical_flow_farneback, gaussian_kernel
from binocular3dgs_torch.init.matchers import FarnebackMatcher, PDCNetPlusMatcher, select_matcher
from binocular3dgs_torch.init.pdcnet.model import random_model
from binocular3dgs_torch.models.gaussians import from_numpy
from binocular3dgs_torch.ops.rasterize import render_tiled

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

SETTINGS = dict(pyr_scale=0.5, levels=5, winsize=21, iterations=5, poly_n=7, poly_sigma=1.5)
MEDIAN_EPE, P99_EPE = 0.01, 0.1


def blob_image(h, w, seed=7):
    """High-contrast random blobs (tests/test_init.py's matcher images)."""
    rng = np.random.default_rng(seed)
    blobs = ndi.gaussian_filter(rng.random((h, w)), 4)
    img = np.stack([(blobs > np.percentile(blobs, q)).astype(np.float32) for q in (40, 50, 60)],
                   -1)
    return (img * 200 + 30).astype(np.uint8)


def blob_pair(h, w):
    base = blob_image(h, w)
    return base, np.roll(base, 6, axis=1)


def rendered_pair(h, w, seed=3, n=3000):
    """Two views of one seeded gaussian slab rendered by the port on the
    CPU, the second camera moved 0.12 along x and 0.03 along y."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2.2, 2.2, n), rng.uniform(4, 8, n)], 1)
    params = dict(
        xyz=xyz.astype(np.float32),
        f_dc=(rng.normal(size=(n, 1, 3)) * 1.2).astype(np.float32),
        f_rest=np.zeros((n, 3, 3), np.float32),
        opacity=np.full((n, 1), 2.0, np.float32),
        scaling=np.log(rng.uniform(0.02, 0.09, (n, 3))).astype(np.float32),
        rotation=np.concatenate([np.ones((n, 1)), np.zeros((n, 3))], 1).astype(np.float32),
    )
    model = from_numpy(params, np.ones(n, bool), 1, 0, device="cpu")
    views = []
    for t in ([0.0, 0.0, 0.0], [-0.12, -0.03, 0.0]):
        cam = make_camera(np.eye(3), np.array(t), 0.9, 0.9 * h / w, w, h, device="cpu")
        with torch.no_grad():
            img = render_tiled(cam, model, [0.5, 0.5, 0.5], device="cpu").image
        views.append((img.clamp(0, 1).permute(1, 2, 0).numpy() * 255).astype(np.uint8))
    return views


PAIRS = {
    "blobs_120x160": lambda: blob_pair(120, 160),
    "blobs_378x504": lambda: blob_pair(378, 504),
    "render_96x128": lambda: rendered_pair(96, 128),
    "render_384x512": lambda: rendered_pair(384, 512),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_flow_matches_opencv(name):
    a, b = (cv2.cvtColor(x, cv2.COLOR_RGB2GRAY) for x in PAIRS[name]())
    ref = cv2.calcOpticalFlowFarneback(a, b, None, flags=0, **SETTINGS)
    got = calc_optical_flow_farneback(torch.from_numpy(a), torch.from_numpy(b), **SETTINGS)
    assert got.shape == ref.shape and got.dtype == torch.float32
    epe = np.linalg.norm(got.numpy() - ref, axis=-1)
    assert np.median(np.abs(ref)) > 0.5  # the images do move
    assert np.median(epe) <= MEDIAN_EPE and np.percentile(epe, 99) <= P99_EPE, (
        np.median(epe), np.percentile(epe, 99), epe.max())


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5), (19, 3.5), (79, 15.5)])
def test_gaussian_kernel_matches_opencv(ksize, sigma):
    """The pyramid's blur kernels (sizes and sigmas of levels 0-5)."""
    ref = cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)[:, 0]
    np.testing.assert_allclose(gaussian_kernel(ksize, sigma), ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["blobs_120x160", "render_384x512"])
def test_matcher_matches_jax(name):
    """The port's matcher against the JAX one (OpenCV's flow): the selected
    stride-grid points agree on >= 99%, compared as sets (the confidence
    order ties differently); the shared matches' targets within 0.05 px."""
    ref_img, src_img = PAIRS[name]()
    kw = dict(scaling=1.0 if name.startswith("blobs") else 0.25, stride=2)
    want = JaxMatcher(**kw).get_matches_and_confidence(ref_img, src_img)
    got = FarnebackMatcher(device="cpu", **kw).get_matches_and_confidence(ref_img, src_img)
    assert all(v.dtype == np.float32 for v in got.values())
    assert np.all(np.diff(got["confidence_value"]) <= 0)
    src_w = {tuple(p): t for p, t in zip(want["kp_source"], want["kp_target"])}
    src_g = {tuple(p): t for p, t in zip(got["kp_source"], got["kp_target"])}
    shared = src_w.keys() & src_g.keys()
    assert len(src_w) > 100
    assert len(shared) >= 0.99 * max(len(src_w), len(src_g)), (len(src_w), len(src_g))
    d = max(float(np.abs(src_w[k] - src_g[k]).max()) for k in shared)
    assert d <= 0.05, d


def test_select_matcher(tmp_path):
    assert isinstance(select_matcher("farneback", device="cpu"), FarnebackMatcher)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        select_matcher("pdcnet", device="cpu")
    weights = str(tmp_path / "w.pth")
    torch.save(random_model(0).state_dict(), weights)
    matcher = select_matcher("pdcnet", weights_path=weights, device="cpu")
    assert isinstance(matcher, PDCNetPlusMatcher)
    assert matcher.net.device == torch.device("cpu")
    with pytest.raises(ValueError):
        select_matcher("sift", device="cpu")
