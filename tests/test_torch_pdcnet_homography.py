"""The port's RANSAC homography and perspective warp
(binocular3dgs_torch/init/pdcnet/homography.py) against OpenCV's
`cv2.findHomography(..., cv2.RANSAC, 1.0, maxIters=3000)` and
`cv2.warpPerspective`, which the JAX package's PDCNet+ inference calls.

RANSAC cannot equal OpenCV draw for draw (its `cv::RNG` is its own), so the
two are compared by where their H sends the image corners:

  * exact inliers plus 20-75% outliers: any RANSAC that finds the inlier
    set and refits it lands on the true H up to float rounding, so port and
    OpenCV agree within 1e-3 px (float32 inputs at ~100 px carry ~1e-5 px);
  * inliers with 0.3 px noise: both refit a noisy set, so each must land
    within the RANSAC threshold (1 px) of the true H, and their inlier
    counts within 2% of each other;
  * `homography_is_accepted` decides the same for both, including a
    mirrored H that both reject.

The warp: OpenCV 5 computes each source position in float32, the port in
float64, so they differ by the rounding of a float32 position (a few ulp
of the coordinate) times the image's step between neighbours (<= 255):
the tolerance is 255 * 2^-20 * (w + h)."""

import cv2
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init.pdcnet.inference import homography_is_accepted as jax_accepted
from binocular3dgs_torch.init.pdcnet.homography import find_homography_ransac, warp_perspective
from binocular3dgs_torch.init.pdcnet.inference import homography_is_accepted

W, H = 128, 96
H_TRUE = np.array([[1.02, 0.03, 2.0], [-0.02, 0.98, -1.5], [1e-4, -5e-5, 1.0]])
H_MIRROR = np.array([[-1.0, 0.02, 127.0], [0.01, 1.0, 0.5], [0.0, 0.0, 1.0]])
EXACT_TOL, THRESH = 1e-3, 1.0


def matches(seed, n, outliers, noise=0.0, H_=H_TRUE):
    rng = np.random.default_rng(seed)
    src = rng.uniform([0, 0], [W, H], (n, 2))
    p = np.c_[src, np.ones(n)] @ H_.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(0, noise, (n, 2))
    k = int(outliers * n)
    bad = rng.choice(n, k, replace=False)
    true = dst[bad].copy()
    dst[bad] = rng.uniform([0, 0], [W, H], (k, 2))
    near = np.linalg.norm(dst[bad] - true, axis=1) < 3 * THRESH  # an outlier by chance an inlier
    dst[bad[near]] += 4 * THRESH
    return src.astype(np.float32), dst.astype(np.float32)


def corners(H_):
    c = np.array([[0, 0, 1], [W, 0, 1], [0, H, 1], [W, H, 1.0]]) @ H_.T
    return c[:, :2] / c[:, 2:]


def both(src, dst, seed=0):
    Hc, mc = cv2.findHomography(src, dst, cv2.RANSAC, THRESH, maxIters=3000)
    Hp, mp = find_homography_ransac(torch.from_numpy(src), torch.from_numpy(dst), THRESH, 3000,
                                    generator=torch.Generator().manual_seed(seed))
    return Hc, int(mc.sum()), Hp, int(mp.sum())


@pytest.mark.parametrize("seed,n,outliers", [(0, 500, 0.2), (1, 600, 0.3), (2, 400, 0.4),
                                             (3, 800, 0.75)])
def test_ransac_exact_inliers(seed, n, outliers):
    src, dst = matches(seed, n, outliers)
    Hc, nc, Hp, np_ = both(src, dst, seed)
    assert Hp is not None and Hp[2, 2] == 1.0
    assert np.abs(corners(Hp) - corners(Hc)).max() <= EXACT_TOL
    assert np.abs(corners(Hp) - corners(H_TRUE)).max() <= EXACT_TOL
    assert np_ == nc >= n - int(outliers * n)
    assert homography_is_accepted(Hp) == jax_accepted(Hc) is True


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_noisy_inliers(seed):
    src, dst = matches(seed, 600, 0.3, noise=0.3)
    Hc, nc, Hp, np_ = both(src, dst, seed)
    for H_ in (Hc, Hp):
        assert np.abs(corners(H_) - corners(H_TRUE)).max() <= THRESH
    assert abs(np_ - nc) <= 0.02 * nc
    assert homography_is_accepted(Hp) == jax_accepted(Hc) is True


def test_ransac_mirror_rejected_by_both():
    src, dst = matches(4, 500, 0.3, H_=H_MIRROR)
    Hc, nc, Hp, np_ = both(src, dst)
    assert np.abs(corners(Hp) - corners(Hc)).max() <= EXACT_TOL and np_ == nc
    assert homography_is_accepted(Hp) == jax_accepted(Hc) is False


def test_ransac_small_sets():
    src, dst = matches(5, 4, 0.0)
    Hp, mask = find_homography_ransac(src, dst, THRESH)
    Hc, _ = cv2.findHomography(src, dst, cv2.RANSAC, THRESH)
    assert bool(mask.all()) and np.abs(corners(Hp) - corners(Hc)).max() <= EXACT_TOL
    Hp, mask = find_homography_ransac(src[:3], dst[:3], THRESH)
    assert Hp is None and not bool(mask.any())
    # the same draws give the same answer
    src, dst = matches(6, 300, 0.5, noise=0.3)
    a = find_homography_ransac(src, dst, THRESH, generator=torch.Generator().manual_seed(3))
    b = find_homography_ransac(src, dst, THRESH, generator=torch.Generator().manual_seed(3))
    assert np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("h,w", [(37, 53), (96, 128), (378, 504)])
@pytest.mark.parametrize("which", ["perspective", "scale", "inverse"])
def test_warp_perspective(h, w, which):
    rng = np.random.default_rng(h)
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    Hx = {"perspective": H_TRUE, "scale": np.diag([0.5, 0.6, 1.0]),
          "inverse": np.linalg.inv(H_TRUE)}[which]
    size = (w // 2, h // 2) if which == "scale" else (w, h)
    want = cv2.warpPerspective(img, Hx, size)
    got = warp_perspective(torch.from_numpy(img), Hx, size).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 255 * 2.0 ** -20 * (w + h)
