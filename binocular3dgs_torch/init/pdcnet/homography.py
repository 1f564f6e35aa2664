"""RANSAC homography and perspective warp: the port's own, in place of
`cv2.findHomography(..., cv2.RANSAC, ...)` and `cv2.warpPerspective`, which
the JAX package's PDCNet+ inference calls (`inference.py:131,159` and
`:279,332,340,395` there) and which the card's machine does not have.

`find_homography_ransac` follows OpenCV's `findHomography` with RANSAC
(calib3d fundam.cpp and ptsetreg.cpp):

  * minimal sets of 4 distinct matches, rejected unless the 4th point is
    off every line through two of the first three (in both images) and
    the four triangles keep or all flip their orientation (checkSubset);
  * a 4-point DLT with OpenCV's normalization (centroid, mean absolute
    deviation) and the eigenvector of the smallest eigenvalue of L^T L,
    in float64 (runKernel);
  * a match is an inlier where its float32 squared forward reprojection
    error is at most thresh^2 (computeError, findInliers); a hypothesis
    replaces the best when it has more inliers than max(best, 3), and the
    bound on iterations shrinks to log(1 - confidence) / log(1 - w^4)
    (RANSACUpdateNumIters);
  * the best hypothesis' inliers are refit by the DLT and refined by
    Levenberg-Marquardt (10 iterations) on their reprojection error; H is
    scaled to H[2, 2] = 1, and the inlier mask returned is that of the
    refined H (as cv2 5.0.0 returns it: the tests compare the two).

OpenCV draws its sets from its own `cv::RNG`; here they come from a seeded
CPU `torch.Generator` (the same draws whatever the device), in batches
whose hypotheses are scored together on the points' device and then
walked in order on the host, so the stopping rule is OpenCV's sequential
one. The refinement fixes H[2, 2] = 1 and moves the other 8 entries
(OpenCV moves all 9 under the same scale-free residual).

`warp_perspective` is `cv2.warpPerspective` with its defaults
(INTER_LINEAR, BORDER_CONSTANT 0, H inverted to map each output pixel to
its source). OpenCV 5's kernel computes the source position in float32
and reads no 1/32 px table: measured against cv2 5.0.0 (the tests), a
float64 position and float32 bilinear taps agree within the rounding of
OpenCV's float32 position (about 2^-23 of the coordinate, times the
image's step between neighbouring pixels).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BATCH = 256  # hypotheses scored together
MAX_SUBSET_ATTEMPTS = 10_000  # getSubset's attempts before it gives up
FLT_EPSILON = float(np.finfo(np.float32).eps)
DBL_EPSILON = float(np.finfo(np.float64).eps)


def _update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """RANSACUpdateNumIters."""
    p, ep = min(max(p, 0.0), 1.0), min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(np.rint(num / denom))


def _subset_ok(ms1: torch.Tensor, ms2: torch.Tensor) -> torch.Tensor:
    """checkSubset for (B, 4, 2) float64 minimal sets -> (B,) bool."""

    def collinear(m):  # the last point on a line through two of the first three
        bad = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
        d = m[:, :3] - m[:, 3:4]  # (B, 3, 2)
        for j, k in ((1, 0), (2, 0), (2, 1)):
            dx1, dy1, dx2, dy2 = d[:, j, 0], d[:, j, 1], d[:, k, 0], d[:, k, 1]
            bad |= (dx2 * dy1 - dy2 * dx1).abs() <= FLT_EPSILON * (
                dx1.abs() + dy1.abs() + dx2.abs() + dy2.abs())
        return bad

    def det3(m, t):
        a, b, c = m[:, t[0]], m[:, t[1]], m[:, t[2]]
        return (a[:, 0] * (b[:, 1] - c[:, 1]) - a[:, 1] * (b[:, 0] - c[:, 0])
                + (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]))

    negative = sum((det3(ms1, t) * det3(ms2, t) < 0).int()
                   for t in ((0, 1, 2), (1, 2, 3), (0, 2, 3), (0, 1, 3)))
    return ~collinear(ms1) & ~collinear(ms2) & ((negative == 0) | (negative == 4))


def _dlt(M: torch.Tensor, m: torch.Tensor):
    """runKernel, batched: M, m (B, n, 2) float64 (src, dst) -> (H (B, 3, 3)
    scaled to H[2, 2] = 1, ok (B,) where the normalization was defined)."""
    count = M.shape[1]
    cm, cM = m.mean(1), M.mean(1)  # (B, 2)
    sm = (m - cm[:, None]).abs().sum(1)
    sM = (M - cM[:, None]).abs().sum(1)
    ok = (sm.abs() >= DBL_EPSILON).all(1) & (sM.abs() >= DBL_EPSILON).all(1)
    sm = count / torch.where(ok[:, None], sm, torch.ones_like(sm))
    sM = count / torch.where(ok[:, None], sM, torch.ones_like(sM))
    xy = (m - cm[:, None]) * sm[:, None]
    XY = (M - cM[:, None]) * sM[:, None]
    x, y, X, Y = xy[..., 0], xy[..., 1], XY[..., 0], XY[..., 1]
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    Lx = torch.stack([X, Y, one, zero, zero, zero, -x * X, -x * Y, -x], -1)
    Ly = torch.stack([zero, zero, zero, X, Y, one, -y * X, -y * Y, -y], -1)
    LtL = Lx.transpose(1, 2) @ Lx + Ly.transpose(1, 2) @ Ly
    _, V = torch.linalg.eigh(LtL)
    H0 = V[..., 0].reshape(-1, 3, 3)  # eigenvector of the smallest eigenvalue
    B = M.shape[0]
    inv_hnorm = torch.zeros(B, 3, 3, dtype=M.dtype, device=M.device)
    inv_hnorm[:, 0, 0], inv_hnorm[:, 0, 2] = 1.0 / sm[:, 0], cm[:, 0]
    inv_hnorm[:, 1, 1], inv_hnorm[:, 1, 2] = 1.0 / sm[:, 1], cm[:, 1]
    inv_hnorm[:, 2, 2] = 1.0
    hnorm2 = torch.zeros_like(inv_hnorm)
    hnorm2[:, 0, 0], hnorm2[:, 0, 2] = sM[:, 0], -cM[:, 0] * sM[:, 0]
    hnorm2[:, 1, 1], hnorm2[:, 1, 2] = sM[:, 1], -cM[:, 1] * sM[:, 1]
    hnorm2[:, 2, 2] = 1.0
    H = inv_hnorm @ H0 @ hnorm2
    return H / H[:, 2:3, 2:3], ok


def _inliers(src32: torch.Tensor, dst32: torch.Tensor, H: torch.Tensor, thresh: float):
    """computeError + findInliers: float32 squared errors of every match
    under each H (B, 3, 3) -> (inliers (B, N) bool)."""
    Hf = H.reshape(-1, 9)[:, :8].float()
    X, Y = src32[None, :, 0], src32[None, :, 1]
    h = [Hf[:, i:i + 1] for i in range(8)]
    ww = 1.0 / (h[6] * X + h[7] * Y + 1.0)
    dx = (h[0] * X + h[1] * Y + h[2]) * ww - dst32[None, :, 0]
    dy = (h[3] * X + h[4] * Y + h[5]) * ww - dst32[None, :, 1]
    return dx * dx + dy * dy <= np.float32(thresh * thresh)


def _refine_lm(H: torch.Tensor, M: torch.Tensor, m: torch.Tensor, max_iters: int = 10):
    """Levenberg-Marquardt on sum |project(H, M) - m|^2 over the 8 entries
    of H with H[2, 2] = 1 (OpenCV's LMSolver schedule: lambda halves when
    the gain ratio is above 0.75 and grows by nu when below 0.25; stops
    after max_iters or steps and residuals below FLT_EPSILON)."""
    Mx, My = M[:, 0], M[:, 1]

    def compute(h, jac=True):
        ww = h[6] * Mx + h[7] * My + 1.0
        ww = torch.where(ww.abs() > DBL_EPSILON, 1.0 / ww, torch.zeros_like(ww))
        xi = (h[0] * Mx + h[1] * My + h[2]) * ww
        yi = (h[3] * Mx + h[4] * My + h[5]) * ww
        r = torch.stack([xi - m[:, 0], yi - m[:, 1]], 1).reshape(-1)
        if not jac:
            return r, None
        z = torch.zeros_like(Mx)
        jx = torch.stack([Mx * ww, My * ww, ww, z, z, z, -Mx * ww * xi, -My * ww * xi], 1)
        jy = torch.stack([z, z, z, Mx * ww, My * ww, ww, -Mx * ww * yi, -My * ww * yi], 1)
        return r, torch.stack([jx, jy], 1).reshape(-1, 8)

    x = H.reshape(9)[:8].clone()
    r, J = compute(x)
    S = float(r @ r)
    A, v = J.T @ J, J.T @ r
    D = torch.diagonal(A).clone()
    lam, lc = 1.0, 0.75
    for it in range(1, max_iters + 1):
        # a pseudo-inverse, as OpenCV's DECOMP_EIG solve: a singular system
        # (degenerate inliers, lambda 0) takes a bounded step, not an error
        d = torch.linalg.pinv(A + lam * torch.diag(D), hermitian=True) @ v
        xd = x - d
        rd, _ = compute(xd, jac=False)
        Sd = float(rd @ rd)
        dS = float(d @ (2.0 * v - A @ d))
        R = (S - Sd) / (dS if abs(dS) > DBL_EPSILON else 1.0)
        if R > 0.75:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif R < 0.25:
            t = float(d @ v)
            nu = min(max((Sd - S) / (t if abs(t) > DBL_EPSILON else 1.0) + 2.0, 2.0), 10.0)
            if lam == 0.0:
                inv_diag = torch.linalg.pinv(A, hermitian=True).diagonal().abs().max()
                lam = lc = 1.0 / max(DBL_EPSILON, float(inv_diag))
                nu *= 0.5
            lam *= nu
        if Sd < S:
            S, x = Sd, xd
            r, J = compute(x)
            A, v = J.T @ J, J.T @ r
        if not (it < max_iters and float(d.abs().max()) >= FLT_EPSILON
                and float(r.abs().max()) >= FLT_EPSILON):
            break
    return torch.cat([x, x.new_ones(1)]).reshape(3, 3)


def find_homography_ransac(src, dst, thresh: float, max_iters: int = 3000,
                           confidence: float = 0.995, generator: torch.Generator | None = None):
    """`cv2.findHomography(src, dst, cv2.RANSAC, thresh, maxIters=max_iters,
    confidence=confidence)`: H mapping src to dst.

    src, dst: (N, 2) matches (tensors on any device, or arrays), taken as
    float32 as OpenCV does. Returns (H, inliers): H a (3, 3) float64 numpy
    array with H[2, 2] = 1, or None where no model was found; inliers the
    (N,) bool tensor of the refined H's inliers, on the points' device.
    The minimal sets are drawn from `generator` (a CPU torch.Generator;
    seed 0 unless given, so that each call, as OpenCV's, repeats)."""
    src32 = torch.as_tensor(src).float().reshape(-1, 2)
    dst32 = torch.as_tensor(dst).float().reshape(-1, 2).to(src32.device)
    dev, n = src32.device, src32.shape[0]
    none = (None, torch.zeros(n, dtype=torch.bool, device=dev))
    if n < 4:
        return none
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if thresh <= 0:
        thresh = 3.0  # OpenCV's default reprojection threshold
    src64, dst64 = src32.double(), dst32.double()

    if n == 4:  # OpenCV fits the four points and refines nothing
        H, ok = _dlt(src64[None], dst64[None])
        if not bool(ok[0]):
            return none
        return H[0].cpu().numpy(), torch.ones(n, dtype=torch.bool, device=dev)

    niters, it, max_good, invalid_run = max(max_iters, 1), 0, 0, 0
    best_H, best_mask = None, None
    done = False
    while not done:
        idx = torch.randint(0, n, (BATCH, 4), generator=generator)
        srt = idx.sort(1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1).to(dev)
        idx = idx.to(dev)
        ms1, ms2 = src64[idx], dst64[idx]
        valid = distinct & _subset_ok(ms1, ms2)
        H, ok = _dlt(ms1, ms2)
        inl = _inliers(src32, dst32, H, thresh)
        counts = inl.sum(1)
        valid_h, ok_h, counts_h = valid.cpu().numpy(), ok.cpu().numpy(), counts.cpu().numpy()
        for b in range(BATCH):
            if not valid_h[b]:
                invalid_run += 1
                if invalid_run >= MAX_SUBSET_ATTEMPTS:  # getSubset gave up
                    done = True
                    break
                continue
            invalid_run = 0
            if it >= niters:
                done = True
                break
            it += 1
            if ok_h[b] and counts_h[b] > max(max_good, 3):
                max_good = int(counts_h[b])
                best_H, best_mask = H[b], inl[b]
                niters = _update_num_iters(confidence, (n - max_good) / n, 4, niters)
    if max_good <= 0:
        return none

    M, m = src64[best_mask], dst64[best_mask]
    H, ok = _dlt(M[None], m[None])
    H = H[0] if bool(ok[0]) else best_H
    H = _refine_lm(H, M, m)
    H = H / H[2, 2]
    return H.cpu().numpy(), _inliers(src32, dst32, H[None], thresh)[0]


def warp_perspective(img: torch.Tensor, H, dsize) -> torch.Tensor:
    """`cv2.warpPerspective(img, H, dsize)` with its defaults: img (h, w, C)
    float32 on any device, H (3, 3) mapping source to output pixels,
    dsize = (width, height). out(x, y) = img at inv(H) (x, y, 1), bilinear,
    taps outside the image 0."""
    Wo, Ho = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    dev = img.device
    Minv = torch.as_tensor(np.linalg.inv(np.asarray(H, np.float64)), device=dev)
    ys, xs = torch.meshgrid(torch.arange(Ho, dtype=torch.float64, device=dev),
                            torch.arange(Wo, dtype=torch.float64, device=dev), indexing="ij")
    X = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]
    Y = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]
    Wd = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    far = float(2 * (w + h + 2))  # off the image, as OpenCV's saturation puts it
    behind = Wd == 0
    Wd = torch.where(behind, torch.ones_like(Wd), Wd)
    sx = torch.where(behind, -far, torch.clamp(X / Wd, -far, far))
    sy = torch.where(behind, -far, torch.clamp(Y / Wd, -far, far))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).float()[..., None], (sy - y0).float()[..., None]
    x0, y0 = x0.long(), y0.long()
    src = img.float()

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = src[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return v * inside[..., None]

    return (tap(y0, x0) * ((1 - fy) * (1 - fx)) + tap(y0, x0 + 1) * ((1 - fy) * fx)
            + tap(y0 + 1, x0) * (fy * (1 - fx)) + tap(y0 + 1, x0 + 1) * (fy * fx))
