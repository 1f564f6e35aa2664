"""Dense optical flow by Farneback's polynomial expansion, as OpenCV computes it.

The JAX package's `FarnebackMatcher` calls `cv2.calcOpticalFlowFarneback`
(`binocular3dgs_tpu/init/matchers.py:36-40`); the port imports no `cv2`
and rebuilds OpenCV's CPU algorithm (`modules/video/src/optflowgf.cpp`,
flags 0) in torch, on the device of its input:

  * pyramid: levels are cut while either side times the scale is under 32
    pixels; each level blurs the full-size float image by a Gaussian of
    sigma (1/scale - 1)/2 and size max(round(5 sigma) | 1, 3) with
    reflect-101 borders (at level 0 OpenCV's fixed [1/4, 1/2, 1/4]), then
    resizes it linearly (`image_io.resize_linear_f32`)
  * the coarser level's flow is resized linearly and divided by pyr_scale;
    the coarsest starts at zero
  * polynomial expansion (FarnebackPolyExp): a separable Gaussian-weighted
    least-squares fit of the 6 coefficients with replicated borders, the
    vertical pass in float32, the horizontal one in float64
  * update matrices (FarnebackUpdateMatrices): the second image's
    coefficients sampled bilinearly at the displaced position (0 outside
    the image), the quadratic terms averaged with the first image's, the
    5 pixels nearest each border down-weighted by {0.14, 0.14, 0.4472,
    0.4472, 0.4472}
  * flow update (FarnebackUpdateFlow_Blur): a winsize box filter of the 5
    matrix planes with replicated borders in float64, the 2x2 solve with
    1/(g11 g22 - g12^2 + 1e-3), the matrices recomputed from the new flow
    after every iteration but the last

It differs from OpenCV in the order of its float sums only;
`tests/test_torch_init_farneback.py` holds it against cv2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .image_io import resize_linear_f32

MIN_SIZE = 32
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def _cv_round(x: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(np.rint(x))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) as float32 for sigma > 0, and
    OpenCV's fixed table for size 3 at sigma 0 (the pyramid's level 0)."""
    if sigma <= 0:
        if ksize != 3:
            raise ValueError(f"sigma <= 0 is carried for size 3 only, not {ksize}")
        return np.array([0.25, 0.5, 0.25], np.float32)
    x = np.arange(ksize) - (ksize - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur of a float32 (H, W) plane with reflect-101 borders."""
    k = torch.from_numpy(gaussian_kernel(ksize, sigma)).to(img.device)
    r = ksize // 2
    x = F.pad(img[None, None], (r, r, r, r), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return F.conv2d(x, k.reshape(1, 1, -1, 1))[0, 0]


def _poly_gaussian(n: int, sigma: float):
    """FarnebackPrepareGaussian: the float32 tables g, x g, x^2 g over
    [-n, n] and the entries (ig11, ig03, ig33, ig55) of the inverse of the
    6x6 moment matrix, in float64."""
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma)).astype(np.float32)
    g = (g * (1.0 / g.astype(np.float64).sum())).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    yy, xx = np.meshgrid(x, x, indexing="ij")
    gg = (gy * gx).astype(np.float32)
    G = np.zeros((6, 6))
    G[0, 0] = gg.astype(np.float64).sum()
    G[1, 1] = (gg * xx * xx).astype(np.float32).astype(np.float64).sum()
    G[3, 3] = (gg * xx * xx * xx * xx).astype(np.float32).astype(np.float64).sum()
    G[5, 5] = (gg * xx * xx * yy * yy).astype(np.float32).astype(np.float64).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """FarnebackPolyExp of a float32 (H, W) plane: (5, H, W) float32
    coefficients (y, x, yy, xx, xy), replicated borders."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_gaussian(n, sigma)
    H, W = img.shape
    src = F.pad(img[None, None], (0, 0, n, n), mode="replicate")[0, 0]  # (H + 2n, W)

    def rows(k):
        return src[n + k:n + k + H]

    # vertical pass, float32, in OpenCV's order
    r0 = rows(0) * float(g[n])
    r1 = torch.zeros_like(r0)
    r2 = torch.zeros_like(r0)
    for k in range(1, n + 1):
        lo, hi = rows(-k), rows(k)
        p = lo + hi
        r0 = r0 + float(g[n + k]) * p
        r1 = r1 + float(xg[n + k]) * (hi - lo)
        r2 = r2 + float(xxg[n + k]) * p
    # horizontal pass, float64
    row = F.pad(torch.stack([r0, r1, r2])[None], (n, n, 0, 0), mode="replicate")[0].double()

    def cols(k):
        return row[:, :, n + k:n + k + W]

    c = cols(0)
    b1, b3, b5 = c[0] * float(g[n]), c[1] * float(g[n]), c[2] * float(g[n])
    b2 = b4 = b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        lo, hi = cols(-k), cols(k)
        tg = hi[0] + lo[0]
        b1 = b1 + tg * float(g[n + k])
        b4 = b4 + tg * float(xxg[n + k])
        b2 = b2 + (hi[0] - lo[0]) * float(xg[n + k])
        b3 = b3 + (hi[1] + lo[1]) * float(g[n + k])
        b6 = b6 + (hi[1] - lo[1]) * float(xg[n + k])
        b5 = b5 + (hi[2] + lo[2]) * float(g[n + k])
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
                        b6 * ig55]).float()


def _border_scale(n: int, device):
    """Two (n,) float32 factors of each row's or column's weight: the border
    table over the first 5 and over the last 5, 1 elsewhere (OpenCV
    multiplies the x factors, then the y ones)."""
    lo, hi = np.ones(n, np.float32), np.ones(n, np.float32)
    for i, b in enumerate(_BORDER[:n]):
        lo[i] = hi[n - 1 - i] = b
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: (5, H, W) float32 planes (G11, G12, G22,
    h1, h2) from the coefficients of both images and the flow (2, H, W)."""
    _, H, W = R0.shape
    dev = R0.device
    dx, dy = flow[0], flow[1]
    fx = torch.arange(W, device=dev, dtype=torch.float32)[None, :] + dx
    fy = torch.arange(H, device=dev, dtype=torch.float32)[:, None] + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    xi = torch.clamp(x1, 0, W - 2).long()
    yi = torch.clamp(y1, 0, H - 2).long()
    a00, a01 = (1.0 - fx) * (1.0 - fy), fx * (1.0 - fy)
    a10, a11 = (1.0 - fx) * fy, fx * fy
    flat = R1.reshape(5, H * W)
    i00 = (yi * W + xi).reshape(-1)

    def tap(i):
        return flat[:, i].reshape(5, H, W)

    r = a00 * tap(i00) + a01 * tap(i00 + 1) + a10 * tap(i00 + W) + a11 * tap(i00 + W + 1)
    r2 = torch.where(inside, r[0], 0.0)
    r3 = torch.where(inside, r[1], 0.0)
    r4 = torch.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = torch.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = torch.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    lo_x, hi_x = _border_scale(W, dev)
    lo_y, hi_y = _border_scale(H, dev)
    scale = (lo_x * hi_x)[None, :] * lo_y[:, None] * hi_y[:, None]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3])


def update_flow_blur(M: torch.Tensor, block_size: int) -> torch.Tensor:
    """FarnebackUpdateFlow_Blur's solve: the box mean of the matrix planes
    over block_size^2 pixels (replicated borders, float64), then the flow
    (2, H, W) float32 from blur(G) flow = blur(h)."""
    m = block_size // 2
    x = F.pad(M.double()[None], (m, m, m, m), mode="replicate")
    x = F.avg_pool2d(x, (block_size, 1), stride=1)
    g11, g12, g22, h1, h2 = F.avg_pool2d(x, (1, block_size), stride=1)[0]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet]).float()


def calc_optical_flow_farneback(prev: torch.Tensor, nxt: torch.Tensor, pyr_scale: float = 0.5,
                                levels: int = 5, winsize: int = 21, iterations: int = 5,
                                poly_n: int = 7, poly_sigma: float = 1.5) -> torch.Tensor:
    """`cv2.calcOpticalFlowFarneback(prev, nxt, None, pyr_scale, levels,
    winsize, iterations, poly_n, poly_sigma, 0)` of two (H, W) uint8
    tensors: the (H, W, 2) float32 flow from `prev` to `nxt`, on their
    device."""
    H, W = prev.shape
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if W * scale < MIN_SIZE or H * scale < MIN_SIZE:
            levels = k
            break
    images = [prev.float(), nxt.float()]
    flow = None
    for k in range(levels, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(_cv_round(sigma * 5) | 1, 3)
        width, height = _cv_round(W * scale), _cv_round(H * scale)
        if flow is None:
            flow = torch.zeros(2, height, width, device=prev.device)
        else:
            flow = resize_linear_f32(flow, (width, height)) * (1.0 / pyr_scale)
        R = [poly_exp(resize_linear_f32(gaussian_blur(im, ksize, sigma)[None],
                                        (width, height))[0], poly_n, poly_sigma)
             for im in images]
        M = update_matrices(R[0], R[1], flow)
        for i in range(iterations):
            flow = update_flow_blur(M, winsize)
            if i < iterations - 1:
                M = update_matrices(R[0], R[1], flow)
    return flow.permute(1, 2, 0).contiguous()
