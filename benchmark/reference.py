"""The plain reference of one binocular training step, in plain PyTorch.

It imports torch, numpy and the standard library only: nothing of the
program under test. Each stage is a frozen copy of the program's plain
stages as they stood when the benchmark was written (projection, binning,
the record gathers, the tile blend and its backward, the losses, the warp,
masked Adam with opacity decay, densification), so a later change to the
program cannot move its own yardstick. It serves three purposes:

  * the ground-truth images of a scene (`render` under no_grad),
  * the first steps of a training cell, followed from the cell's inputs
    (`train_step`), and densification from a given state (`densify`),
  * the per-render counts the roofline and the FLOP count read (`render`
    returns the blend's records, tile ranges and `n_contrib`).

`tf32=True` computes every matrix product and convolution with its inputs
rounded to TF32 (10 mantissa bits, round to nearest), as a card does with
TF32 on: the control that the comparison deciding `correct` must reject.
The reference itself runs with TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
FILL = {"scaling": -20.0}  # inactive rows render to nothing

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
ALPHA_CLAMP = 0.99
ONE_MINUS_FLOOR = 1.0 - ALPHA_CLAMP
LIVE_ROWS = 10

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
SSIM_WINDOW, SSIM_SIGMA, SSIM_C1, SSIM_C2 = 11, 1.5, 0.01**2, 0.03**2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199


def fp32_only():
    """TF32 off for matmuls and cuDNN: the reference computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- precision --------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 (10 explicit mantissa bits, nearest, ties away
    from zero), passing gradients straight through."""
    d = x.detach().contiguous()
    bits = (d.view(torch.int32) + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - d)


def matmul(a, b, tf32: bool = False):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


# -- cameras ----------------------------------------------------------------

@dataclass
class Cam:
    """A pinhole camera in the row-vector convention: p_view = [p, 1] @
    world_view, p_clip = [p, 1] @ full_proj; float32 tensors on one device."""

    world_view: torch.Tensor
    proj: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)


def make_cam(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float, width: int, height: int,
             device, znear: float = 0.01, zfar: float = 100.0) -> Cam:
    """Camera from a camera-to-world rotation `R` and a world-to-camera
    translation `T` (COLMAP's convention), built in float64 on the host."""
    w2c = np.eye(4)
    w2c[:3, :3] = np.asarray(R, np.float64).T
    w2c[:3, 3] = T
    tx, ty = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1.0 / tx, 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    world_view, proj = w2c.T, P.T
    full_proj = world_view @ proj
    center = np.linalg.inv(world_view)[3, :3]

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return Cam(t(world_view), t(proj), t(full_proj), t(center), t(tx), t(ty), int(width),
               int(height), float(znear), float(zfar))


def shift_cam(cam: Cam, trans: float, tf32: bool = False) -> Cam:
    """The camera moved by `trans` along its own x axis, orientation kept,
    rebuilt in float32 on the camera's device."""
    dev = cam.world_view.device
    d = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    M = cam.world_view.T
    Rw2c = M[:3, :3]
    x_axis = matmul(Rw2c.T, torch.tensor([1.0, 0.0, 0.0], device=dev), tf32)
    center = cam.cam_center + d * x_axis
    new_M = M.clone()
    new_M[:3, 3] = -matmul(Rw2c, center, tf32)
    wv = new_M.T.contiguous()
    return Cam(wv, cam.proj, matmul(wv, cam.proj, tf32), center, cam.tanfovx, cam.tanfovy,
               cam.width, cam.height, cam.znear, cam.zfar)


# -- vertex stage -----------------------------------------------------------

def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH of degree 0 or 1 at unit `dirs`; sh (..., C, K)."""
    if deg not in (0, 1):
        raise ValueError(f"the reference evaluates SH degree 0 or 1, not {deg}")
    result = SH_C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = result - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
    return result


def cov3d(scaling, rotation):
    q = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R00, R01, R02 = 1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)
    R10, R11, R12 = 2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)
    R20, R21, R22 = 2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)
    s0, s1, s2 = scaling[..., 0], scaling[..., 1], scaling[..., 2]
    a0, a1, a2 = s0 * s0, s1 * s1, s2 * s2
    return torch.stack([
        R00 * R00 * a0 + R01 * R01 * a1 + R02 * R02 * a2,
        R00 * R10 * a0 + R01 * R11 * a1 + R02 * R12 * a2,
        R00 * R20 * a0 + R01 * R21 * a1 + R02 * R22 * a2,
        R10 * R10 * a0 + R11 * R11 * a1 + R12 * R12 * a2,
        R10 * R20 * a0 + R11 * R21 * a1 + R12 * R22 * a2,
        R20 * R20 * a0 + R21 * R21 * a1 + R22 * R22 * a2,
    ], dim=-1)


def ewa_cov2d(xyz, c3, cam: Cam, dilation, valid, tf32):
    Wm = cam.world_view.T[:3, :3]
    t = matmul(torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1), cam.world_view,
               tf32)[..., :3]
    tx = torch.where(valid, t[..., 0], 0.0)
    ty = torch.where(valid, t[..., 1], 0.0)
    tz = torch.where(valid, t[..., 2], 1.0)
    fx = cam.width / (2.0 * cam.tanfovx)
    fy = cam.height / (2.0 * cam.tanfovy)
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    txtz = torch.clamp(tx / tz, -limx, limx) * tz
    tytz = torch.clamp(ty / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * txtz * inv_z2
    j11, j12 = fy * inv_z, -fy * tytz * inv_z2
    T00, T01, T02 = (j00 * Wm[0, k] + j02 * Wm[2, k] for k in range(3))
    T10, T11, T12 = (j11 * Wm[1, k] + j12 * Wm[2, k] for k in range(3))
    cxx, cxy, cxz, cyy, cyz, czz = (c3[..., k] for k in range(6))
    U00 = T00 * cxx + T01 * cxy + T02 * cxz
    U01 = T00 * cxy + T01 * cyy + T02 * cyz
    U02 = T00 * cxz + T01 * cyz + T02 * czz
    U10 = T10 * cxx + T11 * cxy + T12 * cxz
    U11 = T10 * cxy + T11 * cyy + T12 * cyz
    U12 = T10 * cxz + T11 * cyz + T12 * czz
    return torch.stack([
        U00 * T00 + U01 * T01 + U02 * T02 + dilation,
        U10 * T00 + U11 * T01 + U12 * T02,
        U10 * T10 + U11 * T11 + U12 * T12 + dilation,
    ], dim=-1)


def project(params: dict, active, cam: Cam, sh_degree: int, dilation: float, znear_cull: float,
            carrier=None, tf32: bool = False) -> dict:
    """The vertex stage over every row: pixel centre, depth, conic, colour,
    opacity, radius, visibility and the opacity-aware binning extents."""
    xyz = params["xyz"]
    scaling = torch.exp(params["scaling"])
    opacity = torch.sigmoid(params["opacity"])[..., 0]
    feats = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
    xyz1 = torch.cat([xyz, xyz.new_ones((xyz.shape[0], 1))], dim=-1)
    depth = matmul(xyz1, cam.world_view, tf32)[..., 2]
    in_front = depth > znear_cull
    p_hom = matmul(xyz1, cam.full_proj, tf32)
    p_w = 1.0 / (torch.where(in_front, p_hom[..., 3], 1.0) + 1e-7)
    ndc = p_hom[..., :3] * p_w[..., None]
    W, H = cam.width, cam.height
    mean2d = torch.stack([((ndc[..., 0] + 1.0) * W - 1.0) * 0.5,
                          ((ndc[..., 1] + 1.0) * H - 1.0) * 0.5], dim=-1)
    if carrier is not None:
        mean2d = mean2d + carrier * mean2d.new_tensor([0.5 * W, 0.5 * H])
    c2 = ewa_cov2d(xyz, cov3d(scaling, params["rotation"]), cam, dilation, in_front, tf32)
    det = c2[..., 0] * c2[..., 2] - c2[..., 1] * c2[..., 1]
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c2[..., 2] * inv_det, -c2[..., 1] * inv_det, c2[..., 0] * inv_det], -1)
    mid = 0.5 * (c2[..., 0] + c2[..., 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    visible = active & in_front & det_ok
    radius = torch.where(visible, radius, 0.0)
    d_max = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), min=0.0))
    ext = torch.stack([
        torch.minimum(d_max * torch.sqrt(torch.clamp(c2[..., 0], min=0.0)) + 1.0, radius),
        torch.minimum(d_max * torch.sqrt(torch.clamp(c2[..., 2], min=0.0)) + 1.0, radius),
    ], dim=-1)
    bin_extent = torch.where((visible & (d_max > 0.0))[..., None], ext, 0.0)
    mean2d = torch.where(visible[..., None], mean2d, 0.0)
    conic = torch.stack([torch.where(visible, conic[:, i], f)
                         for i, f in enumerate((1.0, 0.0, 1.0))], dim=-1)
    depth = torch.where(visible, depth, 0.0)
    opacity = torch.where(visible, opacity, 0.0)
    dirs = xyz - cam.cam_center
    dirs = dirs / torch.clamp(torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)), min=1e-8)
    color = torch.clamp(eval_sh(sh_degree, feats.transpose(-1, -2), dirs) + 0.5, min=0.0)
    return dict(mean2d=mean2d, depth=depth, conic=conic, color=color, opacity=opacity,
                radius=radius, visible=visible, bin_extent=bin_extent)


# -- binning ----------------------------------------------------------------

def tile_grid(width, height, ts):
    return -(-width // ts), -(-height // ts)


@torch.no_grad()
def bin_pairs(mean2d, extent, depth, width, height, ts, pair_capacity=None) -> dict:
    """(tile, depth rank) pairs sorted by tile then rank, the per-tile
    ranges and the wanted pair count; pairs past `pair_capacity` (emission
    order: depth rank, then the rank's tiles row-major) are dropped. With
    `pair_capacity` None, exactly the wanted pairs are kept."""
    dev = mean2d.device
    TW, TH = tile_grid(width, height, ts)
    num_tiles, n = TW * TH, mean2d.shape[0]
    r_ok = extent.amin(dim=1) > 0
    order = torch.argsort(torch.where(r_ok, depth, torch.inf), stable=True)
    m, e, r_ok = mean2d[order], extent[order], r_ok[order]

    def clip(v, hi):
        return torch.clamp(torch.floor(v), 0, hi).to(torch.int32)

    x0 = clip((m[:, 0] - e[:, 0]) / ts, TW)
    y0 = clip((m[:, 1] - e[:, 1]) / ts, TH)
    x1 = clip((m[:, 0] + e[:, 0] + ts - 1) / ts, TW)
    y1 = clip((m[:, 1] + e[:, 1] + ts - 1) / ts, TH)
    sx, sy = torch.clamp(x1 - x0, min=0), torch.clamp(y1 - y0, min=0)
    count = torch.where(r_ok, sx.long() * sy.long(), 0)
    cum_end = torch.cumsum(count, dim=0)
    num_pairs = cum_end[-1]
    if pair_capacity is None:
        pair_capacity = max(int(num_pairs), 1)
    offsets = cum_end - count
    p = torch.arange(pair_capacity, device=dev, dtype=torch.int64)
    valid = p < num_pairs
    g = torch.clamp(torch.searchsorted(cum_end, p, right=True), max=n - 1)
    span = torch.clamp(sx[g].long(), min=1)
    j = p - offsets[g]
    tile = (y0[g].long() + j // span) * TW + x0[g].long() + j % span
    bits = max((n - 1).bit_length(), 1)
    key, _ = torch.sort(torch.where(valid, (tile << bits) | g, num_tiles << bits))
    tile_s = (key >> bits).to(torch.int32)
    gauss_s = torch.where(tile_s < num_tiles, key & ((1 << bits) - 1), 0).to(torch.int32)
    starts = torch.searchsorted(tile_s, torch.arange(num_tiles + 1, device=dev,
                                                     dtype=torch.int32), out_int32=True)
    return dict(pair_gauss=gauss_s, pair_tile=tile_s, tile_start=starts[:-1].contiguous(),
                tile_count=(starts[1:] - starts[:-1]).contiguous(),
                num_pairs=num_pairs, order=order, capacity=pair_capacity)


class _Gather(torch.autograd.Function):
    """fields[:, index]; the backward sums each column's cotangents in pair
    order (a stable sort by column, then one sequential segment sum)."""

    @staticmethod
    def forward(ctx, fields, index):
        ctx.save_for_backward(index)
        ctx.n = fields.shape[1]
        return torch.index_select(fields, 1, index)

    @staticmethod
    def backward(ctx, d):
        (index,) = ctx.saved_tensors
        s, perm = torch.sort(index, stable=True)
        offsets = torch.searchsorted(s, torch.arange(ctx.n + 1, device=index.device,
                                                     dtype=index.dtype))
        rows = torch.index_select(d.T, 0, perm)
        return torch.segment_reduce(rows, "sum", offsets=offsets, axis=0, unsafe=True).T, None


# -- tile blend -------------------------------------------------------------

def tile_pixels(TW, TH, ts, device):
    t = torch.arange(TW * TH, device=device)
    s = torch.arange(ts * ts, device=device)
    px = (t % TW)[:, None] * ts + (s % ts)[None, :]
    py = (t // TW)[:, None] * ts + (s // ts)[None, :]
    return px.float(), py.float()


def splat(rec, px, py):
    """(dx, dy, G, alpha) of the records `rec (>= 6, T, C)` at pixels
    `px, py (T, S)`, each (T, S, C); alpha 0 where the pair is skipped."""
    dx = rec[0][:, None, :] - px[:, :, None]
    dy = rec[1][:, None, :] - py[:, :, None]
    a, b, c = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp(rec[5][:, None, :] * G, max=ALPHA_CLAMP)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    return dx, dy, G, alpha


@torch.no_grad()
def blend_forward(records, tile_start, tile_count, TW, TH, ts, chunk=32):
    """Front-to-back composite per tile in chunks of pairs: the (5, T, S)
    planes r, g, b, depth, T_final and n_contrib (T, S)."""
    dev = records.device
    T, S, P = TW * TH, ts * ts, records.shape[1]
    px, py = tile_pixels(TW, TH, ts, dev)
    start, count = tile_start.long(), tile_count.long()
    T_run = torch.ones(T, S, device=dev)
    done = torch.zeros(T, S, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, T, S, device=dev)
    n_contrib = torch.zeros(T, S, dtype=torch.int32, device=dev)
    for c0 in range(0, int(count.max()) if T else 0, chunk):
        k = c0 + torch.arange(chunk, device=dev)
        valid = k[None, :] < count[:, None]
        rec = records[:LIVE_ROWS, torch.clamp(start[:, None] + k[None, :], 0, max(P - 1, 0))]
        alpha = splat(rec, px, py)[3]
        alpha = torch.where(~valid[:, None, :] | done[..., None], 0.0, alpha)
        one_minus = 1.0 - alpha
        T_incl_raw = T_run[..., None] * torch.cumprod(one_minus, dim=-1)
        T_before_raw = torch.cat([T_run[..., None], T_incl_raw[..., :-1]], dim=-1)
        killed = torch.cumsum((T_before_raw * one_minus < T_MIN).to(torch.int32), dim=-1,
                              dtype=torch.int32) > 0
        a_eff = torch.where(killed, 0.0, alpha)
        T_incl = T_run[..., None] * torch.cumprod(1.0 - a_eff, dim=-1)
        T_before = torch.cat([T_run[..., None], T_incl[..., :-1]], dim=-1)
        w = a_eff * T_before
        col = torch.cat([rec[6:9], torch.where(valid, rec[9], 0.0)[None]])
        acc += (w[None] * col[:, :, None, :]).sum(-1)
        n_new = torch.where(a_eff > 0.0, (k + 1).to(torch.int32), 0).amax(dim=-1)
        n_contrib = torch.maximum(n_contrib, n_new)
        T_run = T_incl[..., -1]
        done = done | killed[..., -1]
        if bool(done.all()):
            break
    return torch.cat([acc, T_run[None]]), n_contrib


@torch.no_grad()
def blend_backward(records, tile_start, tile_count, out5, n_contrib, d_out5, TW, TH, ts,
                   chunk=32):
    """The composite's cotangents per pair (10 rows), each tile walked back
    to front from its largest n_contrib, the transmittance rebuilt by
    division from T_final."""
    dev = records.device
    T, S, P = TW * TH, ts * ts, records.shape[1]
    px, py = tile_pixels(TW, TH, ts, dev)
    start, nc = tile_start.long(), n_contrib.long()
    T_final, D4 = out5[4], d_out5[:4]
    tfd = d_out5[4] * T_final
    d_records = torch.zeros_like(records)
    n_walk = torch.minimum(nc.amax(dim=1), tile_count.long()) if T else nc.new_zeros(0)
    T_run = T_final.clone()
    suf = torch.zeros(T, S, device=dev)
    for c0 in reversed(range(0, int(n_walk.max()) if T else 0, chunk)):
        k = c0 + torch.arange(chunk, device=dev)
        valid = k[None, :] < n_walk[:, None]
        idx = torch.clamp(start[:, None] + k[None, :], 0, max(P - 1, 0))
        rec = records[:LIVE_ROWS, idx]
        dx, dy, G, alpha = splat(rec, px, py)
        keep = valid[:, None, :] & (k[None, None, :] < nc[..., None])
        a = torch.where(keep, alpha, 0.0)
        one_minus = torch.clamp(1.0 - a, min=ONE_MINUS_FLOOR)
        sp = torch.flip(torch.cumprod(torch.flip(one_minus, [-1]), dim=-1), [-1])
        T_i = T_run[..., None] / sp
        w = a * T_i
        r = (D4[0][..., None] * rec[6][:, None, :] + D4[1][..., None] * rec[7][:, None, :]
             + D4[2][..., None] * rec[8][:, None, :] + D4[3][..., None] * rec[9][:, None, :])
        q = w * r
        suf_q = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1])
        after = suf_q - q + suf[..., None]
        d_alpha = T_i * r - (1.0 / one_minus) * (after + tfd[..., None])
        d_alpha = torch.where(keep & (a > 0.0), d_alpha, 0.0)
        d_alpha = torch.where(rec[5][:, None, :] * G <= ALPHA_CLAMP, d_alpha, 0.0)
        d_pow = a * d_alpha
        ca, cb, cc = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
        rows = torch.stack([
            (-(ca * dx + cb * dy) * d_pow).sum(1),
            (-(cc * dy + cb * dx) * d_pow).sum(1),
            (-0.5 * dx * dx * d_pow).sum(1),
            (-dx * dy * d_pow).sum(1),
            (-0.5 * dy * dy * d_pow).sum(1),
            (G * d_alpha).sum(1),
            *((w * D4[i][..., None]).sum(1) for i in range(4)),
        ])
        d_records[:LIVE_ROWS, idx[valid]] = rows[:, valid]
        T_run = T_i[..., 0]
        suf = suf + q.sum(-1)
    return d_records


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, records, tile_start, tile_count, TW, TH, ts):
        out5, nc = blend_forward(records, tile_start, tile_count, TW, TH, ts)
        ctx.mark_non_differentiable(nc)
        ctx.save_for_backward(records, tile_start, tile_count, out5, nc)
        ctx.grid = (TW, TH, ts)
        return out5, nc

    @staticmethod
    def backward(ctx, d_out5, _):
        return (blend_backward(*ctx.saved_tensors, d_out5.contiguous(), *ctx.grid),
                None, None, None, None, None)


def render(cam: Cam, params: dict, active, sh_degree: int, bg, raster: dict, carrier=None,
           pair_capacity=None, tf32: bool = False) -> dict:
    """project -> bin -> gather -> blend -> planes. `raster` holds
    tile_size, dilation and znear_cull. Differentiable in `params` and
    `carrier`; also returns the blend's inputs and `n_contrib`."""
    ts = raster["tile_size"]
    W, H = cam.width, cam.height
    TW, TH = tile_grid(W, H, ts)
    pr = project(params, active, cam, sh_degree, raster["dilation"], raster["znear_cull"],
                 carrier, tf32)
    b = bin_pairs(pr["mean2d"], pr["bin_extent"], pr["depth"], W, H, ts, pair_capacity)
    fields = torch.stack([pr["mean2d"][:, 0], pr["mean2d"][:, 1], pr["conic"][:, 0],
                          pr["conic"][:, 1], pr["conic"][:, 2], pr["opacity"],
                          pr["color"][:, 0], pr["color"][:, 1], pr["color"][:, 2],
                          pr["depth"]], dim=0)
    fields_d = torch.index_select(fields, 1, b["order"])
    spread = torch.arange(b["capacity"], device=fields.device, dtype=torch.int32) % fields.shape[1]
    index = torch.where(b["pair_tile"] < TW * TH, b["pair_gauss"], spread)
    records = _Gather.apply(fields_d, index)
    out5, nc = _Blend.apply(records, b["tile_start"], b["tile_count"], TW, TH, ts)
    K = out5.shape[0]
    planes = out5.reshape(K, TH, TW, ts, ts).permute(0, 1, 3, 2, 4).reshape(
        K, TH * ts, TW * ts)[:, :H, :W]
    bg = torch.as_tensor(bg, dtype=torch.float32, device=planes.device)
    return dict(image=planes[0:3] + planes[4][None] * bg[:, None, None], depth=planes[3],
                alpha=1.0 - planes[4], radii=pr["radius"], visible=pr["radius"] > 0,
                num_pairs=b["num_pairs"], records=records.detach(),
                tile_start=b["tile_start"], tile_count=b["tile_count"], n_contrib=nc,
                grid=(TW, TH, ts))


# -- losses and the warp ----------------------------------------------------

def l1(pred, gt, mask=None):
    if mask is not None:
        return torch.mean(torch.abs(pred * mask - gt * mask))
    return torch.mean(torch.abs(pred - gt))


def ssim(img1, img2, tf32: bool = False):
    """Window-11 sigma-1.5 SSIM with zero padding, of (C, H, W) images."""
    img1, img2 = img1[None], img2[None]
    C = img1.shape[1]
    xs = torch.arange(SSIM_WINDOW, dtype=torch.float32, device=img1.device) - SSIM_WINDOW // 2
    g = torch.exp(-(xs**2) / (2.0 * SSIM_SIGMA**2))
    g = g / torch.sum(g)
    window = (g[:, None] * g[None, :]).expand(C, 1, SSIM_WINDOW, SSIM_WINDOW).contiguous()
    if tf32:
        window = tf32_round(window)

    def blur(x):
        return F.conv2d(tf32_round(x) if tf32 else x, window, padding=SSIM_WINDOW // 2,
                        groups=C)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu1_mu2
    m = ((2 * mu1_mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (s1 + s2 + SSIM_C2))
    return m.mean()


def smooth(disparity, image):
    ex_im = 0.5 * (image[:, 1:-1, 2:] - image[:, 1:-1, :-2]).sum(dim=0)
    ey_im = 0.5 * (image[:, 2:, 1:-1] - image[:, :-2, 1:-1]).sum(dim=0)
    ex_d = 0.5 * (disparity[1:-1, 2:] - disparity[1:-1, :-2])
    ey_d = 0.5 * (disparity[2:, 1:-1] - disparity[:-2, 1:-1])
    return (torch.mean(torch.abs(torch.exp(-0.33 * torch.abs(ex_im)) * ex_d))
            + torch.mean(torch.abs(torch.exp(-0.33 * torch.abs(ey_im)) * ey_d)))


def warp(image, disparity):
    """out(r, c) = (1 - w) image[r, c + x0] + w image[r, c + x0 + 1] with
    x0 = floor(d), w = d - x0, zero where either column is outside; the
    gradient reaches the disparity through w only."""
    C, H, W = image.shape
    x0 = torch.floor(disparity)
    c0 = torch.arange(W, device=image.device)[None, :] + x0.long()
    valid = (c0 >= 0) & (c0 + 1 < W)
    w1 = disparity - x0
    i0 = torch.clamp(c0, 0, W - 1)[None].expand(C, H, W)
    i1 = torch.clamp(c0 + 1, 0, W - 1)[None].expand(C, H, W)
    out = (1.0 - w1)[None] * torch.gather(image, 2, i0) + w1[None] * torch.gather(image, 2, i1)
    return torch.where(valid[None], out, 0.0), valid.to(torch.float32)


# -- the step ---------------------------------------------------------------

def xyz_lr(opt: dict, spatial_lr_scale: float, step: int) -> float:
    """The position learning rate's log-linear decay with its delay easing
    (reference `utils/general_utils.py:29`; no delay steps)."""
    lr_init = opt["position_lr_init"] * spatial_lr_scale
    lr_final = opt["position_lr_final"] * spatial_lr_scale
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def group_lrs(opt: dict, lr_xyz: float) -> dict:
    return dict(xyz=lr_xyz, f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
                opacity=opt["opacity_lr"], scaling=opt["scaling_lr"],
                rotation=opt["rotation_lr"])


@torch.no_grad()
def adam(params, grads, m, v, step, lrs, active, tf32=False):
    """One masked Adam step in place (bias-corrected, eps after the square
    root); returns the new step count."""
    t = step + 1
    b1t = 1.0 - float(np.float32(ADAM_B1) ** np.float32(t))
    b2t = 1.0 - float(np.float32(ADAM_B2) ** np.float32(t))
    for n in PARAM_NAMES:
        p, g = params[n], grads[n]
        mask = active.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(mask, g, 0.0)
        m[n].mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
        v[n].mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
        new = p - lrs[n] * (m[n] / b1t) / (torch.sqrt(v[n] / b2t) + ADAM_EPS)
        p.copy_(torch.where(mask, new, p))
    return t


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def train_step(state: dict, cam: Cam, gt, alpha_weight, iteration: int, trans: float, bg,
               settings: dict, tf32: bool = False) -> dict:
    """One binocular step on `state` (params, active, m, v, adam_step,
    grad_accum, denom, max_radii2d, sh_degree, spatial_lr_scale,
    pair_capacity), updated in place. `settings` holds the configuration's
    `opt`, `train` and `raster` groups. Returns the step's losses, the
    gradients as the optimiser gets them and the wanted pairs."""
    opt, tr, raster = settings["opt"], settings["train"], settings["raster"]
    params, active = state["params"], state["active"]
    leaves = {n: params[n].detach().requires_grad_(True) for n in PARAM_NAMES}
    carrier = torch.zeros(active.shape[0], 2, device=active.device, requires_grad=True)
    out = render(cam, leaves, active, state["sh_degree"], bg, raster, carrier,
                 state["pair_capacity"], tf32)
    lam = opt["lambda_dssim"]
    loss = (1.0 - lam) * l1(out["image"], gt) + lam * (1.0 - ssim(out["image"], gt, tf32))
    out_s = render(shift_cam(cam, trans, tf32), leaves, active, state["sh_degree"], bg, raster,
                   None, state["pair_capacity"], tf32)
    disparity = cam.focal_x * (-trans) / (out["depth"] + 1e-5)
    warped, mask = warp(out_s["image"], disparity)
    disp_loss = l1(warped, gt, mask=mask) + 0.05 * smooth(disparity * mask, gt)
    alpha_loss = torch.zeros((), device=gt.device)
    if alpha_weight is not None:
        alpha_loss = torch.mean(torch.abs(out["alpha"]) * alpha_weight)
    total = loss + disp_loss + alpha_loss
    grads = torch.autograd.grad(total, [*leaves.values(), carrier], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip([*leaves.values(), carrier], grads)]
    g_params = dict(zip(PARAM_NAMES, grads[:-1]))
    decay = tr["opacity_decay"]
    with torch.no_grad():
        if decay and iteration > opt["densify_from_iter"]:
            opa = torch.sigmoid(params["opacity"]) * tr["opacity_decay_factor"]
            params["opacity"].copy_(torch.where(active[:, None], inverse_sigmoid(opa),
                                                params["opacity"]))
        radii, visible = out["radii"], out["radii"] > 0
        if iteration < (opt["iterations"] if decay else opt["densify_until_iter"]):
            gnorm = torch.linalg.norm(grads[-1], dim=-1)
            state["max_radii2d"].copy_(torch.where(visible, torch.maximum(state["max_radii2d"],
                                                                          radii),
                                                   state["max_radii2d"]))
            state["grad_accum"].copy_(torch.where(visible, state["grad_accum"] + gnorm,
                                                  state["grad_accum"]))
            state["denom"].copy_(torch.where(visible, state["denom"] + 1.0, state["denom"]))
        lrs = group_lrs(opt, xyz_lr(opt, state["spatial_lr_scale"], iteration))
        state["adam_step"] = adam(params, g_params, state["m"], state["v"], state["adam_step"],
                                  lrs, active, tf32)
    return dict(loss=loss.detach(), disparity_loss=disp_loss.detach(),
                alpha_loss=alpha_loss.detach(),
                grads={n: torch.where(active.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
                       for n, g in g_params.items()},
                num_pairs=torch.maximum(out["num_pairs"], out_s["num_pairs"]))


# -- densification ----------------------------------------------------------

def quat_to_rotmat(q):
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@torch.no_grad()
def densify(params, active, m, v, grad_accum, denom, grad_threshold, min_opacity, extent,
            percent_dense, noise, tf32=False) -> dict:
    """One clone / split / prune round compacted into the same capacity
    (originals, then clones, then both split children); `noise` is the two
    (cap, 3) standard normal draws of the split children."""
    cap = active.shape[0]
    dev = active.device
    grads = torch.nan_to_num(torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1.0),
                                         0.0), nan=0.0)
    scaling = torch.exp(params["scaling"])
    max_scale = scaling.amax(dim=-1)
    alive = torch.sigmoid(params["opacity"][:, 0]) >= min_opacity
    hot = active & (grads >= grad_threshold)
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)
    masks = [active & ~split & alive, clone & alive, split & alive, split & alive]
    R = quat_to_rotmat(params["rotation"])
    child_scaling = torch.log(torch.clamp(scaling / 1.6, min=1e-30))

    def child(nz):
        off = matmul(R, (nz.to(dev) * scaling)[..., None], tf32)[..., 0]
        return dict(params, xyz=params["xyz"] + off, scaling=child_scaling)

    zero = {n: torch.zeros_like(t) for n, t in params.items()}
    cands = [params, params, child(noise[0]), child(noise[1])]
    mask_cat = torch.cat(masks)
    pos = torch.cumsum(mask_cat.long(), dim=0) - 1
    target = torch.where(mask_cat & (pos < cap), pos, cap)
    n_after = min(int(mask_cat.sum()), cap)
    new_active = torch.arange(cap, device=dev) < n_after

    def scatter(blocks, sentinels):
        out = {}
        for n in PARAM_NAMES:
            cat = torch.cat([b[n] for b in blocks])
            base = cat.new_full((cap + 1,) + cat.shape[1:],
                                FILL.get(n, 0.0) if sentinels else 0.0)
            if sentinels and n == "rotation":
                base[:, 0] = 1.0
            base[target] = cat
            out[n] = base[:cap]
            if not sentinels:
                out[n] = torch.where(new_active.reshape((-1,) + (1,) * (cat.ndim - 1)),
                                     out[n], 0.0)
        return out

    return dict(params=scatter(cands, True), m=scatter([m, zero, zero, zero], False),
                v=scatter([v, zero, zero, zero], False), active=new_active, n_after=n_after,
                n_wanted=int(sum(int(k.sum()) for k in masks)))
