"""Tile blend forward and backward: the hand-written CUDA kernels, their
wrappers and their plain PyTorch versions.

Counterpart of `binocular3dgs_tpu/ops/blend_pallas.py`
(`blend_forward_pallas`, `blend_backward_pallas`) and of
`binocular3dgs_tpu/ops/blend.py` (`blend_forward_xla`,
`blend_backward_xla`). Inputs are the field-major record table
`records (R >= 10, P)` float32 (rows 0-1 mx,my; 2-4 conic a,b,c;
5 opacity; 6-8 rgb; 9 depth; further rows are ignored) and the per-tile
pair ranges `tile_start`, `tile_count` (T,) int32. The forward's outputs are
`out5 (5, T, S)` float32 planes r, g, b, depth, T_final and
`n_contrib (T, S)` int32 (index + 1 within the tile's segment of the last
blended pair), S = tile_size**2, pixel s of tile t at
(tx*ts + s % ts, ty*ts + s // ts). The backward maps the cotangent
`d_out5 (5, T, S)` to `d_records (R, P)`: for each pair of a tile's segment
the sums over the tile's pixels of d_mx, d_my, d_a, d_b, d_c, d_op, d_r,
d_g, d_b, d_depth, zero for every other slot and row.

`blend_forward` launches the forward kernel (csrc/blend_forward.cu) for CUDA
tensors and runs `blend_forward_torch` for CPU tensors; its autograd
backward does the same with csrc/blend_backward.cu and
`blend_backward_torch`. On a CUDA tensor a wrapper launches or raises, it
never falls back. Kernels and plain versions compute alpha through one
expression each (`splat_eval` in csrc/blend_common.cuh, `_splat` here),
so the backward gates pairs exactly as the forward did.
"""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
ALPHA_CLAMP = 0.99
LIVE_ROWS = 10
KERNEL_TILE_SIZE = 16

# 1 - ALPHA_CLAMP as float32 (0.01f): the floor of 1 - alpha when the
# backward divides the transmittance back (blend.py: one_minus)
ONE_MINUS_FLOOR = 1.0 - ALPHA_CLAMP

# Launches of each CUDA kernel since the last reset (a wrapper adds one per
# launch and nowhere else). Read and reset by chip_smoke.py.
blend_forward_launches = 0
blend_backward_launches = 0


def _tile_pixel_coords(TW: int, TH: int, ts: int, device):
    t = torch.arange(TW * TH, device=device)
    s = torch.arange(ts * ts, device=device)
    px = (t % TW)[:, None] * ts + (s % ts)[None, :]
    py = (t // TW)[:, None] * ts + (s // ts)[None, :]
    return px.float(), py.float()


def _splat(rec: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(dx, dy, G, alpha) of the chunk records `rec (>= 6, T, C)` at
    the pixels `px, py (T, S)`, each (T, S, C); alpha is 0 where the pair is
    skipped (power > 0 or alpha < 1/255). The one alpha expression of both
    plain versions, in the order of csrc/blend_common.cuh:splat_eval."""
    dx = rec[0][:, None, :] - px[:, :, None]
    dy = rec[1][:, None, :] - py[:, :, None]
    a_, b_, c_ = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
    power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp(rec[5][:, None, :] * G, max=ALPHA_CLAMP)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    return dx, dy, G, alpha


@torch.no_grad()
def blend_forward_torch(
    records: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    TW: int,
    TH: int,
    ts: int,
    chunk: int = 32,
):
    """Plain PyTorch blend: vectorised over (tiles, pixels), looping over
    chunks of `chunk` pairs with the masked cumulative-product chain of
    `blend_forward_xla`. Its (T, S, chunk) float32 temporaries are
    T*S*chunk*4 bytes each (~100 MB at 1008x756 and chunk 32)."""
    dev = records.device
    T, S = TW * TH, ts * ts
    P = records.shape[1]
    px, py = _tile_pixel_coords(TW, TH, ts, dev)
    start = tile_start.long()
    count = tile_count.long()
    T_run = torch.ones(T, S, device=dev)
    done = torch.zeros(T, S, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, T, S, device=dev)
    n_contrib = torch.zeros(T, S, dtype=torch.int32, device=dev)
    max_count = int(count.max()) if T else 0
    for c0 in range(0, max_count, chunk):
        k = c0 + torch.arange(chunk, device=dev)  # (C,)
        valid = k[None, :] < count[:, None]  # (T, C)
        idx = torch.clamp(start[:, None] + k[None, :], 0, max(P - 1, 0))
        rec = records[:LIVE_ROWS, idx]  # (10, T, C)
        alpha = _splat(rec, px, py)[3]  # (T, S, C)
        alpha = torch.where(~valid[:, None, :] | done[..., None], 0.0, alpha)

        # front-to-back chain within the chunk; a pixel stops before the
        # first pair that would take T below T_MIN (the raw chain agrees
        # with the frozen one up to that pair)
        one_minus = 1.0 - alpha
        T_incl_raw = T_run[..., None] * torch.cumprod(one_minus, dim=-1)
        T_before_raw = torch.cat([T_run[..., None], T_incl_raw[..., :-1]], dim=-1)
        kill = (T_before_raw * one_minus < T_MIN).to(torch.int32)
        killed = torch.cumsum(kill, dim=-1, dtype=torch.int32) > 0
        a_eff = torch.where(killed, 0.0, alpha)
        T_incl = T_run[..., None] * torch.cumprod(1.0 - a_eff, dim=-1)
        T_before = torch.cat([T_run[..., None], T_incl[..., :-1]], dim=-1)
        w = a_eff * T_before  # (T, S, C)

        col = torch.cat([rec[6:9], torch.where(valid, rec[9], 0.0)[None]])  # (4, T, C)
        acc += (w[None] * col[:, :, None, :]).sum(-1)
        n_new = torch.where(a_eff > 0.0, (k + 1).to(torch.int32), 0).amax(dim=-1)
        n_contrib = torch.maximum(n_contrib, n_new)
        T_run = T_incl[..., -1]
        done = done | killed[..., -1]
        if bool(done.all()):
            break
    return torch.cat([acc, T_run[None]]), n_contrib


@torch.no_grad()
def blend_backward_torch(
    records: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    out5: torch.Tensor,
    n_contrib: torch.Tensor,
    d_out5: torch.Tensor,
    TW: int,
    TH: int,
    ts: int,
    chunk: int = 32,
) -> torch.Tensor:
    """Plain PyTorch blend backward with the semantics of
    `blend_backward_xla` at the record level: each tile's segment is walked
    back to front in chunks of `chunk` pairs from the tile's largest
    `n_contrib`; the transmittance before each pair is rebuilt by division
    from T_final (1 - alpha floored at 0.01), the d_out-weighted colour
    response is carried as one suffix sum, and the 10 per-pair cotangents
    are summed over the tile's pixels. Returns `d_records` shaped like
    `records`, zero outside the walked pairs."""
    dev = records.device
    T, S = TW * TH, ts * ts
    P = records.shape[1]
    px, py = _tile_pixel_coords(TW, TH, ts, dev)
    start = tile_start.long()
    nc = n_contrib.long()
    T_final = out5[4]
    D4 = d_out5[:4]  # d_r, d_g, d_b, d_depth
    tfd = d_out5[4] * T_final
    d_records = torch.zeros_like(records)
    n_walk = torch.minimum(nc.amax(dim=1), tile_count.long()) if T else nc.new_zeros(0)
    max_walk = int(n_walk.max()) if T else 0
    T_run = T_final.clone()
    suf = torch.zeros(T, S, device=dev)
    for c0 in reversed(range(0, max_walk, chunk)):
        k = c0 + torch.arange(chunk, device=dev)  # (C,)
        valid = k[None, :] < n_walk[:, None]  # (T, C)
        idx = torch.clamp(start[:, None] + k[None, :], 0, max(P - 1, 0))
        rec = records[:LIVE_ROWS, idx]  # (10, T, C)
        dx, dy, G, alpha = _splat(rec, px, py)
        keep = valid[:, None, :] & (k[None, None, :] < nc[..., None])
        a = torch.where(keep, alpha, 0.0)
        one_minus = torch.clamp(1.0 - a, min=ONE_MINUS_FLOOR)
        sp = torch.flip(torch.cumprod(torch.flip(one_minus, [-1]), dim=-1), [-1])
        T_i = T_run[..., None] / sp  # transmittance before each pair
        w = a * T_i
        r = (D4[0][..., None] * rec[6][:, None, :] + D4[1][..., None] * rec[7][:, None, :]
             + D4[2][..., None] * rec[8][:, None, :] + D4[3][..., None] * rec[9][:, None, :])
        q = w * r
        suf_q = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1])
        suffix_after = suf_q - q + suf[..., None]  # sum of q over the later pairs
        inv_om = 1.0 / one_minus
        d_alpha = T_i * r - inv_om * (suffix_after + tfd[..., None])
        d_alpha = torch.where(keep & (a > 0.0), d_alpha, 0.0)
        # alpha = min(0.99, op * G): a clamped alpha passes no gradient
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
        ])  # (10, T, C)
        d_records[:LIVE_ROWS, idx[valid]] = rows[:, valid]
        T_run = T_i[..., 0]
        suf = suf + q.sum(-1)
    return d_records


def _check_inputs(records, tile_start, tile_count, TW, TH, ts):
    if records.dtype != torch.float32 or records.ndim != 2 or records.shape[0] < LIVE_ROWS:
        raise ValueError(f"records must be (>= {LIVE_ROWS}, P) float32, got "
                         f"{tuple(records.shape)} {records.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or x.shape != (TW * TH,):
            raise ValueError(f"{name} must be ({TW * TH},) int32, got {tuple(x.shape)} {x.dtype}")
        if x.device != records.device:
            raise ValueError(f"{name} is on {x.device}, records on {records.device}")
    if ts <= 0 or TW <= 0 or TH <= 0:
        raise ValueError(f"bad tile grid TW={TW} TH={TH} ts={ts}")


def _check_kernel_inputs(name, ts, **tensors):
    if ts != KERNEL_TILE_SIZE:
        raise ValueError(f"the CUDA blend kernels are built for {KERNEL_TILE_SIZE}x"
                         f"{KERNEL_TILE_SIZE} tiles, got tile_size={ts}")
    for arg, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {arg}")


def _launch(records, tile_start, tile_count, TW, TH, ts):
    global blend_forward_launches
    from .cuda_build import load_library

    _check_kernel_inputs("blend_forward", ts, records=records, tile_start=tile_start,
                         tile_count=tile_count)
    T, S = TW * TH, ts * ts
    lib = load_library()
    out5 = torch.empty(5, T, S, dtype=torch.float32, device=records.device)
    n_contrib = torch.empty(T, S, dtype=torch.int32, device=records.device)
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b3dgs_blend_forward(
            records.data_ptr(), records.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
            TW, T, out5.data_ptr(), n_contrib.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: cudaError {err}")
    blend_forward_launches += 1
    return out5, n_contrib


def _launch_backward(records, tile_start, tile_count, out5, n_contrib, d_out5, TW, TH, ts):
    global blend_backward_launches
    from .cuda_build import load_library

    d_out5 = d_out5.contiguous()
    _check_kernel_inputs("blend_backward", ts, records=records, tile_start=tile_start,
                         tile_count=tile_count, out5=out5, n_contrib=n_contrib)
    T = TW * TH
    lib = load_library()
    # zeros: slots outside every walked segment (binning's sentinel slots
    # included, whose cotangents the pair gather adds into depth rank 0)
    # must stay 0; the kernel writes only walked pairs
    d_records = torch.zeros_like(records)
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b3dgs_blend_backward(
            records.data_ptr(), records.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
            out5.data_ptr(), n_contrib.data_ptr(), d_out5.data_ptr(), TW, T,
            d_records.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_backward kernel launch failed: cudaError {err}")
    blend_backward_launches += 1
    return d_records


def blend_backward(records, tile_start, tile_count, out5, n_contrib, d_out5, TW, TH, ts):
    """d_records of the tile blend from the forward's inputs and outputs and
    the cotangent `d_out5`: the CUDA kernel for CUDA tensors,
    `blend_backward_torch` for CPU tensors."""
    _check_inputs(records, tile_start, tile_count, TW, TH, ts)
    T, S = TW * TH, ts * ts
    for name, x, dtype, shape in (("out5", out5, torch.float32, (5, T, S)),
                                  ("n_contrib", n_contrib, torch.int32, (T, S)),
                                  ("d_out5", d_out5, torch.float32, (5, T, S))):
        if x.dtype != dtype or x.shape != shape or x.device != records.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {records.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if records.is_cuda:
        return _launch_backward(records, tile_start, tile_count, out5, n_contrib, d_out5,
                                TW, TH, ts)
    if records.device.type == "cpu":
        return blend_backward_torch(records, tile_start, tile_count, out5, n_contrib, d_out5,
                                    TW, TH, ts)
    raise ValueError(f"blend_backward: unsupported device {records.device}")


class _BlendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, records, tile_start, tile_count, TW, TH, ts):
        if records.is_cuda:
            out5, n_contrib = _launch(records, tile_start, tile_count, TW, TH, ts)
        elif records.device.type == "cpu":
            out5, n_contrib = blend_forward_torch(records, tile_start, tile_count, TW, TH, ts)
        else:
            raise ValueError(f"blend_forward: unsupported device {records.device}")
        ctx.mark_non_differentiable(n_contrib)
        ctx.save_for_backward(records, tile_start, tile_count, out5, n_contrib)
        ctx.grid = (TW, TH, ts)
        return out5, n_contrib

    @staticmethod
    def backward(ctx, d_out5, d_n_contrib):
        d_records = blend_backward(*ctx.saved_tensors, d_out5, *ctx.grid)
        return d_records, None, None, None, None, None


def blend_forward(
    records: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    TW: int,
    TH: int,
    ts: int,
):
    """(out5, n_contrib) of the tile blend: the CUDA kernel for CUDA tensors,
    `blend_forward_torch` for CPU tensors."""
    _check_inputs(records, tile_start, tile_count, TW, TH, ts)
    return _BlendForward.apply(records, tile_start, tile_count, TW, TH, ts)
