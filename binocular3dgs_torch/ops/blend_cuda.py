"""Tile blend forward: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of the forward half of `binocular3dgs_tpu/ops/blend_pallas.py`
(`blend_forward_pallas`) and of `binocular3dgs_tpu/ops/blend.py`
(`blend_forward_xla`). Inputs are the field-major record table
`records (R >= 10, P)` float32 (rows 0-1 mx,my; 2-4 conic a,b,c;
5 opacity; 6-8 rgb; 9 depth; further rows are ignored) and the per-tile
pair ranges `tile_start`, `tile_count` (T,) int32. Outputs are
`out5 (5, T, S)` float32 planes r, g, b, depth, T_final and
`n_contrib (T, S)` int32 (index + 1 within the tile's segment of the last
blended pair), S = tile_size**2, pixel s of tile t at
(tx*ts + s % ts, ty*ts + s // ts).

`blend_forward` launches the kernel (csrc/blend_forward.cu) for CUDA tensors
and runs `blend_forward_torch` for CPU tensors; on a CUDA tensor it launches
or raises, it never falls back. Forward only: a backward through it raises
until the training slice brings the backward kernel.
"""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
ALPHA_CLAMP = 0.99
LIVE_ROWS = 10
KERNEL_TILE_SIZE = 16

# Launches of the CUDA kernel since the last reset (the wrapper adds one per
# launch and nowhere else). Read and reset by chip_smoke.py.
blend_forward_launches = 0


def _tile_pixel_coords(TW: int, TH: int, ts: int, device):
    t = torch.arange(TW * TH, device=device)
    s = torch.arange(ts * ts, device=device)
    px = (t % TW)[:, None] * ts + (s % ts)[None, :]
    py = (t // TW)[:, None] * ts + (s // ts)[None, :]
    return px.float(), py.float()


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
        dx = rec[0][:, None, :] - px[:, :, None]  # (T, S, C)
        dy = rec[1][:, None, :] - py[:, :, None]
        a_, b_, c_ = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
        power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
        alpha = torch.clamp(rec[5][:, None, :] * torch.exp(power), max=ALPHA_CLAMP)
        skip = (power > 0.0) | (alpha < ALPHA_MIN) | ~valid[:, None, :] | done[..., None]
        alpha = torch.where(skip, 0.0, alpha)

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


def _launch(records, tile_start, tile_count, TW, TH, ts):
    global blend_forward_launches
    from .cuda_build import load_library

    if ts != KERNEL_TILE_SIZE:
        raise ValueError(f"the CUDA blend kernel is built for {KERNEL_TILE_SIZE}x"
                         f"{KERNEL_TILE_SIZE} tiles, got tile_size={ts}")
    if not (records.is_contiguous() and tile_start.is_contiguous() and tile_count.is_contiguous()):
        raise ValueError("blend_forward needs contiguous records, tile_start and tile_count")
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
        return out5, n_contrib

    @staticmethod
    def backward(ctx, d_out5, d_n_contrib):
        raise NotImplementedError("blend backward: training slice")


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
