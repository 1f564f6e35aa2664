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

`blend_forward` launches the forward kernels (csrc/blend_forward.cu) for
CUDA tensors and runs `blend_forward_torch` for CPU tensors; its autograd
backward does the same with csrc/blend_backward.cu and
`blend_backward_torch`. On a CUDA tensor a wrapper launches or raises, it
never falls back. Kernels and plain versions compute alpha through one
expression each (`splat_eval` in csrc/blend_common.cuh, `_splat` here),
so the backward gates pairs exactly as the forward did.

The kernels walk work items, not tiles: a tile of at most `BLEND_CHUNK`
pairs is one item, walked whole as the kernels always walked a tile; a
longer tile is split into chunks of `BLEND_CHUNK` pairs, one item each,
each blended from T = 1 and then from the transmittance the earlier chunks
leave, and combined in chunk order (`blend_plan` lists the items on the
device; `blend_plan_torch` is its plain mirror). The forward keeps each
chunk's boundary state (`BlendState`) for the backward, which walks every
item's pairs once, in one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from .cuda_build import launch

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
ALPHA_CLAMP = 0.99
LIVE_ROWS = 10
KERNEL_TILE_SIZE = 16

# 1 - ALPHA_CLAMP as float32 (0.01f): the floor of 1 - alpha when the
# backward divides the transmittance back (blend.py: one_minus)
ONE_MINUS_FLOOR = 1.0 - ALPHA_CLAMP

# pairs of a long tile's work item (csrc/blend_forward.cu's design note has
# the sweep that chose it); a multiple of the kernels' staging batch, so
# that every chunk but a tile's last is whole batches
BLEND_CHUNK = 256
KERNEL_BATCH = 128
PLAN_HEADER = 1  # csrc/blend_common.cuh: kPlanHeader
SCRATCH_PLANES = 7  # csrc/blend_common.cuh: kScratchPlanes

def chunk_cap(num_tiles: int, capacity: int, chunk: int) -> int:
    """The chunk items that a plan of `num_tiles` tiles over a pair
    capacity `capacity` can hold (csrc/blend_common.cuh): the counts sum to
    at most the capacity, and a long tile of c > chunk pairs is fewer than
    c / chunk + 1 chunks, so at most ceil(capacity / chunk) + min(num_tiles,
    ceil(capacity / chunk))."""
    p = -(-capacity // chunk)
    return p + min(num_tiles, p)


def plan_size(num_tiles: int, capacity: int, chunk: int) -> int:
    """int32 entries of a plan (csrc/blend_common.cuh's layout)."""
    return PLAN_HEADER + 2 * num_tiles + chunk_cap(num_tiles, capacity, chunk)


class BlendPlan(NamedTuple):
    chunk: int
    plan: torch.Tensor  # int32 work list, csrc/blend_common.cuh's layout
    chunks: torch.Tensor  # () int32 work items that walk at least one pair
    longest_walk: torch.Tensor  # () int32 the most pairs one item walks


class BlendState(NamedTuple):
    """The forward kernels' plan and the long tiles' boundary state, for the
    backward: `scratch` (SCRATCH_PLANES, chunk items cap, 256) float32."""

    plan: BlendPlan
    scratch: torch.Tensor


def _check_chunk(chunk: int) -> None:
    if chunk <= 0 or chunk % KERNEL_BATCH:
        raise ValueError(f"the blend's chunk must be a positive multiple of {KERNEL_BATCH}, "
                         f"got {chunk}")


def blend_plan_torch(tile_count: torch.Tensor, capacity: int, chunk: int) -> BlendPlan:
    """The plain mirror of the plan kernel (csrc/blend_forward.cu:
    blend_plan_kernel): the same int32 buffer, the list's unused tail 0
    where the kernel leaves it unwritten."""
    _check_chunk(chunk)
    dev = tile_count.device
    T = tile_count.shape[0]
    cap = chunk_cap(T, capacity, chunk)
    c = tile_count.long()
    n = torch.where(c > chunk, (c - 1) // chunk + 1, 1)
    n_long = torch.where(n > 1, n, 0)
    first = torch.where(n > 1, torch.cumsum(n_long, 0) - n_long, -1)
    items = torch.repeat_interleave(torch.arange(T, device=dev), n_long)
    plan = torch.zeros(plan_size(T, capacity, chunk), dtype=torch.int64, device=dev)
    plan[0] = min(items.numel(), cap)
    plan[PLAN_HEADER:PLAN_HEADER + T] = first
    o = PLAN_HEADER + T
    plan[o:o + min(items.numel(), cap)] = items[:cap]
    chunks = n[c > 0].sum()
    longest = c.clamp(max=chunk).max() if T else c.new_zeros(())
    return BlendPlan(chunk, plan.to(torch.int32), chunks.to(torch.int32),
                     longest.to(torch.int32))


def blend_plan(tile_count: torch.Tensor, capacity: int, chunk: int | None = None) -> BlendPlan:
    """The work items of the blend kernels for tiles of `tile_count` pairs
    (a CUDA tensor) and the pair capacity `capacity` (the records'
    columns), in chunks of `chunk` pairs (default `BLEND_CHUNK`): one
    kernel, reading no count on the host. The plain blend on the CPU walks
    no items; `blend_plan_torch` is the kernel's mirror for the tests."""
    chunk = BLEND_CHUNK if chunk is None else chunk
    if tile_count.dtype != torch.int32 or tile_count.ndim != 1 or not tile_count.is_cuda:
        raise ValueError(f"tile_count must be (T,) int32 on a card, got "
                         f"{tuple(tile_count.shape)} {tile_count.dtype} on {tile_count.device}")
    _check_chunk(chunk)
    _check_kernel_inputs("blend_plan", KERNEL_TILE_SIZE, tile_count=tile_count)
    T = tile_count.shape[0]
    new = tile_count.new_empty
    plan = BlendPlan(chunk, new(plan_size(T, capacity, chunk)), new(()), new(()))
    launch("b3dgs_blend_plan", tile_count.device, tile_count, T, capacity, chunk, plan.plan,
           plan.chunks, plan.longest_walk)
    return plan


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


def _alpha_extent(rec: torch.Tensor):
    """(rx, ry): the conservative half-extents, in pixels, of the box around
    each pair's mean outside which `_splat`'s alpha is 0, from the float32
    rows 0-5 (mean x, y, conic a, b, c, opacity) of `rec`; inf where
    nothing is culled (mean or conic not finite, conic not clearly positive
    definite), else -1 where the pair never blends (opacity < 1/255), NaN
    where the opacity is NaN. The plain mirror of
    csrc/blend_common.cuh:alpha_extent, with the same formula and margins,
    so that the tests can hold the kernels' cull test against `_splat`; the
    plain versions walk every pair and need no cull."""
    mx, my, a, b, c, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
    inf = float("inf")
    finite = (mx.abs() + my.abs() + a.abs() + b.abs() + c.abs()) < inf
    det = a * c - b * b
    ac = a * c
    k = (2.0 * torch.log(255.0 * op) + 0.01) * (1.01 + 1e-5 * (ac / det))
    unbounded = ~finite | ~(a > 0.0) | ~(det > 1e-4 * ac) | ~(ac < inf)
    never = finite & (op < ALPHA_MIN)
    ext = []
    for num in (c, a):
        r = torch.sqrt(k * num / det) * 1.01 + 1.0
        ext.append(torch.where(never, -1.0, torch.where(unbounded, float("inf"), r)))
    return ext[0], ext[1]


# the kernels' cull cells: cell c of a 16x16 tile is the 8x4 pixels at
# x = 8 * (c // 4) + 0..7, y = 4 * (c % 4) + 0..3 from the tile's corner
CELL_W, CELL_H = 8, 4
CELL_ROWS = KERNEL_TILE_SIZE // CELL_H  # 4
CELLS = KERNEL_TILE_SIZE // CELL_W * CELL_ROWS  # 8


def _pixel_cell(s: torch.Tensor) -> torch.Tensor:
    """The cell of pixel s of a 16x16 tile, at (s % 16, s // 16)."""
    ts = KERNEL_TILE_SIZE
    return (s % ts) // CELL_W * CELL_ROWS + (s // ts) // CELL_H


def _cell_mask(rec: torch.Tensor, tx0: torch.Tensor, ty0: torch.Tensor) -> torch.Tensor:
    """(CELLS, ...) bool: whether each pair of `rec` (rows 0-5, float32) may
    blend a pixel of each cell of the tile whose corner is (tx0, ty0)
    (float32, broadcast against the pairs). False only where the pair's
    `_alpha_extent` box misses the cell's pixel centres, so True in every
    cell where the mean is not finite (infinite extents) or a value is NaN.
    The plain mirror of csrc/blend_common.cuh:cell_mask."""
    rx, ry = _alpha_extent(rec)
    mx, my = rec[0], rec[1]
    cells = []
    for c in range(CELLS):
        x0 = tx0 + CELL_W * (c // CELL_ROWS)
        y0 = ty0 + CELL_H * (c % CELL_ROWS)
        gx = torch.clamp(torch.maximum(x0 - mx, mx - (x0 + (CELL_W - 1))), min=0.0)
        gy = torch.clamp(torch.maximum(y0 - my, my - (y0 + (CELL_H - 1))), min=0.0)
        cells.append(~(gx > rx) & ~(gy > ry))
    return torch.stack(cells)


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


def blend_forward_cuda(records, tile_start, tile_count, TW, TH, ts, plan=None):
    """(out5, n_contrib, BlendState) of the forward kernels, without
    autograd: the whole walk of the short tiles with the local walk of the
    long tiles' chunks, then the chunks' walk from T_in with the combine,
    over `plan`'s items (by default `blend_plan`'s for these tiles)."""
    _check_kernel_inputs("blend_forward", ts, records=records, tile_start=tile_start,
                         tile_count=tile_count)
    T, S, P = TW * TH, ts * ts, records.shape[1]
    if plan is None:
        plan = blend_plan(tile_count, P)
    if plan.plan.shape != (plan_size(T, P, plan.chunk),) or plan.plan.device != records.device:
        raise ValueError("blend_forward: the plan is not of these tiles and records")
    dev = records.device
    scratch = torch.empty(SCRATCH_PLANES, chunk_cap(T, P, plan.chunk), S, dtype=torch.float32,
                          device=dev)
    out5 = torch.empty(5, T, S, dtype=torch.float32, device=dev)
    n_contrib = torch.empty(T, S, dtype=torch.int32, device=dev)
    launch("b3dgs_blend_forward", dev, records, P, tile_start, tile_count, TW, T, plan.chunk,
           plan.plan, scratch, out5, n_contrib,
           launches={"blend_forward": 1, "blend_chunk": 1})
    return out5, n_contrib, BlendState(plan, scratch)


def _launch_backward(records, tile_start, tile_count, out5, n_contrib, d_out5, TW, TH, ts, state):
    d_out5 = d_out5.contiguous()
    _check_kernel_inputs("blend_backward", ts, records=records, tile_start=tile_start,
                         tile_count=tile_count, out5=out5, n_contrib=n_contrib)
    T = TW * TH
    if state is None:
        raise ValueError("blend_backward on a card needs the state of the forward kernels that "
                         "gave out5 and n_contrib (blend_forward_cuda)")
    # zeros: the kernel writes only the pairs it walks, each tile's pairs
    # below its largest n_contrib; the rest of the tile's segment must read
    # 0 in the gather backward, which sums every sorted slot below bin_slots
    d_records = torch.zeros_like(records)
    launch("b3dgs_blend_backward", records.device, records, records.shape[1], tile_start,
           tile_count, out5, n_contrib, d_out5, TW, T, state.plan.chunk, state.plan.plan,
           state.scratch, d_records)
    return d_records


def blend_backward(records, tile_start, tile_count, out5, n_contrib, d_out5, TW, TH, ts,
                   state=None):
    """d_records of the tile blend from the forward's inputs and outputs and
    the cotangent `d_out5`: the CUDA kernel for CUDA tensors, from the
    `state` of the forward kernels that gave out5 and n_contrib,
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
                                TW, TH, ts, state)
    if records.device.type == "cpu":
        return blend_backward_torch(records, tile_start, tile_count, out5, n_contrib, d_out5,
                                    TW, TH, ts)
    raise ValueError(f"blend_backward: unsupported device {records.device}")


class _BlendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, records, tile_start, tile_count, TW, TH, ts, plan):
        state = None
        if records.is_cuda:
            out5, n_contrib, state = blend_forward_cuda(records, tile_start, tile_count, TW, TH,
                                                        ts, plan)
        elif records.device.type == "cpu":
            out5, n_contrib = blend_forward_torch(records, tile_start, tile_count, TW, TH, ts)
        else:
            raise ValueError(f"blend_forward: unsupported device {records.device}")
        ctx.mark_non_differentiable(n_contrib)
        ctx.save_for_backward(records, tile_start, tile_count, out5, n_contrib)
        ctx.grid = (TW, TH, ts)
        ctx.state = state
        return out5, n_contrib

    @staticmethod
    @tracing.region("render.blend.backward")
    def backward(ctx, d_out5, d_n_contrib):
        d_records = blend_backward(*ctx.saved_tensors, d_out5, *ctx.grid, state=ctx.state)
        return d_records, None, None, None, None, None, None


def blend_forward(
    records: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    TW: int,
    TH: int,
    ts: int,
    plan: BlendPlan | None = None,
):
    """(out5, n_contrib) of the tile blend: the CUDA kernels for CUDA
    tensors, over `plan`'s work items (by default `blend_plan`'s),
    `blend_forward_torch` for CPU tensors."""
    _check_inputs(records, tile_start, tile_count, TW, TH, ts)
    return _BlendForward.apply(records, tile_start, tile_count, TW, TH, ts, plan)
