"""Reading a profiled block: the device timeline of `torch.profiler`.

The block is profiled with the CUDA activity alone (kernels, copies and
sets on the device, and the runtime calls that launched them), so the host
pays little per launch. Device events are stamped in nanoseconds of
`time.time_ns()`, the clock that bounds the block.
"""

from __future__ import annotations

from collections import defaultdict


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def device_events(prof, t0: int, t1: int, device_type=None) -> list:
    """(start_ns, end_ns, name) of the events on `device_type` (by default
    the CUDA device: its kernels, copies and sets; user annotations left
    out) that overlap [t0, t1], clipped to it, in order of start."""
    from torch.autograd import DeviceType

    device_type = DeviceType.CUDA if device_type is None else device_type
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != device_type or e.is_user_annotation():
            continue
        s, f = _span_ns(e)
        if f > t0 and s < t1:
            out.append((max(s, t0), min(f, t1), e.name()))
    out.sort()
    return out


def summarize(events: list, t0: int, t1: int, top: int = 10) -> dict:
    """busy_s (the union of the events' intervals), window_s, launches, the
    device time per operation name (the `top` largest) and the idle time
    per name of the operation that ends each gap, "(end)" for the block's
    tail (the `top` largest): the host's work before that launch."""
    busy, gaps = 0, defaultdict(int)
    cur_s = cur_f = None
    edge = t0
    for s, f, name in events:
        if cur_f is None or s > cur_f:
            if cur_f is not None:
                busy += cur_f - cur_s
                edge = cur_f
            if s > edge:
                gaps[name[:160]] += s - edge
            cur_s, cur_f = s, f
        else:
            cur_f = max(cur_f, f)
    if cur_f is not None:
        busy += cur_f - cur_s
        edge = cur_f
    if t1 > edge:
        gaps["(end)"] += t1 - edge
    per_op = defaultdict(int)
    for s, f, name in events:
        per_op[name[:160]] += f - s
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9, launches=len(events),
                device_ops=[[name, ns / 1e9] for name, ns in ops],
                idle_gaps=[[name, ns / 1e9] for name, ns in idle])


def first_durations_s(events: list, fragment: str, n: int) -> list:
    """Durations, in seconds, of the first `n` events whose name holds
    `fragment`."""
    return [(f - s) / 1e9 for s, f, name in events if fragment in name][:n]
