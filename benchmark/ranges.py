"""The program's own ranges and counters over the profiled block, and the
block's idle time put down to them.

The program (`binocular3dgs_torch.tracing`) records its ranges and counters
while a profiler traces, so the traced run's profiled block holds them. The
block runs from the first start to the last end of its device events
(`ctx["trace"]["events"]`); its records are the ranges that start in it and
the counters stamped from its start to the end of the last of those ranges
(densification counts after its last read, when the card is done).

An idle gap is an interval of the block in which no device event runs: the
complement, within the block, of the union that `busy_s` measures. It is
put down to the range that was innermost-open when the gap ended: the
latest-started range, on any thread, with start_ns <= gap end < end_ns.
The host was inside that range when it launched the operation the card
waited for. A gap that ends in no range is unattributed. A range's name
gives its layer first (`render.*`, `step.*`, `trainer.*`).

Where the program records no range in the block (a program without
`tracing`, a run without a trace), the readers read None.
"""

from __future__ import annotations

import heapq
from collections import defaultdict


def block(ctx) -> dict | None:
    """The profiled block's `ranges` and `counters` (tracing.snapshot's
    records), or None where the program recorded no range in it."""
    tr = ctx.get("trace")
    if not tr or not tr.get("events"):
        return None
    try:
        from binocular3dgs_torch import tracing
    except ImportError:  # a program without ranges
        return None
    events = tr["events"]
    t0, t1 = events[0][0], max(f for _, f, _ in events)
    snap = tracing.snapshot()
    ranges = [r for r in snap["ranges"] if t0 <= r["start_ns"] <= t1]
    if not ranges:
        return None
    end = max(t1, max(r["end_ns"] for r in ranges))
    return dict(ranges=ranges, counters=[c for c in snap["counters"] if t0 <= c["t_ns"] <= end])


def idle_gaps(events) -> list:
    """(start_ns, end_ns) of the idle intervals between the first start and
    the last end of `events` ((start_ns, end_ns, name), in order of start)."""
    out, edge = [], None
    for s, f, _ in events:
        if edge is not None and s > edge:
            out.append((edge, s))
        edge = f if edge is None else max(edge, f)
    return out


def idle_by_range(events, ranges) -> dict:
    """Idle ns per range name (None: unattributed), each gap of `events` put
    down to the range of `ranges` innermost-open at its end."""
    order = sorted(ranges, key=lambda r: r["start_ns"])
    open_, k, out = [], 0, defaultdict(int)  # open_: a heap of (-start, end, name)
    for s, e in idle_gaps(events):
        while k < len(order) and order[k]["start_ns"] <= e:
            r = order[k]
            heapq.heappush(open_, (-r["start_ns"], r["end_ns"], r["name"]))
            k += 1
        while open_ and open_[0][1] <= e:  # gap ends only grow: a closed range stays closed
            heapq.heappop(open_)
        out[open_[0][2] if open_ else None] += e - s
    return dict(out)


def layer_idle_ms(ctx, layer: str):
    """Idle ms per iteration of an unprofiled block put down to `layer`'s
    ranges: the layer's share of the profiled block's idle time times the
    unprofiled block's idle time (window_s / blocks - busy_s, as
    train.device_idle scales it, so the profiler's host cost stays out),
    over the iterations of a block."""
    b = block(ctx)
    if b is None or not ctx.get("blocks"):
        return None
    tr = ctx["trace"]
    by_name = idle_by_range(tr["events"], b["ranges"])
    total = sum(by_name.values())
    if total <= 0:
        return None
    mine = sum(ns for name, ns in by_name.items()
               if name is not None and name.split(".")[0] == layer)
    idle_s = ctx["window_s"] / ctx["blocks"] - tr["busy_s"]
    return 1e3 * mine / total * idle_s / ctx["iterations_per_block"]
