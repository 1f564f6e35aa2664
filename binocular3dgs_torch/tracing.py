"""The port's ranges and counters.

A range is a named interval of host time (`region`), a counter a named
value at an instant (`count`). Names give the layer first: `trainer.*`
(train/loop.py, densification), `step.*` (train/step.py, the warp's and
SSIM's backward), `render.*` (ops/rasterize.py, the blend's and the vertex
stage's backward), `loss.*` (ops/losses.py: the values SSIM's kernel
blurs) and `kernel.*` (the hand-written kernels' launches).

The recorder is on exactly while a `torch.profiler` session traces: it
tests the flag that the profiler sets around its trace
(`torch.autograd.profiler._is_profiler_enabled`, one module attribute that
every thread reads, autograd's device thread included). Off, a range or a
counter costs that test and nothing else. On, a range enters
`torch.profiler.record_function` (so it shows in the profiler's chrome
trace) and is kept, when it ends, in a bounded buffer with its thread, its
start and end in nanoseconds of `time.time_ns()` (the clock the profiler
stamps device events with), its parent range on the same thread and its
attributes; a counter is kept with its time, thread and the range open on
its thread. Neither launches device work, reads a device value or changes
what the program computes: a device-valued counter holds a reference to a
0-d tensor that the program computes anyway, and `snapshot` reads all of
them at once, after the fact.

Each buffer holds the newest `CAPACITY` records, so a long profiled run
does not grow it without limit; a reader picks its records by time.

The kernels' launch totals (`launched`, `launches`) count whether or not
the recorder is on; `ops/cuda_build.launch` counts every launch.
"""

from __future__ import annotations

import bisect
import collections
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18

# (id, name, thread, start_ns, end_ns, parent id, attrs), appended when a range ends
_ranges: collections.deque = collections.deque(maxlen=CAPACITY)
# [name, value, t_ns, thread, open range id]; a tensor value becomes a number in snapshot()
_counters: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count()
_local = threading.local()
_launches: collections.Counter = collections.Counter()


def enabled() -> bool:
    """Whether a profiler is tracing, and so the recorder is on."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class region:
    """A range named `name`, with attributes `attrs` (numbers or strings):
    `with region("render.bin"):`, or `@region("render.blend.backward")` on
    a function."""

    __slots__ = ("name", "attrs", "_open")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs, self._open = name, attrs, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            stack = _stack()
            rid = next(_ids)
            self._open = (rf, rid, stack[-1] if stack else None, time.time_ns())
            stack.append(rid)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            end = time.time_ns()
            rf, rid, parent, start = self._open
            self._open = None
            _stack().pop()
            _ranges.append((rid, self.name, threading.get_ident(), start, end, parent,
                            self.attrs))
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with region(name, **attrs):
                return fn(*args, **kwargs)

        return traced


def count(name: str, value) -> None:
    """A counter reading: `value` is a host int or a 0-d tensor that the
    program has computed already (never a view into a larger buffer)."""
    if _profiler._is_profiler_enabled:
        stack = _stack()
        _counters.append([name, value, time.time_ns(), threading.get_ident(),
                          stack[-1] if stack else None])


def launched(kernel: str) -> None:
    """One launch of the hand-written kernel `kernel`, counted into its
    total always and as `kernel.<kernel>.launches` while the recorder is
    on."""
    _launches[kernel] += 1
    count(f"kernel.{kernel}.launches", 1)


def launches() -> collections.Counter:
    """The launches of each kernel in this process so far (0 for a kernel
    never launched)."""
    return collections.Counter(_launches)


def _resolve(counters: list) -> None:
    """Replace the tensor values of `counters` by numbers: one read per
    device."""
    by_device = collections.defaultdict(list)
    for c in counters:
        if isinstance(c[1], torch.Tensor):
            by_device[c[1].device].append(c)
    for group in by_device.values():
        values = torch.stack([c[1].detach().reshape(()).to(torch.float64)
                              for c in group]).tolist()
        for c, v in zip(group, values):
            c[1] = v if c[1].is_floating_point() else int(v)


def snapshot(since_ns: int = 0) -> dict:
    """The ranges and counters recorded so far that start at or after
    `since_ns`, each in order of time:
    `ranges` as dicts of `name`, `thread`, `start_ns`, `end_ns`, `parent`
    (the index in `ranges` of the range that was open on the same thread
    when it started, None if none or no longer held), `attrs` and
    `iteration`; `counters` as dicts of `name`, `value` (a number),
    `t_ns`, `thread`, `range` (the index of the range open on its thread)
    and `iteration`. A record's `iteration` is its own `iteration`
    attribute, else that of the range with one (the trainer's steps, which
    follow each other) whose interval holds the record's start, on any
    thread (a step's ranges on autograd's device thread included), else
    None."""
    raw_ranges = sorted((r for r in _ranges if r[3] >= since_ns), key=lambda r: (r[3], r[0]))
    raw_counters = sorted((c for c in _counters if c[2] >= since_ns), key=lambda c: c[2])
    _resolve(raw_counters)
    index = {r[0]: i for i, r in enumerate(raw_ranges)}
    stepped = [(r[3], r[4], r[6]["iteration"]) for r in raw_ranges if "iteration" in r[6]]
    starts = [s for s, _, _ in stepped]

    def iteration_at(t):
        # the ranges with an iteration (the trainer's steps) follow each other
        k = bisect.bisect_right(starts, t) - 1
        return stepped[k][2] if k >= 0 and t < stepped[k][1] else None

    ranges = [dict(name=r[1], thread=r[2], start_ns=r[3], end_ns=r[4],
                   parent=index.get(r[5]), attrs=dict(r[6]),
                   iteration=r[6].get("iteration", iteration_at(r[3])))
              for r in raw_ranges]
    counters = [dict(name=c[0], value=c[1], t_ns=c[2], thread=c[3], range=index.get(c[4]),
                     iteration=iteration_at(c[2]))
                for c in raw_counters]
    return dict(ranges=ranges, counters=counters)
