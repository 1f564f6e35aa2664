"""The port's ranges and counters.

A range is a named interval of host time (`region`), a counter a named
value at an instant (`count`). Names give the layer first: `trainer.*`
(train/loop.py, densification), `step.*` (train/step.py with its CUDA
graphs' `step.replay`, `step.graph_replays` and `step.graph_captures`, the
warp's and SSIM's backward), `render.*` (ops/rasterize.py, the blend's and the vertex
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

A CUDA graph's capture runs the program's host code without running its
device work, and a replay runs the device work without the host code. So
while a capture is recorded (`recording`), counters and launches go into
the recording alone, on every thread, recorder on or off; each replay then
gives them again (`replayed`): the launches join the totals, and while the
recorder is on every counter is recorded anew, a device-valued one with a
copy of the value that this replay computed. Ranges are host time and are
not given again: a replay's is the caller's (`step.replay`).
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
_capture = None  # the `recording` open, if any


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
    program has computed already (never a view into a large buffer)."""
    if _capture is not None:
        _capture.counters.append((name, value))
    elif _profiler._is_profiler_enabled:
        stack = _stack()
        _counters.append([name, value, time.time_ns(), threading.get_ident(),
                          stack[-1] if stack else None])


def launched(kernel: str) -> None:
    """One launch of the hand-written kernel `kernel`, counted into its
    total always and as `kernel.<kernel>.launches` while the recorder is
    on; into the open `recording` instead, if there is one."""
    (_launches if _capture is None else _capture.launches)[kernel] += 1
    count(f"kernel.{kernel}.launches", 1)


def launches() -> collections.Counter:
    """The launches of each kernel in this process so far (0 for a kernel
    never launched)."""
    return collections.Counter(_launches)


class recording:
    """`with recording() as rec:` around a CUDA graph's capture: keeps the
    counters (`rec.counters`, (name, value) in order) and kernel launches
    (`rec.launches`) that the captured code gives, on any thread, for
    `replayed` to give at each replay."""

    def __init__(self):
        self.counters: list = []
        self.launches: collections.Counter = collections.Counter()

    def __enter__(self):
        global _capture
        if _capture is not None:
            raise RuntimeError("a capture is being recorded already")
        _capture = self
        return self

    def __exit__(self, *exc):
        global _capture
        _capture = None
        return False


def replayed(rec: recording) -> None:
    """One replay of the graph whose capture `rec` recorded: its launches
    join the totals, and while the recorder is on its counters are counted
    again, the device-valued ones with copies of this replay's values
    (`copies`, taken on the current stream after the replay's launch)."""
    _launches.update(rec.launches)
    if _profiler._is_profiler_enabled:
        values = iter(copies([v for _, v in rec.counters if isinstance(v, torch.Tensor)]))
        for name, value in rec.counters:
            count(name, next(values) if isinstance(value, torch.Tensor) else value)


def copies(tensors: list) -> list:
    """Copies of 0-d tensors, one launch for each dtype among them (a
    `stack`, or a `clone` for a dtype alone), as views of the stacks."""
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    out = [None] * len(tensors)
    for idx in by_dtype.values():
        if len(idx) == 1:
            out[idx[0]] = tensors[idx[0]].clone()
        else:
            stacked = torch.stack([tensors[i] for i in idx])
            for k, i in enumerate(idx):
                out[i] = stacked[k]
    return out


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
