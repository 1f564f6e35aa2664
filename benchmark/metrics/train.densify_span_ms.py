"""Mean host-clock ms of the profiled block's `trainer.densify` ranges (the
program's own range inside `Trainer._densify`). No sync is added: the
span's read before it has drained the card's queue, and densification's
own reads wait for its work."""

from benchmark.ranges import block


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    ms = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in b["ranges"]
          if r["name"] == "trainer.densify"]
    return sum(ms) / len(ms) if ms else None
