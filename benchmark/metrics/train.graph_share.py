"""Share of the profiled block's training steps that ran as one replay of
a CUDA graph: the program's counter `step.graph_replays` (one a replay)
over its `trainer.step` ranges (one a step), in %. Reads None where the
block has no step range, or where the program has no graphed step (no
`tracing.replayed`, as before the graphs came)."""

from benchmark.ranges import block


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    from binocular3dgs_torch import tracing

    if not hasattr(tracing, "replayed"):
        return None
    steps = sum(1 for r in b["ranges"] if r["name"] == "trainer.step")
    if not steps:
        return None
    replays = sum(c["value"] for c in b["counters"] if c["name"] == "step.graph_replays")
    return 100.0 * replays / steps
