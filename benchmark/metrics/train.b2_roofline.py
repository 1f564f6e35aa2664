"""B2 (the blend backward kernel) against its roofline: its bound for the
two renders of the block's first iteration, counted on the start state
(work.blend_backward_bound_ms), over the device time of those two launches
in the profiled block, the block's first two of the kernel."""

from benchmark.trace import first_durations_s

KERNEL = "blend_backward_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("b2_bound_ms"):
        return None
    b2_s = first_durations_s(tr["events"], KERNEL, 2)
    if len(b2_s) != 2:
        return None
    return 100.0 * ctx["b2_bound_ms"] / (1e3 * sum(b2_s))
