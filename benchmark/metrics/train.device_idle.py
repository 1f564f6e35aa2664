"""Share of a block's wall time in which no kernel, copy or set ran on the
device: 1 minus the device's busy time in the profiled block (the union of
their intervals, from the trace) over the mean time of the same run's
unprofiled blocks (window_s / blocks, by the host clock). Every block does
the same work, so the busy time is the unprofiled block's too, and the
profiler's own cost on the host stays out of the share."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or not ctx.get("blocks"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / (ctx["window_s"] / ctx["blocks"]))
