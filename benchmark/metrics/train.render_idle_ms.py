"""Device idle time per iteration put down to the render's ranges
(`render.*`: the vertex stage, binning, the record gather, the blend, the
planes, and the gather's and blend's backward): their share of the
profiled block's idle time, scaled to the unprofiled block's idle time and
divided by the block's iterations (benchmark/ranges.py)."""

from benchmark.ranges import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, "render")
