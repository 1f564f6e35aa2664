"""Device idle time per iteration put down to the step's own ranges
(`step.*`: the losses, the warp's backward, autograd's backward and the
update with Adam) where no render range is open inside them: their share
of the profiled block's idle time, scaled to the unprofiled block's idle
time and divided by the block's iterations (benchmark/ranges.py)."""

from benchmark.ranges import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, "step")
