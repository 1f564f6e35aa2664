"""Device idle time per iteration put down to the trainer's own ranges
(`trainer.*` self time: the draws, the span's read, pair-capacity growth,
densification and the loop between steps): their share of the profiled
block's idle time, scaled to the unprofiled block's idle time and divided
by the block's iterations (benchmark/ranges.py)."""

from benchmark.ranges import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, "trainer")
