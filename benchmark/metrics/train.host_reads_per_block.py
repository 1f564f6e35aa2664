"""Reads of device values by the trainer and densification in the profiled
block (the program's counter `trainer.host_reads`): an exact count."""

from benchmark.ranges import block


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    return sum(c["value"] for c in b["counters"] if c["name"] == "trainer.host_reads")
