"""Balance of the blend kernels' work over their blocks: 100 x the slots
of the profiled block's first render (`render.bin_slots`) over its work
items that walk a pair (`render.blend_chunks`) times the most pairs one
item walks (`render.blend_longest_walk`), in %: 100 when every item walks
as many pairs as the longest, low when a few long items hold the launch.
Reads None where the program records no such counters (a program whose
blend walks one block a tile, or the plain blend on the CPU)."""

from benchmark.ranges import block

NAMES = ("render.bin_slots", "render.blend_chunks", "render.blend_longest_walk")


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    first = {}
    for c in b["counters"]:
        if c["name"] in NAMES and c["name"] not in first:
            first[c["name"]] = c["value"]
    if len(first) != len(NAMES):
        return None
    slots, chunks, longest = (first[n] for n in NAMES)
    if not chunks or not longest:
        return None
    return 100.0 * slots / (chunks * longest)
