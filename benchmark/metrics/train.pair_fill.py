"""Share of the pair slots that binning sorts and gathers which carry a
pair: the sum over the profiled block's renders of min(pairs wanted, pair
capacity) over the sum of their pair capacities, from the program's
counters `render.pairs_wanted` and `render.pair_capacity`, one of each per
render."""

from benchmark.ranges import block


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    wanted = [c["value"] for c in b["counters"] if c["name"] == "render.pairs_wanted"]
    caps = [c["value"] for c in b["counters"] if c["name"] == "render.pair_capacity"]
    if not caps or len(wanted) != len(caps):
        return None
    return 100.0 * sum(min(w, c) for w, c in zip(wanted, caps)) / sum(caps)
