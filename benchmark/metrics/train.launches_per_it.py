"""Kernel launches, copies and sets on the device in one profiled block,
per training iteration of the block: an exact count."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["launches"] == 0:
        return None
    return tr["launches"] / ctx["iterations_per_block"]
