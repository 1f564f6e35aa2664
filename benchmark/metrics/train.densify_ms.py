"""Host-clock ms of the trainer's densification (`Trainer._densify`) per
call, the card synchronised at its entry and exit, over the traced run's
window: the mean of its calls."""


def read(ctx):
    ms = ctx.get("densify_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
