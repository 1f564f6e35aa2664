"""The training step's useful FP32 operations per second over the traced
run's unprofiled window, as a share of the card's published FP32 peak
(67 TFLOP/s, a multiply-add counting two). The operations are the
benchmark's own count from the start state (work.iteration_flops), the
same whatever computes the step, so within a cell the share is
`train_it_s` times a constant: it reads no time of its own, and bounds
what any kernel's roofline can claim."""

from benchmark.work import FP32_FLOPS_PER_S


def read(ctx):
    if not ctx.get("flops_per_it"):
        return None
    return 100.0 * ctx["flops_per_it"] * ctx["train_it_s"] / FP32_FLOPS_PER_S
