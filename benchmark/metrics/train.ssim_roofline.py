"""SSIM's kernel pair (the forward S1 with its mean, and the backward S2 of
`binocular3dgs_torch/csrc/ssim.cu`) against its roofline: the bound of the
work that SSIM and its gradient need, for the profiled block's first SSIM
call, over the device time of the block's first launch of each of the
pair's three kernels.

The work is what the function needs, counted from the call's size, the
program's counter `loss.ssim_elems` (the pixel-channels of the images,
N * H * W), not from the kernels:

  * bytes: the forward reads the render and the ground truth and writes the
    three partial-derivative maps that the backward needs (20 B a
    pixel-channel); the backward reads the three maps, the render and the
    ground truth and writes the render's gradient (24 B); each input read
    once, each output written once;
  * FP32 instructions (a fused multiply-add counting one, as the card's
    33.5e12 instructions/s do), with the Gaussian window's blurs separable,
    as train.mfu counts them: forward 145 a pixel-channel: the products
    x*x, y*y, x*y (3), the 11 horizontal and 11 vertical taps over the five
    quantities (5 x 22 = 110), the SSIM map (18: three products, three
    differences, two each for the two numerators and the two denominators,
    their products, the division and the sum into the mean) and the three
    derivative maps (14); backward 72: the separable taps over the three
    maps (3 x 22 = 66) and their combination with the images and the
    upstream gradient (6).

The bytes bind at every size: 44 B at 3.35e12 B/s take 13.1 ps a
pixel-channel, 217 instructions at 33.5e12/s 6.5 ps. A kernel that does
more work than this (S1 runs the 11x11 window's 121 taps a quantity, to
round as the plain composition's convolution does) reads lower for it.
Reads None where the block has no such counter or no such kernel (a
program without the fused SSIM)."""

from benchmark.ranges import block
from benchmark.trace import first_durations_s
from benchmark.work import FP32_INSTR_PER_S, HBM_BYTES_PER_S

KERNELS = ("ssim_forward_kernel", "ssim_forward_mean_kernel", "ssim_backward_kernel")
BYTES_PER_ELEM = 20 + 24
INSTR_PER_ELEM = 145 + 72


def bound_ms(elems: int) -> tuple[float, str]:
    """(the pair's bound in ms, which bound binds) for `elems` pixel-channels."""
    bytes_ms = BYTES_PER_ELEM * elems / HBM_BYTES_PER_S * 1e3
    instr_ms = INSTR_PER_ELEM * elems / FP32_INSTR_PER_S * 1e3
    return max(bytes_ms, instr_ms), ("bytes" if bytes_ms >= instr_ms else "operations")


def read(ctx):
    b = block(ctx)
    if b is None:
        return None
    elems = [c["value"] for c in b["counters"] if c["name"] == "loss.ssim_elems"]
    if not elems:
        return None
    durations = [first_durations_s(ctx["trace"]["events"], k, 1) for k in KERNELS]
    if not all(durations):
        return None
    return 100.0 * bound_ms(elems[0])[0] / (1e3 * sum(d[0] for d in durations))
