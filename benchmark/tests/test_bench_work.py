"""The yardstick's counts on hand-sized cases."""

import pytest
import torch

from benchmark import work

TS = 16


def one_tile(records):
    """Records (10, P) of one 16x16 tile holding all P pairs."""
    P = records.shape[1]
    return (records, torch.tensor([0], dtype=torch.int32),
            torch.tensor([P], dtype=torch.int32), 1, 1, TS)


def pairs(opacities, a=1e-6, depth=2.0):
    """Splats centred on the tile, so broad (conic a = c = `a`) that alpha
    is the opacity (clamped at 0.99) at every pixel."""
    P = len(opacities)
    r = torch.zeros(10, P)
    r[0], r[1] = 7.5, 7.5
    r[2], r[4] = a, a
    r[5] = torch.tensor(opacities)
    r[6:9] = 0.5
    r[9] = depth
    return r


def n_contrib(records):
    from benchmark import reference as ref

    args = one_tile(records)
    return ref.blend_forward(*args)[1]


def test_one_broad_pair_blends_every_pixel():
    rec = pairs([0.5])
    nc = n_contrib(rec)
    assert int(nc.min()) == int(nc.max()) == 1
    read, evals, hits, killed = work.forward_work(*one_tile(rec)[:3], nc, 1, 1, TS)
    assert (read, evals, hits, killed) == (1, 256, 256, 0)
    walked, evals_b, hits_b = work.backward_work(*one_tile(rec)[:3], nc, 1, 1, TS)
    assert (walked, evals_b, hits_b) == (1, 256, 256)


def test_opaque_pairs_terminate_at_the_second():
    """An alpha clamped at 0.99 leaves T = 0.01 (float32: just under), and a
    second would take T below 1e-4: each pixel blends one pair and
    terminates on the second, which is read and evaluated but not blended;
    the third is never read."""
    rec = pairs([0.999, 0.999, 0.999])
    nc = n_contrib(rec)
    assert int(nc.min()) == int(nc.max()) == 1
    read, evals, hits, killed = work.forward_work(*one_tile(rec)[:3], nc, 1, 1, TS)
    assert (read, evals, hits, killed) == (2, 2 * 256, 2 * 256, 256)
    walked, evals_b, hits_b = work.backward_work(*one_tile(rec)[:3], nc, 1, 1, TS)
    assert (walked, evals_b, hits_b) == (1, 256, 256)


def test_the_blend_backward_bound():
    rec = pairs([0.5])
    out = dict(records=rec, tile_start=torch.tensor([0], dtype=torch.int32),
               tile_count=torch.tensor([1], dtype=torch.int32), n_contrib=n_contrib(rec),
               grid=(1, 1, TS))
    bytes_ = 80 * 1 + 28 * 256 + 8 * 1
    instr = (16 + 55) * 256
    assert work.blend_backward_bound_ms(out) == pytest.approx(
        max(bytes_ / 3.35e12, instr / 33.5e12) * 1e3, rel=1e-12)
    assert work.kernel_bound(bytes_, instr)[1] == "bytes"
    assert work.kernel_bound(1, 1e9)[1] == "operations"


def test_the_iteration_count():
    """Two renders of each view on average, SSIM's six separable blurs of 3
    channels (three forward, their three input gradients) at 2 x 2 x 11
    operations a pixel, the per-pixel terms and the optimiser over the
    active gaussians."""
    got = work.iteration_flops([100.0, 300.0], 10, 20, 7, 23)
    want = 2 * 200.0 + (6 * 3 * 44 + work.PIXEL_FLOPS) * 200 + 7 * (16 * 23 + 15)
    assert got == pytest.approx(want, rel=1e-12)
    assert work.SSIM_CONV_FLOPS_PER_PIXEL == 792
