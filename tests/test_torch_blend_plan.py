"""The blend kernels' work list on the CPU (ops/blend_cuda.py:
`blend_plan_torch`, the plain mirror of csrc/blend_forward.cu's plan
kernel, and the caps that size the plan, the grids and the scratch): every
pair of a long tile in exactly one chunk item, a tile of at most `chunk`
pairs walked whole, the lists within their caps, and the two counters."""

import pytest
import torch

from binocular3dgs_torch.ops.blend_cuda import (
    PLAN_HEADER, blend_plan, blend_plan_torch, chunk_cap, plan_size,
)


def lists(plan, T):
    """(first chunk of each tile, chunk items) of a plan buffer."""
    p = plan.plan.tolist()
    o = PLAN_HEADER
    return p[o:o + T], p[o + T:o + T + p[0]]


COUNTS = {
    "short": [0, 5, 177, 0, 256, 1],
    "long": [0, 257, 3000, 2883, 256, 512, 513, 0, 40],
    "empty": [0, 0, 0],
    "one_long": [10_000],
}


@pytest.mark.parametrize("name", sorted(COUNTS))
@pytest.mark.parametrize("chunk", [128, 256, 384, 512])
def test_every_pair_in_exactly_one_item(name, chunk):
    """A tile of at most `chunk` pairs is walked whole by its own block (no
    chunk item); a longer tile's pairs are its chunk items', in order, each
    once."""
    counts = COUNTS[name]
    T, capacity = len(counts), sum(counts) + 7
    plan = blend_plan_torch(torch.tensor(counts, dtype=torch.int32), capacity, chunk)
    assert plan.plan.dtype == torch.int32
    assert plan.plan.shape == (plan_size(T, capacity, chunk),)
    first, items = lists(plan, T)
    assert len(items) <= chunk_cap(T, capacity, chunk)
    covered = {t: [] for t in range(T)}
    for k, t in enumerate(items):
        c = k - first[t]
        lo, hi = c * chunk, min(counts[t], (c + 1) * chunk)
        assert first[t] >= 0 and hi > lo  # a chunk holds at least one pair
        covered[t].extend(range(lo, hi))
    for t in range(T):
        if counts[t] <= chunk:
            assert first[t] == -1 and not covered[t]
        else:
            assert covered[t] == list(range(counts[t])), t  # once each, in order
    assert items == sorted(items)  # tile by tile, in tile order
    assert int(plan.chunks) == sum(max(1, -(-c // chunk)) for c in counts if c > 0)
    assert int(plan.longest_walk) == max(min(c, chunk) for c in counts)


def test_the_caps_hold_at_the_capacity():
    """Tiles that fill the capacity exactly, each one pair past a chunk
    boundary (the most items a capacity can give) stay within the caps."""
    chunk, T = 256, 50
    counts = [chunk + 1] * T
    plan = blend_plan_torch(torch.tensor(counts, dtype=torch.int32), sum(counts), chunk)
    assert int(plan.plan[0]) == 2 * T <= chunk_cap(T, sum(counts), chunk)


def test_the_kernel_plan_of_a_cpu_tensor_is_refused():
    with pytest.raises(ValueError, match="on a card"):
        blend_plan(torch.tensor([3, 700, 0], dtype=torch.int32), 1000)


@pytest.mark.parametrize("chunk", [0, 100, -128])
def test_a_chunk_off_the_staging_batch_is_refused(chunk):
    with pytest.raises(ValueError, match="multiple of 128"):
        blend_plan_torch(torch.tensor([1], dtype=torch.int32), 10, chunk)
