"""Port tile binning against the JAX bin_gaussians: every integer output
must be equal (scenes with distinct depths, so the depth order is unique)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.ops.binning import bin_gaussians as jax_bin_gaussians
from binocular3dgs_torch.ops.binning import bin_gaussians, tile_grid

FIELDS = ("order", "pair_gauss", "pair_tile", "tile_start", "tile_count", "rank_offsets",
          "num_pairs")


def _inputs(seed, n, w, h, extents, zero_frac=0.2):
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-12, max(w, h) + 12, (n, 2)).astype(np.float32)
    shape = (n, 2) if extents else (n,)
    radius = np.round(rng.uniform(0, 25, shape)).astype(np.float32)
    radius[rng.random(n) < zero_frac] = 0.0  # culled rows
    depth = rng.permutation(np.linspace(1.0, 10.0, n)).astype(np.float32)  # distinct
    return mean2d, radius, depth


CASES = {
    # name: (seed, n, w, h, per-axis extents, pair capacity, JAX force_fallback)
    "isotropic": (1, 20, 64, 48, False, 512, False),
    "extents": (2, 60, 96, 64, True, 2048, False),
    "odd_size": (3, 40, 50, 38, True, 1024, False),
    "jax_fallback": (7, 40, 96, 64, False, 1024, True),
    "overflow": (4, 60, 96, 64, True, 64, False),  # capacity far below the pairs
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches_jax(case):
    seed, n, w, h, extents, cap, fallback = CASES[case]
    mean2d, radius, depth = _inputs(seed, n, w, h, extents)
    want = jax_bin_gaussians(jnp.asarray(mean2d), jnp.asarray(radius), jnp.asarray(depth),
                             w, h, 16, cap, force_fallback=fallback)
    got = bin_gaussians(torch.from_numpy(mean2d), torch.from_numpy(radius),
                        torch.from_numpy(depth), w, h, 16, cap)
    for name in FIELDS:
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    TW, TH = tile_grid(w, h, 16)
    assert got.tile_start.shape == (TW * TH,)
    if case == "overflow":
        assert int(got.num_pairs) > cap and int(got.tile_count.sum()) == cap


def test_all_culled():
    got = bin_gaussians(torch.zeros(4, 2), torch.zeros(4), torch.ones(4), 32, 32, 16, 64)
    assert int(got.num_pairs) == 0 and int(got.tile_count.sum()) == 0
    assert (got.pair_tile == 4).all()  # every slot holds the sentinel tile


def test_overflow_keeps_front_pairs():
    """Truncation at capacity drops the deepest gaussians' pairs, and no
    pair slot past the emitted ones leaks into a tile (the sentinel)."""
    n = 10
    mean2d = torch.full((n, 2), 16.0)
    radius = torch.full((n,), 100.0)  # every gaussian covers all 16 tiles
    depth = torch.linspace(1, 2, n)
    got = bin_gaussians(mean2d, radius, depth, 64, 64, 16, pair_capacity=40)
    assert int(got.num_pairs) == n * 16
    assert int(got.tile_count.sum()) == 40
    # the first 40 emitted slots are ranks 0, 1 (16 each) and 8 of rank 2
    assert sorted(set(got.pair_gauss.tolist())) == [0, 1, 2]
