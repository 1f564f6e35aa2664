"""The record gathers' fixed-order backward (binocular3dgs_torch/ops/rasterize.py):
each gaussian's pair cotangents summed in pair order, the same bits on every
run. On the CPU the segment sum equals a float32 loop over the pairs bit for
bit; the card's order, each gaussian's emission slots read through the
sorted positions in ascending slot order, gives the segment sum's bits on
random binnings, overflow included (the claim that makes
csrc/binning.cu's backward bit-exact, checked without a card); the
gathers' gradients agree with autograd's own `index_select` backward (an
`index_add_`) within float32 reordering; and a training step from one
state gives the same bits twice (the card's repeat is held in
tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

from binocular3dgs_torch.ops.binning import bin_gaussians_torch, tile_grid
from binocular3dgs_torch.ops.rasterize import _GatherRecords, segment_sum_columns

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)


def cotangents(seed, P=4000, n=300, empty=(7, 150)):
    """(10, P) float32 cotangents over 12 decades and a column index with
    some columns that no pair names."""
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(10, P)) * 10.0 ** rng.uniform(-6, 6, (10, P))).astype(np.float32)
    idx = rng.integers(0, n, P)
    idx[np.isin(idx, empty)] = 0
    return d, idx, n


def test_segment_sum_equals_pair_order_loop():
    d, idx, n = cotangents(0)
    want = np.zeros((10, n), np.float32)
    for p in range(d.shape[1]):  # float32, ascending pair order
        want[:, idx[p]] = want[:, idx[p]] + d[:, p]
    got = segment_sum_columns(torch.from_numpy(d), torch.from_numpy(idx), n).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[:, [7, 150]].any()


def random_binning(seed, n, capacity_share, W=160, H=112, ts=16):
    """The plain binning of `n` random splats (a fifth culled, extents of
    0.5-40 px, per-axis) with the pair capacity at `capacity_share` of the
    wanted pairs."""
    g = torch.Generator().manual_seed(seed)
    mean2d = torch.rand(n, 2, generator=g) * torch.tensor([W + 40.0, H + 40.0]) - 20.0
    ext = 0.5 + torch.rand(n, 2, generator=g) * 40.0
    ext[torch.rand(n, generator=g) < 0.2] = 0.0
    depth = torch.rand(n, generator=g) * 8.0 + 1.0
    wanted = int(bin_gaussians_torch(mean2d, ext, depth, W, H, ts, 1).num_pairs)
    cap = max(1, int(wanted * capacity_share))
    return bin_gaussians_torch(mean2d, ext, depth, W, H, ts, cap), tile_grid(W, H, ts)


def emission_order_sum(d: np.ndarray, b) -> np.ndarray:
    """(10, n) in depth-rank space: for each rank g, its emission slots
    rank_offsets[g] .. min(rank_offsets[g+1], P), each read at its sorted
    position (`sorted_pos`), added in ascending slot order from 0 in
    float32."""
    P = d.shape[1]
    ro, pos = b.rank_offsets.numpy(), b.sorted_pos.numpy()
    out = np.zeros((10, ro.shape[0] - 1), np.float32)
    for g in range(out.shape[1]):
        acc = np.zeros(10, np.float32)
        for e in range(min(ro[g], P), min(ro[g + 1], P)):
            acc = acc + d[:, pos[e]]
        out[:, g] = acc
    return out


@pytest.mark.parametrize("seed,n,capacity_share", [(3, 300, 1.5), (4, 500, 0.5), (5, 200, 0.02)],
                         ids=["room", "overflow", "tiny_capacity"])
def test_emission_order_sum_equals_segment_sum(seed, n, capacity_share):
    b, (TW, TH) = random_binning(seed, n, capacity_share)
    P, E = b.pair_gauss.shape[0], int(b.bin_slots)
    assert E == min(int(b.num_pairs), P) and (capacity_share < 1) == (E == P)
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(10, P)) * 10.0 ** rng.uniform(-6, 6, (10, P))).astype(np.float32)
    d[:, E:] = 0.0  # the blend's backward writes 0 outside the tiles' segments
    want = segment_sum_columns(torch.from_numpy(d), b.pair_gauss, n).numpy()
    got = emission_order_sum(d, b)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,capacity_share", [(6, 2.0), (7, 0.3)], ids=["room", "overflow"])
def test_sorted_positions_invert_the_sort(seed, capacity_share):
    """sorted_pos sends each emission slot below bin_slots to a pair of the
    slot's rank, each sorted pair once; rank_of inverts order; within a
    rank, ascending slots are ascending tiles (the order of the sums)."""
    b, (TW, TH) = random_binning(seed, 400, capacity_share)
    E = int(b.bin_slots)
    ro = b.rank_offsets.long()
    e = torch.arange(E)
    rank = torch.searchsorted(ro[1:], e, right=True)
    pos = b.sorted_pos[:E].long()
    assert sorted(pos.tolist()) == list(range(E))
    assert torch.equal(b.pair_gauss[pos].long(), rank)
    assert torch.equal(b.rank_of[b.order.long()], torch.arange(b.order.shape[0], dtype=torch.int32))
    # within a rank, ascending slots are ascending tiles: the sums' order
    tiles = b.pair_tile[pos].long()
    same_rank = rank[1:] == rank[:-1]
    assert bool((tiles[1:][same_rank] > tiles[:-1][same_rank]).all())
    assert bool((b.pair_tile[E:] == TW * TH).all())


def test_gather_gradients_match_index_add():
    d, idx, n = cotangents(1, empty=())
    rng = np.random.default_rng(2)
    fields = torch.from_numpy(rng.normal(size=(10, n)).astype(np.float32))
    order = torch.from_numpy(rng.permutation(n))
    index = torch.from_numpy(idx)
    cot = torch.from_numpy(d)

    def grad(reorder, gather):
        f = fields.clone().requires_grad_(True)
        out = gather(reorder(f, order), index)
        (g,) = torch.autograd.grad(out, f, cot)
        return out.detach(), g

    out, g = grad(lambda f, o: torch.index_select(f, 1, o), _GatherRecords.apply)
    out_ref, g_ref = grad(lambda f, o: torch.index_select(f, 1, o),
                          lambda f, i: torch.index_select(f, 1, i))
    assert torch.equal(out, out_ref)
    # each column's sum of |terms|, back in the fields' column order
    scale = torch.zeros(10, n).index_add_(1, index, cot.abs()).index_select(
        1, torch.argsort(order))
    assert ((g - g_ref).abs() <= 1e-6 * scale + 1e-30).all()


def test_train_step_repeats_bit_for_bit():
    """Two binocular steps of the JAX parity test's inputs from one state."""
    from binocular3dgs_tpu.train import state as jax_state
    from binocular3dgs_torch.config import Config
    from binocular3dgs_torch.ops.rasterize import render_tiled
    from binocular3dgs_torch.train.step import make_train_step

    from test_torch_project import camera_pair
    from test_torch_train import step_inputs, to_port_state

    m, gt, aw = step_inputs()
    _, cam = camera_pair()

    def render(cam, model, bg, mean2d_carrier=None):
        return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)

    step = make_train_step(render, Config(), 1.0, binocular=True, use_alpha_weight=True)
    runs = []
    for _ in range(2):
        state = to_port_state(jax_state.init_train_state(m))
        for it in (2, 3):
            state, metrics = step(state, cam, torch.from_numpy(gt), torch.from_numpy(aw), it,
                                  0.25, torch.zeros(3))
        runs.append((state, float(metrics.loss + metrics.disparity_loss)))
    (a, la), (b, lb) = runs
    assert la == lb
    for name in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        for tree_a, tree_b in ((a.model.params, b.model.params), (a.adam_m, b.adam_m),
                               (a.adam_v, b.adam_v)):
            assert torch.equal(getattr(tree_a, name).view(torch.int32),
                               getattr(tree_b, name).view(torch.int32)), name
    assert torch.equal(a.grad_accum.view(torch.int32), b.grad_accum.view(torch.int32))
