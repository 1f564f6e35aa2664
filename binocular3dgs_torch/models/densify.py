"""Densification: clone / split / prune on fixed-capacity buffers.

Counterpart of `binocular3dgs_tpu/models/densify.py` (reference
`scene/gaussian_model.py:307-411`):

  * grads = accumulated screen-space grad norm / count, NaN -> 0
  * clone: grad >= thr and max scale <= percent_dense * extent -> duplicate
  * split: grad >= thr and max scale > percent_dense * extent -> two
    children drawn from N(0, scale) rotated into world, scale /= 1.6; the
    parent goes
  * prune: opacity < min_opacity (size pruning only with max_screen_size,
    which the binocular protocol leaves None, `train.py:185`)
  * Adam moments: survivors keep theirs, new points start at zero, and the
    densification accumulators restart at zero (`:349-351`)
  * opacity decay: opacity <- sigmoid^-1(sigmoid(opacity) * factor) (`:307`)

The next generation is compacted into the same capacity with one scatter
(originals first, then clones, then split children); overflow drops from the
tail and is reported by `n_wanted`, so the caller can grow the capacity.
The split noise is drawn from a `torch.Generator`, or given as `noise`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import tracing
from ..core.transforms import inverse_sigmoid, quat_to_rotmat
from ..models.gaussians import _FILL, PARAM_NAMES, GaussianParams
from ..train.state import TrainState, zeros_like_params


class DensifyResult(NamedTuple):
    state: TrainState
    n_before: int
    n_after: int  # survivors written (after truncation at capacity)
    n_wanted: int  # survivors the rule wanted (before truncation)


def _replace_params(state: TrainState, **fields) -> TrainState:
    params = dataclasses.replace(state.model.params, **fields)
    return state.replace(model=dataclasses.replace(state.model, params=params))


@torch.no_grad()
def opacity_decay(state: TrainState, factor: float) -> TrainState:
    """reference `scene/gaussian_model.py:307-309`."""
    p = state.model.params
    opa = torch.sigmoid(p.opacity) * factor
    new = torch.where(state.model.active[:, None], inverse_sigmoid(opa), p.opacity)
    return _replace_params(state, opacity=new)


@torch.no_grad()
def reset_opacity(state: TrainState) -> TrainState:
    """opacity <- sigmoid^-1(min(sigmoid(opacity), 0.01)) with the opacity
    group's Adam moments zeroed (reference `scene/gaussian_model.py:210-213`).
    The binocular protocol never calls it (`train.py:188-193`)."""
    p = state.model.params
    new = inverse_sigmoid(torch.clamp(torch.sigmoid(p.opacity), max=0.01))
    new = torch.where(state.model.active[:, None], new, p.opacity)
    state = _replace_params(state, opacity=new)

    def zero_opacity(tree):
        return dataclasses.replace(tree, opacity=torch.zeros_like(tree.opacity))

    return state.replace(adam_m=zero_opacity(state.adam_m), adam_v=zero_opacity(state.adam_v))


def _scatter_compact(
    candidates: list[GaussianParams],
    cand_m: list[GaussianParams],
    cand_v: list[GaussianParams],
    masks: list[torch.Tensor],
    capacity: int,
):
    """Compact the rows of the candidate blocks (each (cap, ...)) picked by
    `masks` into one capacity-sized buffer, in list order; rows past the
    capacity are dropped. Returns (params, m, v, active, n_after)."""
    mask_cat = torch.cat(masks)
    pos = torch.cumsum(mask_cat.long(), dim=0) - 1
    target = torch.where(mask_cat & (pos < capacity), pos, capacity)  # capacity = drop slot
    n_after = min(int(mask_cat.sum()), capacity)
    tracing.count("trainer.host_reads", 1)
    active = torch.arange(capacity, device=mask_cat.device) < n_after

    def scatter(blocks, sentinels):
        out = {}
        for n in PARAM_NAMES:
            cat = torch.cat([getattr(b, n) for b in blocks])
            base = cat.new_full((capacity + 1,) + cat.shape[1:], _FILL.get(n, 0.0) if sentinels
                                else 0.0)
            if sentinels and n == "rotation":
                base[:, 0] = 1.0
            base[target] = cat
            out[n] = base[:capacity]
            if not sentinels:  # moments of inactive rows are zero
                out[n] = torch.where(active.reshape((-1,) + (1,) * (cat.ndim - 1)), out[n], 0.0)
        return GaussianParams(**out)

    return (scatter(candidates, True), scatter(cand_m, False), scatter(cand_v, False), active,
            n_after)


@torch.no_grad()
def densify_and_prune(
    state: TrainState,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    generator: torch.Generator | None = None,
    max_screen_size: float | None = None,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> DensifyResult:
    """One densification round. The split children's standard normals
    (two (cap, 3) draws) come from `generator` (on the CPU, then moved to
    the state's device) unless `noise` gives them. `max_screen_size` enables
    size pruning (reference `scene/gaussian_model.py:397-404`), tested
    against the pre-densify `max_radii2d` as the JAX version does."""
    model = state.model
    p = model.params
    cap = model.capacity
    active = model.active
    dev = p.xyz.device

    grads = torch.where(state.denom > 0, state.grad_accum / torch.clamp(state.denom, min=1.0),
                        0.0)
    grads = torch.nan_to_num(grads, nan=0.0)

    scaling = torch.exp(p.scaling)
    max_scale = scaling.amax(dim=-1)
    opacity_act = torch.sigmoid(p.opacity[:, 0])

    hot = active & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)
    alive = opacity_act >= min_opacity
    child_alive = alive  # children inherit the parent's opacity
    if max_screen_size is not None:
        alive = alive & ~(state.max_radii2d > max_screen_size) & ~(max_scale > 0.1 * extent)
        child_alive = child_alive & ~((max_scale / 1.6) > 0.1 * extent)

    keep_orig = active & ~split_mask & alive
    keep_clone = clone_mask & alive
    keep_split = split_mask & child_alive

    # split children: xyz = parent + R @ (N(0, 1) * scale), scale /= 0.8 * 2
    if noise is None:
        noise = tuple(torch.randn(cap, 3, generator=generator) for _ in range(2))
    R = quat_to_rotmat(p.rotation)
    child_scaling = torch.log(torch.clamp(scaling / 1.6, min=1e-30))

    def child(n):
        offset = torch.einsum("nij,nj->ni", R, n.to(dev) * scaling)
        return dataclasses.replace(p, xyz=p.xyz + offset, scaling=child_scaling)

    zero = zeros_like_params(p)
    params, m, v, new_active, n_after = _scatter_compact(
        candidates=[p, p, child(noise[0]), child(noise[1])],
        cand_m=[state.adam_m, zero, zero, zero],
        cand_v=[state.adam_v, zero, zero, zero],
        masks=[keep_orig, keep_clone, keep_split, keep_split],
        capacity=cap,
    )
    n_orig, n_clone, n_split = int(keep_orig.sum()), int(keep_clone.sum()), int(keep_split.sum())
    new_state = state.replace(
        model=dataclasses.replace(model, params=params, active=new_active),
        adam_m=m,
        adam_v=v,
        grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev),
        max_radii2d=torch.zeros(cap, device=dev),
    )
    n_before = int(active.sum())
    tracing.count("trainer.host_reads", 4)
    # a split parent leaves and its two children stay; every other row that
    # leaves is pruned
    tracing.count("densify.cloned", n_clone)
    tracing.count("densify.split", n_split)
    tracing.count("densify.pruned", n_before - n_orig - n_split)
    return DensifyResult(new_state, n_before, n_after, n_orig + n_clone + 2 * n_split)
