"""The training step.

Counterpart of `binocular3dgs_tpu/train/step.py` (reference
`train.py:65-202`), with the same order of work:

  * loss = (1-λ)·L1 + λ·(1-SSIM)  (λ = 0.2)
  * binocular branch: a second render from the camera shifted by `trans`
    along its x axis, disparity = fx·(-trans)/(depth+1e-5) from the main
    render's depth, inverse warp of the shifted render, masked L1 against
    the ground truth + 0.05·smooth(disparity·mask, gt)
  * alpha loss: mean(|alpha|·alpha_weight) when the scene has alpha weights
  * gradients by autograd (the blend and warp backward kernels inside)
  * opacity decay on the pre-update parameters after densify_from_iter
  * densification statistics from the gradient of the mean2d carrier
  * per-group masked Adam (in place, train/state.py)

The shift `trans` is an input: the caller draws it (the trainer from a
`torch.Generator`), where the JAX step splits its key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .. import tracing
from ..config import Config
from ..core.camera import Camera, shift_camera
from ..core.transforms import inverse_sigmoid
from ..models.gaussians import PARAM_NAMES, GaussianModel, GaussianParams
from ..ops.losses import l1_loss, smooth_loss, ssim
from ..ops.warp import inverse_warp_image, warp_mask
from .state import TrainState, adam_update, group_lrs, xyz_lr_fn

# render_fn(camera, model, bg, mean2d_carrier=...) -> RenderOutput-like
RenderFn = Callable[..., Any]


class StepMetrics(NamedTuple):
    """Device scalars of one step (reading one syncs the host with the card)."""

    loss: torch.Tensor  # (1-λ)·L1 + λ·(1-SSIM) of the main render
    l1: torch.Tensor
    disparity_loss: torch.Tensor
    alpha_loss: torch.Tensor
    n_visible: torch.Tensor
    # wanted (pre-truncation) pair-list sizes, max over the step's renders,
    # and the capacity the renders ran with; 0 when the render_fn does not
    # report them (dense oracle)
    num_pairs: torch.Tensor
    max_tile_pairs: torch.Tensor
    pair_capacity: int


def _pressure(out, prev=None):
    zero = torch.zeros((), dtype=torch.int32, device=out.image.device)
    num = getattr(out, "num_pairs", None)
    mtp = getattr(out, "max_tile_pairs", None)
    num = zero if num is None else num
    mtp = zero if mtp is None else mtp
    cap = getattr(out, "pair_capacity", None) or 0
    if prev is not None:
        num, mtp = torch.maximum(num, prev[0]), torch.maximum(mtp, prev[1])
    return num, mtp, cap


def compute_losses(
    render_fn: RenderFn,
    model: GaussianModel,
    camera: Camera,
    gt_image: torch.Tensor,
    alpha_weight: torch.Tensor | None,
    bg: torch.Tensor,
    carrier: torch.Tensor,
    trans: float | None,
    lambda_dssim: float,
):
    """(total loss, aux) of one view; `trans` None skips the binocular
    branch."""
    out = render_fn(camera, model, bg, mean2d_carrier=carrier)
    pressure = _pressure(out)

    with tracing.region("step.loss.photo"):
        Ll1 = l1_loss(out.image, gt_image)
        loss = (1.0 - lambda_dssim) * Ll1 + lambda_dssim * (1.0 - ssim(out.image, gt_image))

    disparity_loss = torch.zeros((), device=gt_image.device)
    if trans is not None:
        with tracing.region("step.loss.disparity"):
            out_s = render_fn(shift_camera(camera, trans), model, bg, mean2d_carrier=None)
            pressure = _pressure(out_s, pressure)
            disparity = camera.focal_x * (-trans) / (out.depth + 1e-5)
            warped = inverse_warp_image(out_s.image, disparity)
            mask = warp_mask(disparity, camera.height, camera.width)
            disparity_loss = l1_loss(warped, gt_image, mask=mask) + 0.05 * smooth_loss(
                disparity * mask, gt_image
            )

    alpha_l = torch.zeros((), device=gt_image.device)
    if alpha_weight is not None:
        with tracing.region("step.loss.alpha"):
            alpha_l = torch.mean(torch.abs(out.alpha) * alpha_weight)

    total = loss + disparity_loss + alpha_l
    aux = {
        "l1": Ll1.detach(),
        "loss": loss.detach(),
        "disparity_loss": disparity_loss.detach(),
        "alpha_loss": alpha_l.detach(),
        "radii": out.radii.detach(),
        "num_pairs": pressure[0],
        "max_tile_pairs": pressure[1],
        "pair_capacity": pressure[2],
    }
    return total, aux


def make_train_step(
    render_fn: RenderFn,
    cfg: Config,
    spatial_lr_scale: float,
    binocular: bool,
    use_alpha_weight: bool,
    adam_fn: Callable[..., int] | None = None,
):
    """A train step `(state, camera, gt_image, alpha_weight, iteration,
    trans, bg) -> (state, StepMetrics)`. `trans` is the binocular shift
    (ignored when `binocular` is off). The returned state holds the same
    tensors as the one passed in, updated in place.

    `adam_fn` replaces `adam_update` (same arguments and result): the
    counterpart of the JAX step's `opt_state_sharding`, through which
    parallel/sharding.py keeps each rank's rows of the moments only."""
    opt = cfg.opt
    xyz_lr = xyz_lr_fn(opt, spatial_lr_scale)
    densify_until = opt.iterations if cfg.train.opacity_decay else opt.densify_until_iter

    def train_step(
        state: TrainState,
        camera: Camera,
        gt_image: torch.Tensor,
        alpha_weight: torch.Tensor,
        iteration: int,
        trans: float | None,
        bg: torch.Tensor,
    ):
        model = state.model
        leaves = {n: getattr(model.params, n).detach().requires_grad_(True) for n in PARAM_NAMES}
        carrier = torch.zeros(model.capacity, 2, device=model.params.xyz.device,
                              requires_grad=True)
        with tracing.region("step.forward"):
            total, aux = compute_losses(
                render_fn,
                dataclasses.replace(model, params=GaussianParams(**leaves)),
                camera,
                gt_image,
                alpha_weight if use_alpha_weight else None,
                bg,
                carrier,
                trans if binocular else None,
                opt.lambda_dssim,
            )
        with tracing.region("step.backward"):
            grad_list = torch.autograd.grad(total, [*leaves.values(), carrier],
                                            allow_unused=True)
            grad_list = [torch.zeros_like(x) if g is None else g
                         for x, g in zip([*leaves.values(), carrier], grad_list)]
        grads = GaussianParams(**dict(zip(PARAM_NAMES, grad_list[:-1])))
        carrier_grad = grad_list[-1]

        with torch.no_grad(), tracing.region("step.update"):
            params = model.params
            # opacity decay (reference train.py:171-173), before the Adam
            # step, on the pre-update parameters; grads stay those of the
            # pre-decay value
            if cfg.train.opacity_decay and iteration > opt.densify_from_iter:
                opa = torch.sigmoid(params.opacity) * cfg.train.opacity_decay_factor
                params.opacity.copy_(
                    torch.where(model.active[:, None], inverse_sigmoid(opa), params.opacity)
                )

            # densification statistics (reference train.py:176-179)
            radii = aux["radii"]
            visible = radii > 0
            if iteration < densify_until:
                gnorm = torch.linalg.norm(carrier_grad, dim=-1)
                state.max_radii2d.copy_(
                    torch.where(visible, torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))
                state.grad_accum.copy_(torch.where(visible, state.grad_accum + gnorm,
                                                   state.grad_accum))
                state.denom.copy_(torch.where(visible, state.denom + 1.0, state.denom))

            update = adam_update if adam_fn is None else adam_fn
            step = update(params, grads, state.adam_m, state.adam_v, state.adam_step,
                          group_lrs(opt, xyz_lr(iteration)), model.active)

        n_visible = visible.sum()
        tracing.count("step.visible", n_visible)
        metrics = StepMetrics(
            loss=aux["loss"],
            l1=aux["l1"],
            disparity_loss=aux["disparity_loss"],
            alpha_loss=aux["alpha_loss"],
            n_visible=n_visible,
            num_pairs=aux["num_pairs"],
            max_tile_pairs=aux["max_tile_pairs"],
            pair_capacity=aux["pair_capacity"],
        )
        return state.replace(adam_step=step), metrics

    return train_step
