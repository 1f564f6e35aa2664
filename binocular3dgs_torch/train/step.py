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

The numbers that change from step to step (the shift, the xyz learning
rate, Adam's bias corrections: `StepScalars`) reach the device as host
numbers in an eager step and as 0-d tensors on the card in a graphed one,
and the step reads nothing from the card. So `StepGraphs` can capture a
step on a card once per shape as a CUDA graph and replay it with one
launch: the trainer's own steps run so, and every other caller (the CPU,
a trainer with a given `render_fn`, parallel/sharding.py, a direct call of
`make_train_step`'s step) runs the same step eagerly.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, NamedTuple

import torch

from .. import tracing
from ..config import Config
from ..core.camera import Camera, shift_camera
from ..core.transforms import inverse_sigmoid
from ..models.gaussians import PARAM_NAMES, GaussianModel, GaussianParams
from ..ops.losses import l1_loss, smooth_loss, ssim
from ..ops.warp import inverse_warp_image, warp_mask
from .state import TrainState, adam_update, bias_corrections, group_lrs, xyz_lr_fn

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


class StepScalars(NamedTuple):
    """The numbers of one step that change from iteration to iteration:
    host numbers in an eager step, 0-d float32 tensors on the card in a
    graphed one (the graph reads them where `StepGraphs` writes them)."""

    trans: Any  # the binocular shift; None without the binocular branch
    xyz_lr: Any
    b1t_inv: Any  # bias_corrections(adam_step)
    b2t_inv: Any


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
    trans,
    lambda_dssim: float,
):
    """(total loss, aux) of one view; `trans` (a number or a 0-d tensor on
    the device) None skips the binocular branch."""
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
    trans, bg, scalars=None) -> (state, StepMetrics)`. `trans` is the
    binocular shift (ignored when `binocular` is off). The returned state
    holds the same tensors as the one passed in, updated in place.
    `scalars` (`StepScalars`) replaces the numbers that `step.scalars(state,
    iteration, trans)` computes on the host, as a CUDA graph's inputs;
    `step.branches(iteration)` gives the (opacity decay, densification
    statistics) switches that the iteration sets.

    `adam_fn` replaces `adam_update` (same arguments and result): the
    counterpart of the JAX step's `opt_state_sharding`, through which
    parallel/sharding.py keeps each rank's rows of the moments only."""
    opt = cfg.opt
    xyz_lr = xyz_lr_fn(opt, spatial_lr_scale)
    densify_until = opt.iterations if cfg.train.opacity_decay else opt.densify_until_iter

    def branches(iteration: int) -> tuple[bool, bool]:
        return (bool(cfg.train.opacity_decay) and iteration > opt.densify_from_iter,
                iteration < densify_until)

    def host_scalars(state: TrainState, iteration: int, trans) -> StepScalars:
        return StepScalars(trans if binocular else None, xyz_lr(iteration),
                           *bias_corrections(state.adam_step))

    def train_step(
        state: TrainState,
        camera: Camera,
        gt_image: torch.Tensor,
        alpha_weight: torch.Tensor,
        iteration: int,
        trans,
        bg: torch.Tensor,
        scalars: StepScalars | None = None,
    ):
        s = host_scalars(state, iteration, trans) if scalars is None else scalars
        decay, stats = branches(iteration)
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
                s.trans,
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
            if decay:
                opa = torch.sigmoid(params.opacity) * cfg.train.opacity_decay_factor
                params.opacity.copy_(
                    torch.where(model.active[:, None], inverse_sigmoid(opa), params.opacity)
                )

            # densification statistics (reference train.py:176-179)
            radii = aux["radii"]
            visible = radii > 0
            if stats:
                gnorm = torch.linalg.norm(carrier_grad, dim=-1)
                state.max_radii2d.copy_(
                    torch.where(visible, torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))
                state.grad_accum.copy_(torch.where(visible, state.grad_accum + gnorm,
                                                   state.grad_accum))
                state.denom.copy_(torch.where(visible, state.denom + 1.0, state.denom))

            update = adam_update if adam_fn is None else adam_fn
            step = update(params, grads, state.adam_m, state.adam_v, state.adam_step,
                          group_lrs(opt, s.xyz_lr), model.active,
                          corrections=(s.b1t_inv, s.b2t_inv))

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

    train_step.branches, train_step.scalars = branches, host_scalars
    train_step.use_alpha_weight = use_alpha_weight
    return train_step


# whether this process has run a step on a card eagerly: the first step
# makes the lazy first-use work (the kernel library, SSIM's taps, read
# once) that a capture must not meet
_eager_on_card = False


@dataclasses.dataclass
class _Graph:
    """One captured step and its static inputs and outputs."""

    graph: Any  # torch.cuda.CUDAGraph
    camera: Camera  # its tensors views of `camera_values`
    camera_values: torch.Tensor
    camera_layout: list  # (field, its dims from the largest stride to the smallest)
    gt_image: torch.Tensor
    alpha_weight: torch.Tensor | None  # None where the step reads none
    scalars: StepScalars
    metrics: StepMetrics
    recording: tracing.recording
    bg: torch.Tensor  # held: the key names it by id

    def stage(self, camera: Camera, gt_image, alpha_weight, scalars: StepScalars):
        """The call's inputs into the graph's: device-to-device copies and
        fills, on the current stream, with no host sync."""
        _stage_camera(camera, self.camera_values, self.camera_layout)
        self.gt_image.copy_(gt_image)
        if self.alpha_weight is not None:
            self.alpha_weight.copy_(alpha_weight)
        for dst, value in zip(self.scalars, scalars):
            if dst is not None:
                dst.fill_(value)


def _camera_tensors(camera: Camera) -> dict:
    return {f.name: getattr(camera, f.name) for f in dataclasses.fields(camera)
            if isinstance(getattr(camera, f.name), torch.Tensor)}


def _static_camera(camera: Camera) -> tuple[Camera, torch.Tensor, list]:
    """(a camera whose tensors are views of one buffer, the buffer, its
    layout for `_stage_camera`). The views keep the strides of `camera`'s
    (dense) tensors, make_camera's matrices being column-major, so that a
    graph asks cuBLAS for the same products as an eager step and rounds as
    there."""
    tensors = _camera_tensors(camera)
    values = torch.empty(sum(t.numel() for t in tensors.values()),
                         device=camera.world_view.device)
    views, layout, k = {}, [], 0
    for name, t in tensors.items():
        views[name] = values.as_strided(t.shape, t.stride(), k)
        layout.append((name, sorted(range(t.dim()), key=lambda d: -t.stride(d))))
        k += t.numel()
    return dataclasses.replace(camera, **views), values, layout


def _stage_camera(camera: Camera, values: torch.Tensor, layout: list) -> None:
    """`camera`'s values into a `_static_camera` buffer, each tensor's in
    its memory order: one launch."""
    torch.cat([getattr(camera, name).permute(order).reshape(-1) for name, order in layout],
              out=values)


class StepGraphs:
    """A trainer's steps on a card, each as one CUDA graph per step shape,
    captured the first time the shape is seen (once the process has run a
    step eagerly) and replayed with one launch: `wrap(step)` gives the
    callable, `step` keeps running eagerly on the CPU and for the process's
    first step on a card (`graphed.eager` is `step`, `graphed.graphs` the
    `StepGraphs`).

    A shape is the step (binocular or not), its opacity-decay and
    statistics switches, the active SH degree, the raster config (the pair
    capacity), the image size and clip planes, and the background tensor.
    All graphs share one memory pool and replay in sequence on one stream.
    They run on static state buffers: a state that holds other tensors (a
    state cloned to restore it, or rebuilt by densification) is copied into
    them, and the state returned holds them; a change of the buffers'
    shapes (the capacity) drops the graphs and the buffers. The drawn
    view's camera, ground truth and alpha weight are copied into the
    graph's inputs and `StepScalars` written with fills. The metrics are
    fresh tensors at every call, so a span may keep them. `captures` and
    `replays` count the mechanism's use, as do the counters
    `step.graph_captures` and `step.graph_replays`."""

    def __init__(self, raster: Callable[[], Any]):
        self._raster = raster  # the render's raster config as it stands
        self._graphs: dict = {}
        self._pool = None
        self._buffers: list | None = None
        self.captures = self.replays = 0

    def wrap(self, step):
        def graphed(state, camera, gt_image, alpha_weight, iteration, trans, bg):
            return self._call(step, state, camera, gt_image, alpha_weight, iteration, trans, bg)

        graphed.eager, graphed.graphs = step, self
        return graphed

    def _call(self, step, state, camera, gt_image, alpha_weight, iteration, trans, bg):
        global _eager_on_card
        on_card = state.model.params.xyz.is_cuda
        if not on_card or not _eager_on_card:
            out = step(state, camera, gt_image, alpha_weight, iteration, trans, bg)
            _eager_on_card = _eager_on_card or on_card
            return out
        state = self._adopt(state)
        model = state.model
        key = (step, *step.branches(iteration), model.active_sh_degree,
               dataclasses.astuple(self._raster()), camera.width, camera.height, camera.znear,
               camera.zfar, id(bg))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(step, state, camera, gt_image, alpha_weight,
                                                  iteration, bg)
        g.stage(camera, gt_image, alpha_weight, step.scalars(state, iteration, trans))
        with tracing.region("step.replay"):
            g.graph.replay()
        tracing.replayed(g.recording)
        tracing.count("step.graph_replays", 1)
        self.replays += 1
        metrics = StepMetrics(*tracing.copies(list(g.metrics[:-1])),
                              pair_capacity=g.metrics.pair_capacity)
        return state.replace(adam_step=state.adam_step + 1), metrics

    def _adopt(self, state: TrainState) -> TrainState:
        """`state` on the static buffers."""
        src = state.buffers()
        if self._buffers is None or any(a.shape != b.shape or a.dtype != b.dtype
                                        for a, b in zip(self._buffers, src)):
            self._graphs.clear()
            self._pool = None
            self._buffers = [t.clone() for t in src]
        else:
            for dst, t in zip(self._buffers, src):
                if dst is not t:
                    dst.copy_(t)
        return state.with_buffers(self._buffers)

    def _capture(self, step, state, camera, gt_image, alpha_weight, iteration, bg) -> _Graph:
        static_camera, values, layout = _static_camera(camera)
        scalars = StepScalars(*(None if v is None else torch.zeros((), device=values.device)
                                for v in step.scalars(state, iteration, 0.0)))
        g = _Graph(graph=torch.cuda.CUDAGraph(), camera=static_camera,
                   camera_values=values, camera_layout=layout,
                   gt_image=torch.empty_like(gt_image),
                   alpha_weight=torch.empty_like(alpha_weight) if step.use_alpha_weight
                   else None,
                   scalars=scalars, metrics=None, recording=tracing.recording(), bg=bg)
        torch.cuda.current_blas_handle()  # cuBLAS's handle made outside the capture
        # A graph freed during a capture (a dead trainer's, by the cyclic
        # collector) invalidates it: dead cycles go first, and the
        # collector rests until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g.graph, pool=self._pool), g.recording:
                _, g.metrics = step(state, g.camera, g.gt_image, g.alpha_weight, iteration,
                                    None, bg, scalars=scalars)
        finally:
            if collecting:
                gc.enable()
        if self._pool is None:
            self._pool = g.graph.pool()
        tracing.count("step.graph_captures", 1)
        self.captures += 1
        return g
