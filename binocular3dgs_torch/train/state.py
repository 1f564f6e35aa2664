"""Training state: model + per-parameter Adam moments + densification stats.

Counterpart of `binocular3dgs_tpu/train/state.py` (reference
`scene/gaussian_model.py:61-93,149-175`: per-group Adam with eps 1e-15 and
the xyz exponential LR schedule). Moments are fixed-capacity tensors beside
the parameter buffers, row for row; densification (models/densify.py)
re-scatters them. `adam_step` is a host integer: the bias corrections are
computed on the host (`bias_corrections`) and the step never reads the
device.

`adam_update` updates parameters and moments IN PLACE (the JAX version
returns new arrays): the state owns its tensors, and in-place updates keep
one copy of each buffer on the card. On a card it is one launch of the
hand-written kernel `csrc/adam.cu` over the six groups, which writes the
bits of `adam_update_torch`, the plain composition that the CPU runs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import OptimizationConfig
from ..core.transforms import expon_lr_schedule
from ..models.gaussians import PARAM_NAMES, GaussianModel, GaussianParams
from ..models.gaussians import from_numpy as model_from_numpy
from ..ops.cuda_build import launch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


@dataclass
class TrainState:
    model: GaussianModel
    adam_m: GaussianParams
    adam_v: GaussianParams
    adam_step: int  # global step count (shared across groups)
    grad_accum: torch.Tensor  # (N,) accumulated screen-space grad norms
    denom: torch.Tensor  # (N,) accumulation counts
    max_radii2d: torch.Tensor  # (N,) max observed screen radius

    def replace(self, **kwargs) -> "TrainState":
        return dataclasses.replace(self, **kwargs)

    def buffers(self) -> list[torch.Tensor]:
        """Every tensor of the state, in the order `with_buffers` takes
        them: the parameters, the active mask, both moments, the
        densification statistics."""
        return [*(getattr(self.model.params, n) for n in PARAM_NAMES), self.model.active,
                *(getattr(self.adam_m, n) for n in PARAM_NAMES),
                *(getattr(self.adam_v, n) for n in PARAM_NAMES),
                self.grad_accum, self.denom, self.max_radii2d]

    def with_buffers(self, tensors) -> "TrainState":
        """The state with its tensors replaced by `tensors` (`buffers`'
        order); its step count and the model's settings unchanged."""
        t = list(tensors)
        k = len(PARAM_NAMES)

        def tree(i):
            return GaussianParams(**dict(zip(PARAM_NAMES, t[i:i + k])))

        model = dataclasses.replace(self.model, params=tree(0), active=t[k])
        return self.replace(model=model, adam_m=tree(k + 1), adam_v=tree(2 * k + 1),
                            grad_accum=t[3 * k + 1], denom=t[3 * k + 2],
                            max_radii2d=t[3 * k + 3])


def zeros_like_params(params: GaussianParams) -> GaussianParams:
    return GaussianParams(**{n: torch.zeros_like(getattr(params, n)) for n in PARAM_NAMES})


def init_train_state(model: GaussianModel) -> TrainState:
    cap, dev = model.capacity, model.params.xyz.device
    return TrainState(
        model=model,
        adam_m=zeros_like_params(model.params),
        adam_v=zeros_like_params(model.params),
        adam_step=0,
        grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev),
        max_radii2d=torch.zeros(cap, device=dev),
    )


def from_numpy(
    params: dict[str, np.ndarray],
    active: np.ndarray,
    adam_m: dict[str, np.ndarray],
    adam_v: dict[str, np.ndarray],
    adam_step: int,
    grad_accum: np.ndarray,
    denom: np.ndarray,
    max_radii2d: np.ndarray,
    max_sh_degree: int = 1,
    active_sh_degree: int = 0,
    spatial_lr_scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> TrainState:
    """The port's train state from the JAX state's arrays as numpy: the
    model as `models.gaussians.from_numpy` takes it, both moments as dicts
    keyed like `params`, and the step and densification statistics."""

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return TrainState(
        model=model_from_numpy(params, active, max_sh_degree, active_sh_degree,
                               spatial_lr_scale, device=device),
        adam_m=GaussianParams(**{n: tensor(adam_m[n]) for n in PARAM_NAMES}),
        adam_v=GaussianParams(**{n: tensor(adam_v[n]) for n in PARAM_NAMES}),
        adam_step=int(adam_step),
        grad_accum=tensor(grad_accum),
        denom=tensor(denom),
        max_radii2d=tensor(max_radii2d),
    )


def xyz_lr_fn(opt: OptimizationConfig, spatial_lr_scale: float):
    """reference `scene/gaussian_model.py:164-167`."""
    return expon_lr_schedule(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )


def group_lrs(opt: OptimizationConfig, xyz_lr) -> dict:
    """Per-group learning rates keyed by parameter name (reference
    `scene/gaussian_model.py:154-161`); `xyz_lr` a number or a 0-d tensor."""
    return dict(
        xyz=xyz_lr,
        f_dc=opt.feature_lr,
        f_rest=opt.feature_lr / 20.0,
        opacity=opt.opacity_lr,
        scaling=opt.scaling_lr,
        rotation=opt.rotation_lr,
    )


def bias_corrections(step: int) -> tuple[float, float]:
    """The factors by which the Adam step after `step` steps multiplies its
    moments: 1 / (1 - b1^t) and 1 / (1 - b2^t), t = step + 1, the powers in
    float32 as the JAX version computes them, each reciprocal taken in
    double and rounded to float32. That is what a card computes for
    `m / (1 - b1^t)` with a host number (measured on an H100 with PyTorch
    2.11: a multiply by the divisor's reciprocal, rounded from double), so
    a 0-d float32 tensor of the factor, a CUDA graph's input, keeps those
    bits; the CPU divides, which the factor matches to an ulp."""
    t = np.float32(step + 1)
    b1t = 1.0 - float(np.float32(ADAM_B1) ** t)
    b2t = 1.0 - float(np.float32(ADAM_B2) ** t)
    return float(np.float32(1.0 / b1t)), float(np.float32(1.0 / b2t))


@torch.no_grad()
def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    m: GaussianParams,
    v: GaussianParams,
    step: int,
    lrs: dict,
    active: torch.Tensor,
    corrections: tuple | None = None,
) -> int:
    """One Adam step with torch semantics (bias-corrected, eps added after
    the square root of the corrected second moment), masked to active rows
    so padded rows keep their sentinel values. Updates `params`, `m` and `v`
    in place; returns the new step count. `corrections` gives
    `bias_corrections(step)` (host numbers, or 0-d float32 tensors on the
    parameters' device, which a CUDA graph reads); a learning rate may be
    either too. On a card the kernel `b3dgs_adam_update` (one launch, the
    bits of `adam_update_torch`), on the CPU `adam_update_torch`."""
    device = params.xyz.device
    if device.type == "cpu":
        return adam_update_torch(params, grads, m, v, step, lrs, active, corrections)
    if device.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {device}")
    corrections = bias_corrections(step) if corrections is None else corrections
    launch("b3dgs_adam_update", device,
           *adam_kernel_args(params, grads, m, v, lrs, active, corrections))
    return step + 1


def _rate(name: str, x, device) -> tuple:
    """(number, pointer) of xyz's rate or a factor as the kernel takes it: a
    number as itself, a 0-d float32 tensor on `device` by its address."""
    if not isinstance(x, torch.Tensor):
        return float(x), None
    if x.shape != () or x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"adam_update: {name} must be a number or a 0-d float32 tensor on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return 0.0, x


def adam_kernel_args(params, grads, m, v, lrs: dict, active: torch.Tensor,
                     corrections: tuple) -> list:
    """`b3dgs_adam_update`'s arguments but the stream: per group (in
    PARAM_NAMES' order) p, g, m, v, the values a row and the rate (xyz's a
    number or a 0-d tensor, the others numbers), then the mask, the rows
    and the two factors. Raises unless every tensor is contiguous, float32
    (the mask bool) and on the parameters' device, and each group's four
    tensors share one shape of `rows` rows."""
    device, rows = params.xyz.device, active.shape[0]
    if active.dtype != torch.bool or active.shape != (rows,) or active.device != device \
            or not active.is_contiguous():
        raise ValueError(f"adam_update: the mask must be a contiguous (rows,) bool tensor on "
                         f"{device}, got {active.dtype} {tuple(active.shape)} on "
                         f"{active.device}")
    args = []
    for n in PARAM_NAMES:
        group = [getattr(x, n) for x in (params, grads, m, v)]
        shape = group[0].shape
        for t in group:
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() \
                    or t.shape != shape or shape[0] != rows:
                raise ValueError(
                    f"adam_update: {n}'s tensors must be contiguous float32 of one shape with "
                    f"{rows} rows on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ', not contiguous'}")
        if group[0].numel() >= 2**31:
            raise ValueError(f"adam_update: {n} holds {group[0].numel()} values, over 2^31 - 1")
        width = group[0].numel() // rows if rows else 0
        if n == "xyz":
            args += [*group, width, *_rate("the xyz rate", lrs[n], device)]
        elif isinstance(lrs[n], torch.Tensor):
            raise ValueError(f"adam_update: the {n} rate must be a number")
        else:
            args += [*group, width, float(lrs[n])]
    c1, c2 = corrections
    return [*args, active, rows, *_rate("c1", c1, device), *_rate("c2", c2, device)]


@torch.no_grad()
def adam_update_torch(
    params: GaussianParams,
    grads: GaussianParams,
    m: GaussianParams,
    v: GaussianParams,
    step: int,
    lrs: dict,
    active: torch.Tensor,
    corrections: tuple | None = None,
) -> int:
    """`adam_update` as the plain composition of PyTorch operations: the
    CPU's path and the kernel's yardstick on the card (18 device
    operations a group there)."""
    b1t_inv, b2t_inv = bias_corrections(step) if corrections is None else corrections
    for n in PARAM_NAMES:
        p, g, mi, vi = (getattr(x, n) for x in (params, grads, m, v))
        mask = active.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(mask, g, 0.0)
        mi.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
        vi.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
        p_new = p - lrs[n] * (mi * b1t_inv) / (torch.sqrt(vi * b2t_inv) + ADAM_EPS)
        p.copy_(torch.where(mask, p_new, p))
    return step + 1
