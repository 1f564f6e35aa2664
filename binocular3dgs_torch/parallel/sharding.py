"""Multi-rank execution: the render split into bands of tile rows over the
ranks of a `torch.distributed` process group.

Counterpart of `binocular3dgs_tpu/parallel/sharding.py`. A device of the
JAX mesh is a rank here, and one process holds one rank:

  * the gaussian parameters are replicated: every rank holds them alike
  * every rank runs the vertex stage, then bins and blends only its own
    band of `ceil(TH / ranks)` tile rows (`render_tiled`'s band mode); the
    band's pair capacity shrinks with the rank count
    (`RasterConfig.band_pairs_per_gaussian`)
  * the bands are all-gathered into the full image, so the loss (whose SSIM
    windows cross bands) is computed alike on every rank
  * backward: the gather hands each rank the cotangent of its own band, the
    blend backward runs band-local, and the parameters' and the carrier's
    cotangents are summed over the ranks once per render (the transpose of
    the replicated inputs of JAX's `shard_map`)

`shard_gaussians` also splits the vertex stage: each rank projects
`capacity / ranks` gaussians and the projected fields are all-gathered (their
cotangents reduce-scattered). `shard_adam` keeps each rank's rows of the Adam
moments only, updates those rows of the parameters and all-gathers them.

Transport: the caller initialises the process group and so picks its
backend. NCCL runs the collectives on the card's tensors (one rank per
card). gloo's collectives on CUDA tensors are only broadcast and all_reduce,
and NCCL refuses two ranks on one card, so with gloo every collective runs
on host copies of the tensors (`Mesh.staged`): that is how ranks share one
card. On the CPU gloo runs on the tensors themselves.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import Config, RasterConfig
from ..core.camera import Camera
from ..models.gaussians import PARAM_NAMES, GaussianModel, GaussianParams
from ..ops.binning import tile_grid
from ..ops.project import ProjectedGaussians, project_for_render
from ..ops.rasterize import rasterize_projected
from ..ops.rasterize_reference import RenderOutput
from ..train.state import TrainState, adam_update
from ..train.step import make_train_step


@dataclass
class Mesh:
    """The ranks that share one render: a process group, this process's
    rank in it, the group's size, the device this rank computes on and the
    group's backend."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Collectives run on host copies (gloo ranks on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _run(self, op, x: torch.Tensor) -> torch.Tensor:
        """op(buffer) on a copy of x (on the host when staged), the result
        back on this rank's device. Every collective goes through here."""
        buf = x.detach().to("cpu" if self.staged else x.device, copy=True).contiguous()
        return op(buf).to(self.device)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        def run(buf):
            dist.all_reduce(buf, op=op, group=self.group)
            return buf
        return self._run(run, x)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) of every rank -> (ranks * n, ...), in rank order."""
        def run(buf):
            out = buf.new_empty((self.size * buf.shape[0], *buf.shape[1:]))
            dist.all_gather_into_tensor(out, buf, group=self.group)
            return out
        return self._run(run, x)

    def reduce_scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(ranks * n, ...) of every rank, summed over the ranks -> this
        rank's n rows."""
        def run(buf):
            out = buf.new_empty((buf.shape[0] // self.size, *buf.shape[1:]))
            dist.reduce_scatter_tensor(out, buf, group=self.group)
            return out
        return self._run(run, x)


def make_mesh(device: str | torch.device = "cuda", group=None) -> Mesh:
    """The mesh of an initialised process group (the default group unless
    `group` is given); the caller runs `init_process_group`. `device` "cuda"
    without an index is the current card (`torch.cuda.set_device`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    group = group or dist.group.WORLD
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device, backend)


class _Replicated(torch.autograd.Function):
    """Identity on tensors every rank holds alike (the render's parameters
    and carrier); the backward sums their cotangents over the ranks, one
    all_reduce for all of them: each rank's band gives only part of them."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh, ctx.shapes = mesh, [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        sizes = [s.numel() for s in ctx.shapes]
        return (None, *(g.reshape(s) for g, s in zip(flat.split(sizes), ctx.shapes)))


class _GatherBands(torch.autograd.Function):
    """All ranks' bands (h, ...) -> (ranks * h, ...) in rank order; the
    backward hands each rank the rows of its own band, with no
    communication: the loss on the gathered image is the same on every
    rank. (torch.distributed.nn's all_gather reduce-scatters instead, which
    would multiply a replicated loss's gradients by the rank count.)"""

    @staticmethod
    def forward(ctx, mesh, band):
        ctx.lo, ctx.h = mesh.rank * band.shape[0], band.shape[0]
        return mesh.all_gather_rows(band)

    @staticmethod
    def backward(ctx, grad):
        return None, grad[ctx.lo:ctx.lo + ctx.h]


class _GatherRows(torch.autograd.Function):
    """All ranks' shards of rows -> every row; the backward sums each row's
    cotangent over the ranks and hands each rank its shard (reduce-scatter):
    every rank's band gives part of every gaussian's cotangent."""

    @staticmethod
    def forward(ctx, mesh, rows):
        ctx.mesh = mesh
        return mesh.all_gather_rows(rows)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.mesh.reduce_scatter_rows(grad.contiguous())


def _gather_projected(mesh: Mesh, proj: ProjectedGaussians) -> ProjectedGaussians:
    """Every rank's projected shard -> the whole projected set: the 13 float
    fields of a gaussian packed into one row and gathered at once (the
    bool `visible` is radius > 0)."""
    packed = torch.cat([proj.mean2d, proj.depth[:, None], proj.conic, proj.color,
                        proj.opacity[:, None], proj.radius[:, None].detach(),
                        proj.bin_extent.detach()], dim=1)
    rows = _GatherRows.apply(mesh, packed)
    mean2d, depth, conic, color, opacity, radius, bin_extent = rows.split(
        [2, 1, 3, 3, 1, 1, 2], dim=1)
    radius = radius[:, 0].detach()
    return ProjectedGaussians(mean2d=mean2d, depth=depth[:, 0], conic=conic, color=color,
                              opacity=opacity[:, 0], radius=radius, visible=radius > 0,
                              bin_extent=bin_extent.detach())


def _rows_of(model: GaussianModel, lo: int, hi: int) -> GaussianModel:
    params = GaussianParams(**{n: getattr(model.params, n)[lo:hi] for n in PARAM_NAMES})
    return dataclasses.replace(model, params=params, active=model.active[lo:hi])


def make_sharded_render(
    mesh: Mesh,
    width: int,
    height: int,
    raster: RasterConfig | None = None,
    shard_gaussians: bool = False,
):
    """A render function with `render_tiled`'s call (camera, model, bg,
    mean2d_carrier=None) that renders this rank's band of tile rows and
    returns the full image, the same on every rank. `num_pairs` and
    `max_tile_pairs` are the largest over the ranks, against the band's
    pair capacity `pair_capacity`."""
    raster = raster or RasterConfig()
    ts = raster.tile_size
    _, TH = tile_grid(width, height, ts)
    rows = -(-TH // mesh.size)
    # each rank bins only its band: a smaller pair capacity (3x slack over
    # a uniform split for bands that hold more of the scene)
    ppg = raster.band_pairs_per_gaussian
    if ppg is None:
        ppg = max(4, -(-raster.pairs_per_gaussian * 3 // mesh.size))
    raster = dataclasses.replace(raster, pairs_per_gaussian=ppg)
    warned = []

    def render_fn(camera: Camera, model: GaussianModel, bg, mean2d_carrier=None):
        dev = mesh.device
        camera, model = camera.to(dev), model.to(dev)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        cap = model.capacity
        carrier = (torch.zeros(cap, 2, device=dev) if mean2d_carrier is None
                   else mean2d_carrier)
        *leaves, carrier = _Replicated.apply(
            mesh, *(getattr(model.params, n) for n in PARAM_NAMES), carrier)
        model = dataclasses.replace(model, params=GaussianParams(**dict(zip(PARAM_NAMES, leaves))))

        split = shard_gaussians and cap % mesh.size == 0
        if shard_gaussians and not split and not warned:
            warned.append(True)
            warnings.warn(f"shard_gaussians=True but capacity {cap} is not divisible by "
                          f"{mesh.size} ranks; the vertex stage runs replicated", stacklevel=2)
        if split:
            n = cap // mesh.size
            lo = mesh.rank * n
            proj = _gather_projected(mesh, project_for_render(
                camera, _rows_of(model, lo, lo + n), raster, carrier[lo:lo + n]))
        else:
            proj = project_for_render(camera, model, raster, carrier)
        out = rasterize_projected(camera, proj, bg, raster, tile_row_start=mesh.rank * rows,
                                  tile_rows=rows)
        # (h, 5, W) band rows: r, g, b, depth, alpha; gathered at once
        band = torch.cat([out.image, out.depth[None], out.alpha[None]]).transpose(0, 1)
        full = _GatherBands.apply(mesh, band.contiguous())[:height].transpose(0, 1)
        pressure = mesh.all_reduce(torch.stack([out.num_pairs, out.max_tile_pairs]),
                                   dist.ReduceOp.MAX)
        return RenderOutput(image=full[:3], depth=full[3], alpha=full[4], radii=proj.radius,
                            visible=proj.visible, num_pairs=pressure[0],
                            max_tile_pairs=pressure[1], pair_capacity=out.pair_capacity)

    return render_fn


def _moment_rows(mesh: Mesh, capacity: int) -> tuple[int, int]:
    if capacity % mesh.size:
        raise ValueError(f"shard_adam needs a capacity divisible by the {mesh.size} ranks, "
                         f"got {capacity}")
    n = capacity // mesh.size
    return mesh.rank * n, n


def shard_opt_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The state with this rank's rows of the Adam moments only (copies); a
    state whose moments are already sharded is returned as it is."""
    lo, n = _moment_rows(mesh, state.model.capacity)
    if state.adam_m.xyz.shape[0] == n:
        return state

    def rows(tree):
        return GaussianParams(**{k: getattr(tree, k)[lo:lo + n].clone() for k in PARAM_NAMES})

    return state.replace(adam_m=rows(state.adam_m), adam_v=rows(state.adam_v))


def gather_opt_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The replicated state of a sharded one (for checkpoints and the
    converters): the moments all-gathered."""
    def full(tree):
        return GaussianParams(**{k: mesh.all_gather_rows(getattr(tree, k)) for k in PARAM_NAMES})

    return state.replace(adam_m=full(state.adam_m), adam_v=full(state.adam_v))


def sharded_adam(mesh: Mesh):
    """`adam_update` on this rank's rows: `m` and `v` hold capacity / ranks
    rows, the rows of the parameters are updated in place (views), then all
    ranks' rows are all-gathered into the replicated parameters (one
    collective for the six fields)."""

    def update(params, grads, m, v, step, lrs, active, corrections=None):
        lo, n = _moment_rows(mesh, params.xyz.shape[0])
        if m.xyz.shape[0] != n:
            raise ValueError(f"sharded Adam moments hold {m.xyz.shape[0]} rows, expected {n}")

        def rows(tree):
            return GaussianParams(**{k: getattr(tree, k)[lo:lo + n] for k in PARAM_NAMES})

        t = adam_update(rows(params), rows(grads), m, v, step, lrs, active[lo:lo + n],
                        corrections)
        fields = [getattr(params, k) for k in PARAM_NAMES]
        widths = [f[0].numel() for f in fields]
        mine = torch.cat([f[lo:lo + n].reshape(n, -1) for f in fields], dim=1)
        for f, g in zip(fields, mesh.all_gather_rows(mine).split(widths, dim=1)):
            f.copy_(g.reshape(f.shape))
        return t

    return update


def make_sharded_train_step(
    cfg: Config,
    mesh: Mesh,
    width: int,
    height: int,
    spatial_lr_scale: float,
    binocular: bool = False,
    use_alpha_weight: bool = False,
    shard_gaussians: bool = False,
    shard_adam: bool = False,
):
    """`make_train_step` with the band-sharded render. With `shard_adam` the
    step keeps this rank's rows of the moments only: a replicated state is
    sharded on entry (`shard_opt_state`), the state it returns stays
    sharded, and the update equals the replicated one bit for bit."""
    render_fn = make_sharded_render(mesh, width, height, cfg.raster,
                                    shard_gaussians=shard_gaussians)
    step = make_train_step(render_fn, cfg, spatial_lr_scale, binocular=binocular,
                           use_alpha_weight=use_alpha_weight,
                           adam_fn=sharded_adam(mesh) if shard_adam else None)
    if not shard_adam:
        return step

    def sharded_step(state, *args):
        return step(shard_opt_state(state, mesh), *args)

    return sharded_step
