"""Host-side training loop.

Counterpart of `binocular3dgs_tpu/train/loop.py` (reference
`train.py:35-202`): per-iteration view choice with a seeded Python RNG,
SH degree bump every 1000 iterations, the binocular branch after
`shift_cam_start`, densification every `densification_interval` after
`densify_from_iter`, gaussian-capacity growth (next power of two) and
pair-capacity growth, PSNR/L1 report at `test_iterations` and PLY snapshots
at `save_iterations`, npz checkpoints at `checkpoint_iterations`.

Steps run in spans, as the JAX trainer's fused spans (`_fused_span`,
JAX `train/loop.py:195-223`): an SH bump or the binocular flip starts a
span, densification, a report, a save or a checkpoint may only end one, and
a span holds at most `TrainConfig.fused_steps` steps (the densification
interval when 0). Inside a span no device value is read: the host queues
step i+1 while the card runs step i, and the pair pressure is kept as a
running device maximum. At the span's end the host reads once (the pair
pressure and the logged losses together), grows the pair capacity,
densifies, logs and reports. So the pair capacity grows at a span's end, as
in the JAX trainer; `fused_steps=1` reads after every step. With
`cfg.pipeline.debug` every step's loss is read and checked. Views and the
binocular shift are host draws for every step, where the JAX fused path
draws views on the device: the view index from a `random.Random` and the
shift and split noise from one `torch.Generator` on the CPU, both seeded
with `cfg.train.seed`, so a run draws the same numbers on any device.

While a profiler traces, the loop records its ranges (`trainer.train`,
`trainer.fused_span`, `trainer.step` with its iteration, `trainer.read`,
`trainer.grow_pairs`, `trainer.densify`) and counts `trainer.host_reads`:
each read of a device value that its decisions, logs and reports need
(checkpoints and PLY snapshots are not counted); see tracing.py.

`render_fn` (JAX `Trainer(render_fn=)`) replaces the trainer's render, e.g.
by the dense oracle or parallel/sharding.py's band-sharded render. With
the trainer's own render, each step on a card is a replay of a CUDA graph
(train/step.py, `StepGraphs`); with a given `render_fn`, and on the CPU,
the steps run eagerly.

Checkpoints (`save_checkpoint`, `load_checkpoint`) use the JAX package's
npz layout key for key, dtype for dtype, padded rows included, so a
checkpoint written by either package resumes in the other. As in the JAX
package, a resumed trainer restarts its view RNG and its generator from the
seed, and its pair capacity from the config.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, tracing
from ..config import Config
from ..data.dataset import Scene, View
from ..models import densify as densify_mod
from ..models.gaussians import (
    PARAM_NAMES,
    create_from_pcd,
    grow_capacity,
    next_pow2,
    pad_rows,
    save_ply,
)
from ..ops.losses import l1_loss, psnr
from ..ops.rasterize import render_tiled
from .state import TrainState, from_numpy, init_train_state
from .step import StepGraphs, make_train_step


def dtu_background_mask(gt_image: np.ndarray, is_scan110: bool) -> np.ndarray:
    """Dark-region background mask with a 50-row vertical smear (reference
    `train.py:111-121`, from DNGaussian). gt: (H, W, 3)."""
    thr = (15.0 if is_scan110 else 30.0) / 255.0
    mask = (gt_image.max(axis=-1) < thr).astype(np.float32)
    orig = mask.copy()
    for i in range(1, 50):
        mask[i:] *= orig[:-i]
    return mask


def alpha_weight_for_view(cfg: Config, view: View) -> np.ndarray:
    """Per-pixel weight of the alpha loss (reference `train.py:139-143`)."""
    H, W = view.camera.height, view.camera.width
    if view.alpha_mask is not None:
        return (1.0 - view.alpha_mask[..., 0]).astype(np.float32)
    if cfg.train.dataset_name == "DTU" and view.image is not None:
        return dtu_background_mask(view.image, "scan110" in cfg.model.source_path)
    return np.zeros((H, W), np.float32)


@dataclass
class TrainerLogEntry:
    iteration: int
    loss: float
    disparity_loss: float
    points: int
    iters_per_sec: float


class Trainer:
    """Drives training of one scene on `device`."""

    def __init__(self, cfg: Config, scene: Scene, device: str | torch.device = "cuda",
                 render_fn=None):
        self.cfg = cfg
        self.scene = scene
        self.device = resolve_device(device)
        self.render_fn = render_fn
        # The trainer's own raster config: pair-capacity growth replaces this
        # copy, never the (possibly shared) cfg.raster.
        self.raster = dataclasses.replace(cfg.raster)
        model = create_from_pcd(
            scene.scene_info.point_cloud,
            spatial_lr_scale=scene.cameras_extent,
            max_sh_degree=cfg.model.sh_degree,
            capacity_margin=cfg.capacity.initial_margin,
            device=self.device,
        )
        self.state: TrainState = init_train_state(model)

        self.views = scene.train_views
        if not self.views:
            raise ValueError("the scene has no training views")
        # host images are (H, W, 3); device tensors are channels-first
        self.gt_images = [torch.from_numpy(np.ascontiguousarray(v.image.transpose(2, 0, 1)))
                          .to(self.device) for v in self.views]
        weights = [alpha_weight_for_view(cfg, v) for v in self.views]
        self.use_alpha_weight = any(bool((w > 0).any()) for w in weights)
        self.alpha_weights = [torch.from_numpy(w).to(self.device) for w in weights]
        self.cams = [v.camera.to(self.device) for v in self.views]
        self.bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                             device=self.device)
        self._build_steps(model.spatial_lr_scale)
        self.rng = random.Random(cfg.train.seed)
        self.generator = torch.Generator().manual_seed(cfg.train.seed)
        self.log: list[TrainerLogEntry] = []

    def render(self, camera, model, bg, mean2d_carrier=None):
        """`render_fn` when one was given, else render_tiled with the
        trainer's (possibly grown) raster config."""
        if self.render_fn is not None:
            return self.render_fn(camera, model, bg, mean2d_carrier=mean2d_carrier)
        return render_tiled(camera, model, bg, raster=self.raster, device=self.device,
                            mean2d_carrier=mean2d_carrier)

    def _build_steps(self, spatial_lr_scale: float):
        """The binocular and the plain step; with the trainer's own render,
        each replayed as a CUDA graph on a card (`StepGraphs`: its key reads
        the pair capacity the trainer grows)."""
        self.steps = {
            binocular: make_train_step(self.render, self.cfg, spatial_lr_scale,
                                       binocular=binocular,
                                       use_alpha_weight=self.use_alpha_weight)
            for binocular in (False, True)
        }
        if self.render_fn is None:
            graphs = StepGraphs(lambda: self.raster)
            self.steps = {b: graphs.wrap(step) for b, step in self.steps.items()}

    def load_checkpoint(self, path: str) -> int:
        """Replace the state with a checkpoint's (its capacity, SH degrees and
        spatial_lr_scale) and return the checkpoint's iteration."""
        self.state, iteration = load_checkpoint(path, self.device)
        self._build_steps(self.state.model.spatial_lr_scale)
        return iteration

    def _draw_trans(self) -> float:
        """The binocular shift d ~ U(0, cam_trans_dist) with a random sign
        (reference `train.py:125-130`)."""
        u, s = torch.rand(2, generator=self.generator).tolist()
        return u * self.cfg.train.cam_trans_dist * (1.0 if s < 0.5 else -1.0)

    def _fused_span(self, it: int, iterations: int, binocular_from: int) -> int:
        """The longest span of steps from `it` that crosses no protocol
        boundary: the JAX trainer's `_fused_span`, line for line."""
        cfg, opt = self.cfg, self.cfg.opt
        cap = cfg.train.fused_steps if cfg.train.fused_steps > 0 else opt.densification_interval
        n = min(cap, iterations - it + 1)
        # the SH bump happens at the start of iteration j for j % 1000 == 0
        next_bump = (it // 1000 + 1) * 1000
        n = min(n, next_bump - it)
        # the binocular branch turns on at iteration shift_cam_start + 1
        if cfg.train.binocular_consistency and it <= cfg.train.shift_cam_start:
            n = min(n, binocular_from - it)
        # densification runs after iteration j (j % interval == 0, in range)
        densify_until = iterations if cfg.train.opacity_decay else opt.densify_until_iter
        interval = opt.densification_interval
        j = (it // interval + (0 if it % interval == 0 else 1)) * interval
        while j <= opt.densify_from_iter:  # skip triggers before the range
            j += interval
        if it <= j < densify_until:
            n = min(n, j - it + 1)
        # host-side events after iteration j
        for marks in (cfg.train.test_iterations, cfg.train.save_iterations,
                      cfg.train.checkpoint_iterations):
            for m in marks:
                if m >= it:
                    n = min(n, m - it + 1)
        return max(n, 1)

    @tracing.region("trainer.train")
    def train(self, iterations: int | None = None, progress=None, first_iteration: int = 1):
        cfg = self.cfg
        opt = cfg.opt
        iterations = iterations or opt.iterations
        densify_until = iterations if cfg.train.opacity_decay else opt.densify_until_iter
        binocular_from = cfg.train.shift_cam_start + 1
        last_read_t, last_read_it = time.time(), first_iteration - 1

        iteration = first_iteration
        while iteration <= iterations:
            last_it = iteration + self._fused_span(iteration, iterations, binocular_from) - 1
            with tracing.region("trainer.fused_span", first=iteration, last=last_it):
                if iteration % 1000 == 0:
                    self.state = self.state.replace(model=self.state.model.one_up_sh_degree())
                binocular = (
                    cfg.train.binocular_consistency and iteration > cfg.train.shift_cam_start
                )
                num_pairs, max_tile_pairs, logged = None, None, []
                for it in range(iteration, last_it + 1):
                    with tracing.region("trainer.step", iteration=it):
                        view_idx = self.rng.randrange(len(self.views))
                        trans = self._draw_trans() if binocular else None
                        self.state, metrics = self.steps[binocular](
                            self.state, self.cams[view_idx], self.gt_images[view_idx],
                            self.alpha_weights[view_idx], it, trans, self.bg,
                        )
                    # the span's pair pressure, kept on the device
                    if num_pairs is None:
                        num_pairs, max_tile_pairs = metrics.num_pairs, metrics.max_tile_pairs
                    else:
                        num_pairs = torch.maximum(num_pairs, metrics.num_pairs)
                        max_tile_pairs = torch.maximum(max_tile_pairs, metrics.max_tile_pairs)
                    if cfg.pipeline.debug:
                        self._check_loss(metrics, it)
                    if progress is not None and it % 10 == 0:
                        logged.append((it, metrics))

                # the span's one read: the pair pressure, the logged losses and
                # the point count
                values = [num_pairs, max_tile_pairs]
                for _, m in logged:
                    values += [m.loss, m.disparity_loss]
                if logged:
                    values.append(self.state.model.count())
                with tracing.region("trainer.read"):
                    read = torch.stack([v.to(torch.float64) for v in values]).tolist()
                tracing.count("trainer.host_reads", 1)
                self._maybe_grow_pair_capacity(int(read[0]), int(read[1]), metrics.pair_capacity,
                                               last_it)

                densify = (opt.densify_from_iter < last_it < densify_until
                           and last_it % opt.densification_interval == 0)
                if densify:
                    self._densify()

                if logged:
                    now = time.time()
                    ips = (last_it - last_read_it) / max(now - last_read_t, 1e-9)
                    last_read_t, last_read_it = now, last_it
                    for k, (it, _) in enumerate(logged):
                        points = int(read[-1])
                        if it == last_it and densify:
                            points = int(self.state.model.count())
                            tracing.count("trainer.host_reads", 1)
                        entry = TrainerLogEntry(iteration=it, loss=read[2 + 2 * k],
                                                disparity_loss=read[3 + 2 * k], points=points,
                                                iters_per_sec=ips)
                        self.log.append(entry)
                        progress(entry)

                if last_it in cfg.train.test_iterations:
                    self.report(last_it)
                if last_it in cfg.train.save_iterations:
                    self.save(last_it)
                if last_it in cfg.train.checkpoint_iterations:
                    self.save_checkpoint(last_it)
            iteration = last_it + 1
        return self.state

    def _check_loss(self, metrics, iteration: int):
        """--detect_anomaly analogue (reference train.py:272,297): on a
        non-finite loss, dump the state, then abort."""
        loss = float(metrics.loss)
        tracing.count("trainer.host_reads", 1)
        if not np.isfinite(loss):
            path = os.path.join(self.cfg.model.model_path or ".", f"anomaly_{iteration}.npz")
            save_checkpoint(self.state, iteration, path)
            raise FloatingPointError(
                f"non-finite loss {loss} at iteration {iteration}; state dumped to {path}")

    @tracing.region("trainer.grow_pairs")
    def _maybe_grow_pair_capacity(self, wanted: int, max_tile: int, cap: int, iteration: int):
        """When the wanted (tile, gaussian) pairs near the capacity, the
        deepest splats would vanish from renders and gradients: double
        pairs_per_gaussian up to max_pairs_per_gaussian. The port's blend
        reads whole tile segments, so the JAX max_pairs_per_tile branch has
        no counterpart. A given `render_fn` holds its own capacity, which
        the trainer does not grow."""
        raster = self.raster
        if (self.render_fn is None and wanted > cap * self.cfg.capacity.growth_trigger
                and raster.pairs_per_gaussian < raster.max_pairs_per_gaussian):
            self.raster = dataclasses.replace(
                raster, pairs_per_gaussian=min(raster.pairs_per_gaussian * 2,
                                               raster.max_pairs_per_gaussian))
            print(f"[ITER {iteration}] pair capacity grown: pairs_per_gaussian="
                  f"{self.raster.pairs_per_gaussian} (wanted {wanted} pairs, max tile "
                  f"{max_tile})")

    @tracing.region("trainer.densify")
    def _densify(self):
        cfg = self.cfg
        # reference train.py:183-186: the binocular protocol forces the size
        # threshold to None
        result = densify_mod.densify_and_prune(
            self.state,
            grad_threshold=cfg.opt.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.scene.cameras_extent,
            percent_dense=cfg.opt.percent_dense,
            generator=self.generator,
            max_screen_size=None,
        )
        self.state = result.state
        cap = self.state.model.capacity
        if (result.n_wanted > cap * cfg.capacity.growth_trigger
                and cap < cfg.capacity.max_capacity):
            new_cap = min(next_pow2(cap * 2), cfg.capacity.max_capacity)
            st = self.state

            def pad_tree(tree):
                return dataclasses.replace(tree, **{
                    f.name: pad_rows(getattr(tree, f.name), new_cap)
                    for f in dataclasses.fields(tree)})

            self.state = st.replace(
                model=grow_capacity(st.model, new_cap),
                adam_m=pad_tree(st.adam_m),
                adam_v=pad_tree(st.adam_v),
                grad_accum=pad_rows(st.grad_accum, new_cap),
                denom=pad_rows(st.denom, new_cap),
                max_radii2d=pad_rows(st.max_radii2d, new_cap),
            )

    @torch.no_grad()
    def report(self, iteration: int):
        """reference `training_report` (`train.py:226-261`): mean L1 and
        PSNR over the test views and five train views."""
        results = {}
        for name, views in (
            ("test", self.scene.test_views),
            ("train", [self.views[i % len(self.views)] for i in range(5, 30, 5)]),
        ):
            if not views:
                continue
            l1s, psnrs = [], []
            for v in views:
                out = self.render(v.camera.to(self.device), self.state.model, self.bg)
                img = torch.clamp(out.image, 0.0, 1.0)
                gt = torch.clamp(torch.from_numpy(np.ascontiguousarray(
                    v.image.transpose(2, 0, 1))).to(self.device), 0.0, 1.0)
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                tracing.count("trainer.host_reads", 2)
            results[name] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
            print(f"\n[ITER {iteration}] Evaluating {name}: L1 {np.mean(l1s)} "
                  f"PSNR {np.mean(psnrs)}")
        return results

    def save(self, iteration: int):
        if not self.cfg.model.model_path:
            return
        save_ply(self.state.model, os.path.join(
            self.cfg.model.model_path, f"point_cloud/iteration_{iteration}/point_cloud.ply"))

    def save_checkpoint(self, iteration: int):
        if not self.cfg.model.model_path:
            return
        save_checkpoint(self.state, iteration,
                        os.path.join(self.cfg.model.model_path, f"chkpnt{iteration}.npz"))


def save_checkpoint(state: TrainState, iteration: int, path: str) -> None:
    """The whole training state as the JAX package's npz (reference
    `capture()`, `scene/gaussian_model.py:61-75`): `params.*`, `adam_m.*`,
    `adam_v.*` (float32, every capacity row), `active` (bool), `adam_step`
    (0-d int32), `grad_accum`, `denom`, `max_radii2d` (float32), `meta`
    ([iteration, active_sh_degree, max_sh_degree], int64) and
    `spatial_lr_scale` (0-d float64)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(t):
        return t.detach().cpu().numpy()

    model = state.model
    arrays = {}
    for prefix, tree in (("params", model.params), ("adam_m", state.adam_m),
                         ("adam_v", state.adam_v)):
        for n in PARAM_NAMES:
            arrays[f"{prefix}.{n}"] = host(getattr(tree, n))
    arrays["active"] = host(model.active)
    arrays["adam_step"] = np.asarray(state.adam_step, dtype=np.int32)
    for n in ("grad_accum", "denom", "max_radii2d"):
        arrays[n] = host(getattr(state, n))
    arrays["meta"] = np.asarray([iteration, model.active_sh_degree, model.max_sh_degree])
    arrays["spatial_lr_scale"] = np.asarray(float(model.spatial_lr_scale))
    np.savez(path, **arrays)


def find_latest_checkpoint(model_path: str) -> str | None:
    """The newest chkpnt<N>.npz in the model directory, or None."""
    if not model_path or not os.path.isdir(model_path):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(model_path)
             if (m := re.fullmatch(r"chkpnt(\d+)\.npz", f))]
    return os.path.join(model_path, max(found)[1]) if found else None


def load_checkpoint(path: str, device: str | torch.device = "cuda"):
    """(TrainState on `device`, iteration) of a checkpoint written by either
    package; the capacity and SH degrees are the checkpoint's."""
    with np.load(path) as z:
        def tree(prefix):
            return {n: z[f"{prefix}.{n}"] for n in PARAM_NAMES}

        iteration, active_sh, max_sh = (int(x) for x in z["meta"])
        state = from_numpy(
            tree("params"), z["active"], tree("adam_m"), tree("adam_v"), int(z["adam_step"]),
            z["grad_accum"], z["denom"], z["max_radii2d"], max_sh_degree=max_sh,
            active_sh_degree=active_sh, spatial_lr_scale=float(z["spatial_lr_scale"]),
            device=resolve_device(device))
    return state, iteration
