"""Host-side training loop.

Counterpart of `binocular3dgs_tpu/train/loop.py` (reference
`train.py:35-202`): per-iteration view choice with a seeded Python RNG,
SH degree bump every 1000 iterations, the binocular branch after
`shift_cam_start`, densification every `densification_interval` after
`densify_from_iter`, gaussian-capacity growth (next power of two) and
pair-capacity growth, PSNR/L1 report at `test_iterations` and PLY snapshots
at `save_iterations`.

It runs one step per iteration: the JAX trainer's fused spans
(`TrainConfig.fused_steps`, `_fused_span`) amortize JAX dispatch and are not
carried over; the config key is read and ignored. The binocular shift and
the split noise come from one `torch.Generator` on the CPU seeded with
`cfg.train.seed`, so a run draws the same numbers on any device.
Checkpoints (npz save and resume) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..data.dataset import Scene, View
from ..models import densify as densify_mod
from ..models.gaussians import create_from_pcd, grow_capacity, next_pow2, pad_rows, save_ply
from ..ops.losses import l1_loss, psnr
from ..ops.rasterize import render_tiled
from .state import TrainState, init_train_state
from .step import make_train_step


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

    def __init__(self, cfg: Config, scene: Scene, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.scene = scene
        self.device = resolve_device(device)
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
        use_alpha_weight = any(bool((w > 0).any()) for w in weights)
        self.alpha_weights = [torch.from_numpy(w).to(self.device) for w in weights]
        self.cams = [v.camera.to(self.device) for v in self.views]
        self.bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                             device=self.device)
        self.steps = {
            binocular: make_train_step(self.render, cfg, model.spatial_lr_scale,
                                       binocular=binocular, use_alpha_weight=use_alpha_weight)
            for binocular in (False, True)
        }
        self.rng = random.Random(cfg.train.seed)
        self.generator = torch.Generator().manual_seed(cfg.train.seed)
        self.log: list[TrainerLogEntry] = []

    def render(self, camera, model, bg, mean2d_carrier=None):
        """render_tiled with the trainer's (possibly grown) raster config."""
        return render_tiled(camera, model, bg, raster=self.raster, device=self.device,
                            mean2d_carrier=mean2d_carrier)

    def _draw_trans(self) -> float:
        """The binocular shift d ~ U(0, cam_trans_dist) with a random sign
        (reference `train.py:125-130`)."""
        u, s = torch.rand(2, generator=self.generator).tolist()
        return u * self.cfg.train.cam_trans_dist * (1.0 if s < 0.5 else -1.0)

    def train(self, iterations: int | None = None, progress=None, first_iteration: int = 1):
        cfg = self.cfg
        opt = cfg.opt
        iterations = iterations or opt.iterations
        densify_until = iterations if cfg.train.opacity_decay else opt.densify_until_iter
        last_log_t, last_log_it = time.time(), first_iteration - 1

        for iteration in range(first_iteration, iterations + 1):
            if iteration % 1000 == 0:
                self.state = self.state.replace(model=self.state.model.one_up_sh_degree())
            binocular = (
                cfg.train.binocular_consistency and iteration > cfg.train.shift_cam_start
            )
            view_idx = self.rng.randrange(len(self.views))
            trans = self._draw_trans() if binocular else None
            self.state, metrics = self.steps[binocular](
                self.state, self.cams[view_idx], self.gt_images[view_idx],
                self.alpha_weights[view_idx], iteration, trans, self.bg,
            )
            self._maybe_grow_pair_capacity(metrics, iteration)

            if (opt.densify_from_iter < iteration < densify_until
                    and iteration % opt.densification_interval == 0):
                self._densify()

            # --detect_anomaly analogue (reference train.py:272,297)
            if cfg.pipeline.debug and not np.isfinite(float(metrics.loss)):
                raise FloatingPointError(
                    f"non-finite loss {float(metrics.loss)} at iteration {iteration}"
                )

            if progress is not None and iteration % 10 == 0:
                now = time.time()
                entry = TrainerLogEntry(
                    iteration=iteration,
                    loss=float(metrics.loss),
                    disparity_loss=float(metrics.disparity_loss),
                    points=int(self.state.model.count()),
                    iters_per_sec=(iteration - last_log_it) / max(now - last_log_t, 1e-9),
                )
                last_log_t, last_log_it = now, iteration
                self.log.append(entry)
                progress(entry)

            if iteration in cfg.train.test_iterations:
                self.report(iteration)
            if iteration in cfg.train.save_iterations:
                self.save(iteration)
        return self.state

    def _maybe_grow_pair_capacity(self, metrics, iteration: int):
        """When the wanted (tile, gaussian) pairs near the capacity, the
        deepest splats would vanish from renders and gradients: double
        pairs_per_gaussian up to max_pairs_per_gaussian. The port's blend
        reads whole tile segments, so the JAX max_pairs_per_tile branch has
        no counterpart."""
        cap = metrics.pair_capacity
        wanted = int(metrics.num_pairs)
        raster = self.raster
        if (wanted > cap * self.cfg.capacity.growth_trigger
                and raster.pairs_per_gaussian < raster.max_pairs_per_gaussian):
            self.raster = dataclasses.replace(
                raster, pairs_per_gaussian=min(raster.pairs_per_gaussian * 2,
                                               raster.max_pairs_per_gaussian))
            print(f"[ITER {iteration}] pair capacity grown: pairs_per_gaussian="
                  f"{self.raster.pairs_per_gaussian} (wanted {wanted} pairs)")

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
            results[name] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
            print(f"\n[ITER {iteration}] Evaluating {name}: L1 {np.mean(l1s)} "
                  f"PSNR {np.mean(psnrs)}")
        return results

    def save(self, iteration: int):
        if not self.cfg.model.model_path:
            return
        save_ply(self.state.model, os.path.join(
            self.cfg.model.model_path, f"point_cloud/iteration_{iteration}/point_cloud.ply"))
