"""Configuration dataclasses.

Names and defaults mirror `binocular3dgs_tpu/config.py` (itself the
reference flag system) so a `cfg_args.json` written by either package loads
in the other. The JAX `backend` choice, the TPU-only raster knobs
(`pallas_chunk`, `pallas_tile_group`, `grad_sort_bf16`, `max_pairs_per_tile`,
`chunk`) are not carried: unknown keys are ignored on load. The port has one
blend path, whose wrapper launches the CUDA kernel for CUDA tensors and its
plain version for CPU ones. `TrainConfig.fused_steps` is read and ignored:
the port's trainer runs one step per iteration (train/loop.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    sh_degree: int = 1
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationConfig:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


@dataclass
class TrainConfig:
    opacity_decay: bool = True
    opacity_decay_factor: float = 0.995
    cam_trans_dist: float = 0.4
    binocular_consistency: bool = True
    shift_cam_start: int = 20_000
    dataset_name: str = "LLFF"
    n_views: int = 3
    suffix: str | None = None
    test_iterations: tuple[int, ...] = (30_000,)
    save_iterations: tuple[int, ...] = (30_000,)
    checkpoint_iterations: tuple[int, ...] = ()
    start_checkpoint: str | None = None
    seed: int = 0
    fused_steps: int = 0


@dataclass
class RasterConfig:
    """Rasterizer knobs (the CUDA reference hardcodes these)."""

    tile_size: int = 16  # pixels per tile side
    # Static capacity of the (tile, gaussian) pair list as a multiple of the
    # gaussian capacity. Overflowing pairs are dropped (reported via num_pairs).
    pairs_per_gaussian: int = 12
    # Ceiling of the trainer's pair-capacity growth (train/loop.py doubles
    # pairs_per_gaussian up to it when the wanted pairs near capacity).
    max_pairs_per_gaussian: int = 96
    # The compositing constants of the CUDA rasterizer contract (SURVEY.md
    # §3.5). Recorded for cfg_args.json interchange; the blend kernels and
    # their plain versions fix them, as the JAX package's do.
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    alpha_clamp: float = 0.99
    dilation: float = 0.3  # screen-space low-pass added to cov2d diagonal
    znear_cull: float = 0.2


@dataclass
class ParallelConfig:
    view_axis: int = 1
    tile_axis: int = 1


@dataclass
class GaussianCapacityConfig:
    initial_margin: float = 2.0
    growth_trigger: float = 0.9
    max_capacity: int = 4_000_000


_SECTIONS = {
    "model": ModelConfig,
    "pipeline": PipelineConfig,
    "opt": OptimizationConfig,
    "train": TrainConfig,
    "raster": RasterConfig,
    "parallel": ParallelConfig,
    "capacity": GaussianCapacityConfig,
}


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    raster: RasterConfig = field(default_factory=RasterConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    capacity: GaussianCapacityConfig = field(default_factory=GaussianCapacityConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        sections = {}
        for name, klass in _SECTIONS.items():
            names = {f.name for f in dataclasses.fields(klass)}
            kwargs = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in raw.get(name, {}).items() if k in names}
            sections[name] = klass(**kwargs)
        return cls(**sections)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_json())


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config.from_json(f.read())
