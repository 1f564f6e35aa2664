"""Gaussian point-cloud model state: fixed-capacity padded parameter buffers.

Counterpart of `binocular3dgs_tpu/models/gaussians.py`. Parameters live in
buffers of size `capacity >= count` with an `active` mask; padding rows carry
the same sentinels as the JAX package (zeros, log-scale -20, identity
quaternion) so both packages see the same buffers row for row. Feature layout
is [coeff, channel]: `f_dc` (N, 1, 3), `f_rest` (N, K-1, 3).

`create_from_pcd` builds the first model of a training run from a point
cloud; `grow_capacity` re-pads every buffer when densification fills it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.sh import num_sh_coeffs, rgb_to_sh
from ..data.ply import PointCloud, load_gaussian_ply, save_gaussian_ply
from ..ops.knn import mean_sq_dist_3nn

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
_FILL = {"scaling": -20.0}  # inactive rows render to nothing even if touched


@dataclass
class GaussianParams:
    """Raw (pre-activation) parameters, all shape (capacity, ...)."""

    xyz: torch.Tensor  # (N, 3)
    f_dc: torch.Tensor  # (N, 1, 3)
    f_rest: torch.Tensor  # (N, K-1, 3)
    opacity: torch.Tensor  # (N, 1) pre-sigmoid
    scaling: torch.Tensor  # (N, 3) log-scale
    rotation: torch.Tensor  # (N, 4) unnormalized quaternion (w, x, y, z)


@dataclass
class GaussianModel:
    params: GaussianParams
    active: torch.Tensor  # (N,) bool
    max_sh_degree: int = 1
    active_sh_degree: int = 0
    spatial_lr_scale: float = 1.0

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    def count(self) -> torch.Tensor:
        return self.active.sum()

    # -- activations (reference `scene/gaussian_model.py:26-41`) -------------
    def get_scaling(self):
        return torch.exp(self.params.scaling)

    def get_rotation(self):
        q = self.params.rotation
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    def get_opacity(self):
        return torch.sigmoid(self.params.opacity)

    def get_features(self):
        return torch.cat([self.params.f_dc, self.params.f_rest], dim=1)

    def to(self, device) -> "GaussianModel":
        params = GaussianParams(**{n: getattr(self.params, n).to(device) for n in PARAM_NAMES})
        return dataclasses.replace(self, params=params, active=self.active.to(device))

    def one_up_sh_degree(self) -> "GaussianModel":
        if self.active_sh_degree < self.max_sh_degree:
            return dataclasses.replace(self, active_sh_degree=self.active_sh_degree + 1)
        return self


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def from_numpy(
    params: dict[str, np.ndarray],
    active: np.ndarray,
    max_sh_degree: int = 1,
    active_sh_degree: int = 0,
    spatial_lr_scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """The port's model from the JAX model's parameters as numpy arrays:
    `params` holds xyz (N,3), f_dc (N,1,3), f_rest (N,K-1,3), opacity (N,1),
    scaling (N,3), rotation (N,4); `active` is (N,) bool. Buffers are taken
    as they are (capacity and padding included)."""
    tensors = {
        n: torch.tensor(np.asarray(params[n], dtype=np.float32), device=device)
        for n in PARAM_NAMES
    }
    return GaussianModel(
        params=GaussianParams(**tensors),
        active=torch.tensor(np.asarray(active, dtype=bool), device=device),
        max_sh_degree=int(max_sh_degree),
        active_sh_degree=int(active_sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
    )


def _from_rows(rows, capacity, max_sh_degree, active_sh_degree, spatial_lr_scale, device):
    """The model of `rows` (P-row numpy arrays keyed like PARAM_NAMES) in
    `capacity` rows: the first P active, the rest padded with the
    sentinels."""
    P = rows["xyz"].shape[0]
    padded = {}
    for n in PARAM_NAMES:
        out = np.full((capacity,) + rows[n].shape[1:], _FILL.get(n, 0.0), dtype=np.float32)
        out[:P] = rows[n]
        padded[n] = out
    padded["rotation"][P:, 0] = 1.0
    active = np.zeros(capacity, dtype=bool)
    active[:P] = True
    return from_numpy(padded, active, max_sh_degree, active_sh_degree, spatial_lr_scale,
                      device=device)


def create_from_pcd(
    pcd: PointCloud,
    spatial_lr_scale: float,
    max_sh_degree: int = 1,
    capacity: int | None = None,
    capacity_margin: float = 2.0,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """Initialize from a point cloud (reference `scene/gaussian_model.py:124-147`):
    colours into the DC SH band (higher bands zero), isotropic log-scales
    from sqrt of the mean 3-NN squared distance (clamped at 1e-7), identity
    quaternions, opacity sigmoid^-1(0.1); `capacity` rows, by default
    next_pow2(margin * P), padded with the sentinels."""
    points = np.asarray(pcd.points, dtype=np.float32)
    colors = np.asarray(pcd.colors, dtype=np.float32)
    P = points.shape[0]
    K = num_sh_coeffs(max_sh_degree)
    if capacity is None:
        capacity = next_pow2(int(P * capacity_margin))

    knn = mean_sq_dist_3nn(torch.from_numpy(points).to(device)).cpu().numpy()
    dist2 = np.maximum(knn, 1e-7)
    log_scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    f_dc = rgb_to_sh(torch.from_numpy(colors)).numpy()[:, None, :]
    opa = np.full((P, 1), np.log(np.float32(0.1) / (np.float32(1.0) - np.float32(0.1))),
                  dtype=np.float32)
    rows = dict(
        xyz=points,
        f_dc=f_dc,
        f_rest=np.zeros((P, K - 1, 3), np.float32),
        opacity=opa,
        scaling=log_scales,
        rotation=np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (P, 1)),
    )
    return _from_rows(rows, capacity, max_sh_degree, 0, spatial_lr_scale, device)


def pad_rows(x: torch.Tensor, new_capacity: int, fill: float = 0.0) -> torch.Tensor:
    """`x` with rows of `fill` appended up to `new_capacity` rows."""
    extra = x.new_full((new_capacity - x.shape[0],) + x.shape[1:], fill)
    return torch.cat([x, extra])


def grow_capacity(model: GaussianModel, new_capacity: int) -> GaussianModel:
    """Re-pad every buffer to `new_capacity` rows (active rows unchanged,
    new rows carry the sentinels)."""
    if new_capacity < model.capacity:
        raise ValueError(f"capacity {model.capacity} cannot shrink to {new_capacity}")
    p = model.params
    params = {n: pad_rows(getattr(p, n), new_capacity, _FILL.get(n, 0.0)) for n in PARAM_NAMES}
    params["rotation"][model.capacity:, 0] = 1.0
    return dataclasses.replace(
        model, params=GaussianParams(**params), active=pad_rows(model.active, new_capacity)
    )


def save_ply(model: GaussianModel, path: str) -> None:
    """Snapshot active gaussians in the 3DGS PLY layout."""
    active = model.active.cpu().numpy()
    save_gaussian_ply(
        path, *(getattr(model.params, n).detach().cpu().numpy()[active] for n in PARAM_NAMES)
    )


def load_ply(
    path: str,
    max_sh_degree: int = 1,
    capacity: int | None = None,
    capacity_margin: float = 2.0,
    spatial_lr_scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> GaussianModel:
    """Load a snapshot into `capacity` rows (default next_pow2(margin * P));
    active_sh_degree = max (reference `gaussian_model.py:256`)."""
    raw = load_gaussian_ply(path, max_sh_degree)
    if capacity is None:
        capacity = next_pow2(int(raw["xyz"].shape[0] * capacity_margin))

    return _from_rows(raw, capacity, max_sh_degree, max_sh_degree, spatial_lr_scale, device)
