"""Camera model.

Counterpart of `binocular3dgs_tpu/core/camera.py`: the matrices are built
on the host in float64 numpy and stored as float32 tensors on a device,
with the row-vector convention (``p_view = [p, 1] @ world_view``). Image
width/height and the clip planes are plain Python numbers. `shift_camera`
works on the stored float32 tensors, as the JAX version does under jit,
with the shift a number or a tensor on the device.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .transforms import projection_matrix, world_to_view

DEFAULT_ZNEAR = 0.01
DEFAULT_ZFAR = 100.0


@dataclass
class Camera:
    world_view: torch.Tensor  # (4, 4) row convention
    proj: torch.Tensor  # (4, 4) row-convention perspective projection
    full_proj: torch.Tensor  # (4, 4) = world_view @ proj
    cam_center: torch.Tensor  # (3,) camera center in world space
    tanfovx: torch.Tensor  # scalar
    tanfovy: torch.Tensor  # scalar
    width: int = 0
    height: int = 0
    znear: float = DEFAULT_ZNEAR
    zfar: float = DEFAULT_ZFAR

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tanfovy)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    trans: np.ndarray | None = None,
    scale: float = 1.0,
    znear: float = DEFAULT_ZNEAR,
    zfar: float = DEFAULT_ZFAR,
    device: str | torch.device = "cuda",
) -> Camera:
    """Camera from COLMAP-style (R, T): `R` camera-to-world rotation
    (transposed COLMAP rotation), `T` world-to-camera translation."""
    w2v = world_to_view(R, T, translate=trans, scale=scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    world_view = w2v.T
    proj_row = proj.T
    full_proj = world_view @ proj_row
    cam_center = np.linalg.inv(world_view)[3, :3]

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return Camera(
        world_view=tensor(world_view),
        proj=tensor(proj_row),
        full_proj=tensor(full_proj),
        cam_center=tensor(cam_center),
        tanfovx=tensor(math.tan(fovx / 2.0)),
        tanfovy=tensor(math.tan(fovy / 2.0)),
        width=int(width),
        height=int(height),
        znear=float(znear),
        zfar=float(zfar),
    )


def shift_camera(camera: Camera, trans_dist) -> Camera:
    """Camera translated by `trans_dist` along its own x axis (reference
    `scene/__init__.py:96-115` + `getWorld2View2`): the centre moves by
    R_c2w @ [d, 0, 0] in world space, the orientation is unchanged, and
    `world_view`, `full_proj` and `cam_center` are rebuilt in float32 on the
    camera's device, in the order of `binocular3dgs_tpu/core/camera.py`.
    `trans_dist` is a number or a 0-d float32 tensor on the camera's device
    (a CUDA graph's input); either way the shift enters as a float32 factor
    and nothing is copied from the host."""
    M = camera.world_view.T  # column-convention W2C
    Rw2c = M[:3, :3]
    x_axis_world = Rw2c[0]  # R_c2w @ [1, 0, 0]: the first row of R_w2c
    new_center = camera.cam_center + trans_dist * x_axis_world
    new_M = M.clone()
    new_M[:3, 3] = -Rw2c @ new_center
    world_view = new_M.T.contiguous()
    return dataclasses.replace(
        camera,
        world_view=world_view,
        full_proj=world_view @ camera.proj,
        cam_center=new_center,
    )
