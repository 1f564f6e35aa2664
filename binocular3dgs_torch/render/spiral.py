"""Spiral render path scene construction + depth visualization.

Counterpart of `binocular3dgs_tpu/render/spiral.py` (reference
`scene/dataset_readers.py:314-406`: CreateLLFFSpiral / CreateDTUSpiral from
poses_bounds.npy, and `spiral.py:41-139`: colormapped inverted-depth video
frames). Host numpy; the colormap is the port's own Turbo table
(`render/turbo.py`) in place of matplotlib's.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.transforms import focal2fov
from ..data.readers import CameraInfo, SceneInfo, get_nerfpp_norm
from . import pose_utils
from .turbo import TURBO, apply_lut

FIX_ROTATION = np.array(
    [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
)


def _cameras_from_llff_poses(render_poses):
    Rs, tvecs, height, width, focal = pose_utils.convert_poses(render_poses)
    infos = []
    for i in range(len(Rs)):
        infos.append(CameraInfo(
            uid=i, R=np.transpose(Rs[i]), T=tvecs[i], fovy=focal2fov(focal, height),
            fovx=focal2fov(focal, width), image_path=None, image_name=f"{i:05d}",
            width=int(width), height=int(height),
        ))
    return infos


def _spiral_scene(poses_o, render_poses) -> SceneInfo:
    """Render poses (N, 3, 4) in the recentred, fix-rotated frame -> the
    spiral's cameras, with the first input pose's H, W, focal column."""
    render_poses = render_poses @ np.linalg.inv(FIX_ROTATION)
    render_poses = np.concatenate(
        [render_poses, np.tile(poses_o[:1, :3, 4:], (render_poses.shape[0], 1, 1))], -1
    )
    cam_infos = _cameras_from_llff_poses(render_poses.transpose([1, 2, 0]))
    return SceneInfo(None, [], cam_infos, get_nerfpp_norm(cam_infos), None)


def create_llff_spiral(basedir: str, n_frames: int = 180) -> SceneInfo:
    """reference `CreateLLFFSpiral` (`scene/dataset_readers.py:314-356`)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses_o = poses_arr[:, :-2].reshape([-1, 3, 5])
    bounds = poses_arr[:, -2:]
    poses = poses_o[:, :3, :4] @ FIX_ROTATION

    render_poses = pose_utils.recenter_poses(poses)
    render_poses = pose_utils.generate_spiral_path(render_poses, bounds, n_frames=n_frames)
    render_poses = pose_utils.backcenter_poses(render_poses, poses)
    return _spiral_scene(poses_o, render_poses)


def create_dtu_spiral(basedir: str, n_frames: int = 180) -> SceneInfo:
    """reference `CreateDTUSpiral` (`scene/dataset_readers.py:359-406`)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses_o = poses_arr[:, :-2].reshape([-1, 3, 5])
    poses = poses_o[:, :3, :4] @ FIX_ROTATION

    render_poses = pose_utils.recenter_poses(poses)
    s = np.max(np.abs(render_poses[:, :3, -1]))
    render_poses[:, :3, -1] /= s
    render_poses = pose_utils.generate_spiral_path_dtu(render_poses, n_frames=n_frames)
    render_poses[:, :3, -1] *= s
    render_poses = pose_utils.backcenter_poses(render_poses, poses)
    return _spiral_scene(poses_o, render_poses)


def depth_curve_fn(x):
    return -np.log(x + 1e-6)


def visualize_cmap(
    value,
    weight,
    lut=TURBO,
    lo=None,
    hi=None,
    percentile=99.0,
    curve_fn=lambda x: x,
    modulus=None,
    matte_background=True,
):
    """Map a depth/feature image to RGB through the colour table `lut`
    (reference `spiral.py:41-98` behavior: percentile bounds, optional curve
    warp, NaN-safe)."""
    if lo is None or hi is None:
        lo_auto, hi_auto = np.nanpercentile(
            np.where(weight > 0, value, np.nan), [50 - percentile / 2, 50 + percentile / 2]
        )
        lo = lo if lo is not None else lo_auto - np.finfo(np.float32).eps
        hi = hi if hi is not None else hi_auto + np.finfo(np.float32).eps
    if curve_fn is not None:
        lo, hi, value = [curve_fn(x) for x in [lo, hi, value]]
    value = np.nan_to_num(value)
    if modulus is not None:
        value = np.mod(value, modulus) / modulus
    else:
        lo, hi = min(lo, hi), max(lo, hi)
        value = np.clip((value - lo) / (hi - lo + np.finfo(np.float32).eps), 0, 1)
    colorized = apply_lut(lut, value)
    if matte_background:
        colorized = colorized * weight[..., None] + (1.0 - weight[..., None])
    return colorized
