"""NeRF-style pose math for spiral render paths.

The port's own copy of `binocular3dgs_tpu/render/pose_utils.py`.
Behavioral parity target: reference `utils/pose_utils.py:430-537` (mip-NeRF
style recenter/backcenter, average pose, LLFF forward-facing spiral and DTU
focus-point spiral) and `:356-367` (`convert_poses` back to COLMAP R/t).
Host-side numpy — this runs once per render job.
"""

from __future__ import annotations

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def viewmatrix(lookdir, up, position, subtract_position=False):
    """Lookat view matrix (camera-to-world, columns = x, y, z, pos)."""
    vec2 = normalize((position - lookdir) if subtract_position else lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses):
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def recenter_poses(poses):
    cam2world = poses_avg(poses)
    return unpad_poses(np.linalg.inv(pad_poses(cam2world)) @ pad_poses(poses))


def backcenter_poses(poses, pose_ref):
    cam2world = poses_avg(pose_ref)
    return unpad_poses(pad_poses(cam2world) @ pad_poses(poses))


def focus_pt_fn(poses):
    """Nearest point to all focal axes."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_spiral_path(poses, bounds, n_frames=120, n_rots=2, zrate=0.5):
    """Forward-facing spiral (reference `utils/pose_utils.py:483-507`)."""
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    render_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        render_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(render_poses, axis=0)


def generate_spiral_path_dtu(poses, n_frames=120, n_rots=2, zrate=0.5, perc=60):
    """DTU spiral with a focus-point lookat (reference `:519-537`)."""
    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), perc, 0)
    radii = np.concatenate([radii, [1.0]])

    render_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    z_axis = focus_pt_fn(poses)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        render_poses.append(viewmatrix(z_axis, up, position, True))
    return np.stack(render_poses, axis=0)


def convert_poses(poses):
    """(3, 5, N) LLFF-layout poses -> (Rs, tvecs, H, W, focal) in the
    data-layer convention (reference `utils/pose_utils.py:356-367`)."""
    poses = np.concatenate(
        [poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4], poses[:, 4:5]], 1
    ).transpose(2, 0, 1)
    bottom = np.tile(np.array([0, 0, 0, 1.0]).reshape([1, 1, 4]), (poses.shape[0], 1, 1))
    H, W, fl = poses[0, :, -1]
    mats = np.concatenate([poses[..., :4], bottom], 1)
    mats = np.linalg.inv(mats)
    Rs = mats[:, :3, :3]
    tvecs = mats[:, :3, -1]
    return Rs, tvecs, H, W, fl
