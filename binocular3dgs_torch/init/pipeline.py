"""Dense initialization pipeline: matching -> triangulation -> filtered,
colored point cloud (+ DTU background shell / LLFF SSIM-guided growth).

Counterpart of `binocular3dgs_tpu/init/pipeline.py` (reference
`submodules/dense_matcher/triangulate.py` end to end), with the same
functions and contracts:
  * COLMAP cameras at a downscale factor, few-view selection (`:61-118`);
    images read with PIL and resized on the device with OpenCV's INTER_LINEAR
    semantics (`init/image_io.py`), returned as host uint8 arrays
  * all ordered train-view pairs matched, DLT-triangulated (`:138-172`),
    reprojection filter < 2 px in both views, in-bounds filter
    (`:185-209`), colors grid-sampled at the ref keypoints (`:214-219`):
    float64 numpy on the host, as the JAX package computes them
  * DTU: white background shell at depth 10 from near-white pixels (`:221-238`)
  * LLFF: 1000 iterations of random point growth around existing points with
    patch-SSIM >= 0.95 acceptance and <= 2-per-rounded-pixel dedup in both
    views (`:247-379`): the host draws from `np.random.default_rng(seed)` in
    the JAX loop's order; the points, the candidate scorer (float32, as the
    jitted JAX scorer) and the dedup live on the device
  * PLY export to keypoints_to_3d/<dataset>/<scene>_keypoints_to_3d.ply
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..data import colmap
from ..data.ply import store_point_cloud
from . import geometry
from .image_io import imread_rgb, resize_linear_u8


@dataclass
class TriangulateConfig:
    dataset_name: str = "LLFF"
    n_views: int = 3
    resolution: int = 8  # downscale factor for matching (reference default 8)
    llffhold: int = 8
    reproj_thresh: float = 2.0
    # LLFF growth (reference `triangulate.py:247-252`)
    growth_iterations: int = 1000
    ssim_threshold: float = 0.95
    h_patch_size: int = 5
    growth_alpha: float = 10.0
    sample_points_num: int = 100
    sample_num: int = 200
    # DTU background shell (reference `:221-238`)
    dtu_bg_depth: float = 10.0
    seed: int = 0


def load_scene_for_init(scene_path: str, images_dir: str, resolution: int,
                        device: str | torch.device = "cuda"):
    """COLMAP cameras + images at 1/resolution scale (reference `:61-101`),
    the resize on `device`.

    Returns (images (V, H, W, 3) uint8 list, K (3,3), c2ws list, names)."""
    device = resolve_device(device)
    sparse = os.path.join(scene_path, "sparse/0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
    items = sorted(extr.values(), key=lambda im: im.name)

    cam = intr[items[0].camera_id]
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    elif cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported camera model {cam.model}")
    K = np.array(
        [[fx / resolution, 0, cx / resolution], [0, fy / resolution, cy / resolution], [0, 0, 1.0]]
    )

    images, c2ws, names = [], [], []
    for im in items:
        R = colmap.qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2ws.append(np.linalg.inv(w2c))
        img = torch.from_numpy(imread_rgb(os.path.join(scene_path, images_dir,
                                                       os.path.basename(im.name))))
        h, w = img.shape[:2]
        img = resize_linear_u8(img.to(device), (w // resolution, h // resolution))
        images.append(img.cpu().numpy())
        names.append(im.name)
    return images, K, c2ws, names


def select_train_indices(n_images: int, dataset_name: str, n_views: int, llffhold: int = 8):
    """reference `triangulate.py:105-110` (same rule as the dataset reader)."""
    if dataset_name == "DTU":
        return [25, 22, 28, 40, 44, 48, 0, 8, 13][:n_views]
    train = [i for i in range(n_images) if i % llffhold != 0]
    idx_sub = {round(i) for i in np.linspace(0, len(train) - 1, n_views)}
    return [t for i, t in enumerate(train) if i in idx_sub]


def triangulate_pairs(images, K, c2ws, train_indices, matcher, cfg: TriangulateConfig):
    """Pairwise matching + DLT + filters + colors (reference `:138-238`)."""
    H, W = images[train_indices[0]].shape[:2]
    K34 = np.concatenate([K, np.zeros((3, 1))], axis=1)
    points_all, colors_all = [], []
    for ref_i in train_indices:
        for src_i in train_indices:
            if src_i == ref_i:
                continue
            pred = matcher.get_matches_and_confidence(images[ref_i], images[src_i])
            kp0, kp1 = pred["kp_source"], pred["kp_target"]
            if len(kp0) == 0:
                continue
            P0 = K34 @ np.linalg.inv(c2ws[ref_i])
            P1 = K34 @ np.linalg.inv(c2ws[src_i])
            pts = geometry.triangulate_points_dlt(P0, P1, kp0, kp1)

            ref_uv, _ = geometry.project_points(pts, K, np.linalg.inv(c2ws[ref_i]))
            src_uv, _ = geometry.project_points(pts, K, np.linalg.inv(c2ws[src_i]))
            mask = (np.linalg.norm(ref_uv - kp0, axis=-1) < cfg.reproj_thresh) & (
                np.linalg.norm(src_uv - kp1, axis=-1) < cfg.reproj_thresh
            )
            mask &= (
                (ref_uv[:, 0] >= 0) & (ref_uv[:, 0] <= W - 1)
                & (ref_uv[:, 1] >= 0) & (ref_uv[:, 1] <= H - 1)
                & (src_uv[:, 0] >= 0) & (src_uv[:, 0] <= W - 1)
                & (src_uv[:, 1] >= 0) & (src_uv[:, 1] <= H - 1)
            )
            pts, ref_uv = pts[mask], ref_uv[mask]
            if len(pts) == 0:
                continue
            colors = geometry.sample_colors_at(images[ref_i].astype(np.float64), ref_uv)
            points_all.append(pts)
            colors_all.append(colors.astype(np.uint8))

        if cfg.dataset_name == "DTU":
            img = images[ref_i]
            depth = np.full(img.shape[:2], cfg.dtu_bg_depth)
            pts_bg = geometry.backproject_depth(depth, K, c2ws[ref_i])
            bg_mask = img.max(axis=-1).reshape(-1) >= 254
            points_all.append(pts_bg[bg_mask])
            colors_all.append(np.full((int(bg_mask.sum()), 3), 255, np.uint8))

    if not points_all:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    return np.concatenate(points_all), np.concatenate(colors_all)


def _make_candidate_scorer(h_patch_size: int):
    """The growth iteration's scorer, float32 on the device of its inputs:
    project candidates into both views, sample 11x11 patches, patch-SSIM,
    mask out-of-bounds (the jitted JAX scorer, `pipeline.py:148-175`)."""

    def score(cand, ref_img, src_img, w2c_ref, w2c_src, focal, center):
        H, W = ref_img.shape[:2]

        def project(pts, w2c):
            x = pts @ w2c[:3, :3].T + w2c[:3, 3]
            return x[:, :2] / x[:, 2:3] * focal + center

        ref_uv = project(cand, w2c_ref)
        src_uv = project(cand, w2c_src)
        in_ref = (ref_uv[:, 0] >= 0) & (ref_uv[:, 0] < W) & (ref_uv[:, 1] >= 0) & (ref_uv[:, 1] < H)
        in_src = (src_uv[:, 0] >= 0) & (src_uv[:, 0] < W) & (src_uv[:, 1] >= 0) & (src_uv[:, 1] < H)
        ref_patch = geometry.sample_patches_torch(ref_img, ref_uv, h_patch_size)
        src_patch = geometry.sample_patches_torch(src_img, src_uv, h_patch_size)
        ssim_vals = geometry.patch_ssim_torch(src_patch, ref_patch, h_patch_size)
        return ssim_vals * (in_ref & in_src)

    return score


def _dedup_mask(uv_all: torch.Tensor, n_new: int) -> torch.Tensor:
    """<=2 points per rounded pixel among ALL points (reference torch.unique
    counts over old+new, `:332-343`): the mask of the last n_new."""
    _, inverse, counts = torch.unique(torch.round(uv_all), dim=0, return_inverse=True,
                                      return_counts=True)
    return counts[inverse][-n_new:] <= 2


def grow_points_llff(points, colors, images, K, c2ws, train_indices, cfg: TriangulateConfig,
                     device: str | torch.device = "cuda"):
    """SSIM-guided random growth (reference `triangulate.py:247-379`).

    The host draws the views, seeds and offsets from the config's seed, in
    the JAX loop's order, so both packages score the same candidates; the
    points, their scoring, projection and dedup live on `device`. Returns
    host arrays, as the JAX version."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    H, W = images[train_indices[0]].shape[:2]

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    points_all = dev(points, torch.float64)
    colors_all = dev(colors, torch.float64)
    scorer = _make_candidate_scorer(cfg.h_patch_size)
    imgs = {t: dev(images[t], torch.float64) / 255.0 for t in train_indices}
    imgs_f32 = {t: dev(images[t], torch.float32) / 255.0 for t in train_indices}
    w2cs = {t: dev(np.linalg.inv(c2ws[t]), torch.float64) for t in train_indices}
    w2cs_f32 = {t: w.float() for t, w in w2cs.items()}
    focal = dev([K[0, 0], K[1, 1]], torch.float64)
    center = dev([K[0, 2], K[1, 2]], torch.float64)
    focal_f32, center_f32 = focal.float(), center.float()

    def project(pts, t):
        w2c = w2cs[t]
        uv = pts @ w2c[:3, :3].T + w2c[:3, 3]
        return uv[:, :2] / uv[:, 2:3] * focal + center

    def inside(uv):
        return (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)

    for _ in range(cfg.growth_iterations):
        ref_i = train_indices[rng.integers(len(train_indices))]
        others = [t for t in train_indices if t != ref_i]
        src_i = others[rng.integers(len(others))]

        pick = rng.permutation(points_all.shape[0])[: cfg.sample_points_num]
        offsets = rng.normal(size=(len(pick), cfg.sample_num, 3)) * cfg.growth_alpha
        seeds = points_all[dev(pick, torch.int64)]
        cand = (seeds[:, None, :] + dev(offsets, torch.float64)).reshape(-1, 3)

        ssim_vals = scorer(cand.float(), imgs_f32[ref_i], imgs_f32[src_i], w2cs_f32[ref_i],
                           w2cs_f32[src_i], focal_f32, center_f32)
        new_points = cand[ssim_vals >= cfg.ssim_threshold]
        n_new = new_points.shape[0]
        if n_new == 0:
            continue

        all_pts = torch.cat([points_all, new_points])
        ref_uv_all = project(all_pts, ref_i)
        src_uv_all = project(all_pts, src_i)
        ref_uv_new = ref_uv_all[-n_new:]
        in_ref_n, in_src_n = inside(ref_uv_new), inside(src_uv_all[-n_new:])
        if not bool(in_ref_n.any()) or not bool(in_src_n.any()):
            continue
        keep = (in_ref_n & in_src_n & _dedup_mask(ref_uv_all, n_new)
                & _dedup_mask(src_uv_all, n_new))
        if not bool(keep.any()):
            continue
        new_colors = geometry.sample_colors_at_torch(imgs[ref_i], ref_uv_new[keep]) * 255.0
        points_all = torch.cat([points_all, new_points[keep]])
        colors_all = torch.cat([colors_all, new_colors])

    return points_all.cpu().numpy(), colors_all.cpu().numpy().astype(np.uint8)


def triangulate_scene(
    scene_path: str,
    output_path: str,
    matcher,
    cfg: TriangulateConfig,
    images_dir: str = "images",
    device: str | torch.device = "cuda",
) -> str:
    """Full dense-init for one scene; returns the written PLY path."""
    images, K, c2ws, _ = load_scene_for_init(scene_path, images_dir, cfg.resolution, device)
    train_idx = select_train_indices(len(images), cfg.dataset_name, cfg.n_views, cfg.llffhold)
    points, colors = triangulate_pairs(images, K, c2ws, train_idx, matcher, cfg)
    if cfg.dataset_name == "LLFF" and len(points) > 0 and cfg.growth_iterations > 0:
        points, colors = grow_points_llff(points, colors, images, K, c2ws, train_idx, cfg, device)
    scene_name = os.path.basename(os.path.normpath(scene_path))
    os.makedirs(output_path, exist_ok=True)
    ply_path = os.path.join(output_path, f"{scene_name}_keypoints_to_3d.ply")
    store_point_cloud(ply_path, points, colors)
    return ply_path
