"""Scene assembly: camera loading, image arrays, extent, JSON export.

Behavioral parity target: reference `scene/__init__.py:26-115` +
`utils/camera_utils.py:21-124`; counterpart of
`binocular3dgs_tpu/data/dataset.py`. Images are decoded once into host numpy
(H, W, 3) float32 arrays; each view's camera lives on the device the scene
was loaded for.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import Config
from ..core.camera import Camera, make_camera
from ..core.transforms import fov2focal
from .readers import (
    CameraInfo,
    SceneInfo,
    compute_resolution,
    detect_scene_type,
    read_blender_scene,
    read_colmap_scene,
)


@dataclass
class View:
    """One camera + its ground-truth image."""

    camera: Camera
    image: np.ndarray | None  # (H, W, 3) float32 in [0, 1]
    alpha_mask: np.ndarray | None  # (H, W, 1) float32 or None
    image_name: str | None
    colmap_id: int
    uid: int


def load_image(path: str, resolution: tuple[int, int]):
    """Decode + resize; returns (rgb (H,W,3), alpha (H,W,1)|None).

    Matches reference PILtoTorch semantics (`utils/general_utils.py:21-27`):
    PIL bilinear-ish default resize, /255 normalization.
    """
    from PIL import Image

    with Image.open(path) as im:
        resized = im.resize(resolution)
        arr = np.array(resized, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    alpha = None
    if arr.shape[-1] == 4:
        alpha = arr[..., 3:4]
        arr = arr[..., :3]
    return arr, alpha


def load_view(
    cfg: Config,
    uid: int,
    info: CameraInfo,
    resolution_scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> View:
    """reference `loadCam` (`utils/camera_utils.py:21-57`)."""
    if info.image_path is not None:
        from PIL import Image

        with Image.open(info.image_path) as im:
            orig_w, orig_h = im.size
        resolution = compute_resolution(orig_w, orig_h, cfg.model.resolution, resolution_scale)
        rgb, alpha = load_image(info.image_path, resolution)
        if cfg.model.white_background and alpha is not None:
            rgb = rgb * alpha + (1.0 - alpha)
        elif alpha is not None:
            # reference Camera multiplies image by the alpha mask (`scene/cameras.py:45`)
            rgb = rgb * alpha
        rgb = np.clip(rgb, 0.0, 1.0)
        height, width = rgb.shape[:2]
    else:
        resolution = compute_resolution(info.width, info.height, cfg.model.resolution, resolution_scale)
        width, height = resolution
        rgb, alpha = None, None
    cam = make_camera(info.R, info.T, info.fovx, info.fovy, width, height, device=device)
    return View(
        camera=cam, image=rgb, alpha_mask=alpha,
        image_name=info.image_name, colmap_id=info.uid, uid=uid,
    )


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """reference `camera_to_JSON` (`utils/camera_utils.py:107-124`)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.transpose()
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }


@dataclass
class Scene:
    """reference `Scene` (`scene/__init__.py:22-115`), sans the Gaussian model
    (which lives in models/gaussians.py — functional separation)."""

    train_views: list[View] = field(default_factory=list)
    test_views: list[View] = field(default_factory=list)
    cameras_extent: float = 1.0
    scene_info: SceneInfo | None = None

    @classmethod
    def load(
        cls,
        cfg: Config,
        shuffle: bool = True,
        seed: int | None = None,
        device: str | torch.device = "cuda",
    ) -> "Scene":
        source = cfg.model.source_path
        kind = detect_scene_type(source)
        if kind == "Colmap":
            info = read_colmap_scene(
                source,
                images=cfg.model.images,
                eval=cfg.model.eval,
                n_views=cfg.train.n_views,
                dataset_name=cfg.train.dataset_name,
                suffix=cfg.train.suffix,
            )
        else:
            info = read_blender_scene(
                source,
                white_background=cfg.model.white_background,
                eval=cfg.model.eval,
                n_views=cfg.train.n_views,
                dataset_name=cfg.train.dataset_name,
            )

        if cfg.model.model_path:
            os.makedirs(cfg.model.model_path, exist_ok=True)
            if info.ply_path and os.path.exists(info.ply_path):
                with open(info.ply_path, "rb") as src, open(
                    os.path.join(cfg.model.model_path, "input.ply"), "wb"
                ) as dst:
                    dst.write(src.read())
            cams_json = [
                camera_to_json(i, c)
                for i, c in enumerate(list(info.test_cameras) + list(info.train_cameras))
            ]
            with open(os.path.join(cfg.model.model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            rng = random.Random(seed if seed is not None else cfg.train.seed)
            rng.shuffle(train_infos)
            rng.shuffle(test_infos)

        scene = cls(
            train_views=[load_view(cfg, i, c, device=device) for i, c in enumerate(train_infos)],
            test_views=[load_view(cfg, i, c, device=device) for i, c in enumerate(test_infos)],
            cameras_extent=float(info.nerf_normalization["radius"]),
            scene_info=info,
        )
        return scene
