"""Scene/dataset readers: COLMAP + Blender, few-view selection, nerf++ norm.

Behavioral parity target: reference `scene/dataset_readers.py:28-288` —
including the LLFF hold-out rule, DTU/Blender fixed train indices, the
dense-init PLY override path, and the Blender random 100k-point init.
The port's own copy of `binocular3dgs_tpu/data/readers.py` (numpy only).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.transforms import focal2fov, fov2focal, world_to_view
from . import colmap
from .ply import PointCloud, fetch_point_cloud, store_point_cloud

DTU_TRAIN_INDICES = [25, 22, 28, 40, 44, 48, 0, 8, 13]
DTU_TEST_INDICES = [
    1, 2, 9, 10, 11, 12, 14, 15, 23, 24, 26, 27, 29, 30, 31, 32, 33, 34, 35,
    41, 42, 43, 45, 46, 47,
]
BLENDER_TRAIN_INDICES = [2, 16, 26, 55, 73, 76, 86, 93]


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # camera-to-world rotation (COLMAP R transposed)
    T: np.ndarray  # world-to-camera translation
    fovy: float
    fovx: float
    image_path: str | None
    image_name: str | None
    width: int
    height: int
    # Loaded lazily by the dataset layer:
    image: np.ndarray | None = None  # (H, W, 3) float32 in [0,1]
    alpha_mask: np.ndarray | None = None  # (H, W, 1) float32


@dataclass
class SceneInfo:
    point_cloud: PointCloud | None
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    ply_path: str | None


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene radius/translate from camera centers (reference `:47-68`)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = float(np.max(np.linalg.norm(centers - avg, axis=0)))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_colmap_cameras(
    cam_extrinsics: dict, cam_intrinsics: dict, images_folder: str
) -> list[CameraInfo]:
    """COLMAP extr/intr -> CameraInfo list (reference `:70-107`)."""
    infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = colmap.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fx = intr.params[0]
            fovy = focal2fov(fx, height)
            fovx = focal2fov(fx, width)
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
            fovy = focal2fov(fy, height)
            fovx = focal2fov(fx, width)
        else:
            raise ValueError(
                f"Colmap camera model not handled: {intr.model} (only PINHOLE/SIMPLE_PINHOLE)"
            )
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        infos.append(
            CameraInfo(
                uid=intr.id, R=R, T=T, fovy=fovy, fovx=fovx,
                image_path=image_path, image_name=image_name, width=width, height=height,
            )
        )
    return infos


def select_few_views(
    cam_infos: list[CameraInfo], dataset_name: str, n_views: int, llffhold: int = 8
) -> tuple[list[CameraInfo], list[CameraInfo]]:
    """Few-shot train/test split (reference `:157-177`)."""
    if dataset_name == "DTU":
        train = [cam_infos[i] for i in DTU_TRAIN_INDICES][:n_views]
        test = [cam_infos[i] for i in DTU_TEST_INDICES]
    elif dataset_name == "LLFF":
        train_all = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
        idx_sub = {round(i) for i in np.linspace(0, len(train_all) - 1, n_views)}
        train = [c for i, c in enumerate(train_all) if i in idx_sub]
    else:
        raise NotImplementedError(dataset_name)
    return train, test


def read_colmap_scene(
    path: str,
    images: str = "images",
    eval: bool = False,
    n_views: int = 3,
    dataset_name: str = "LLFF",
    suffix: str | None = None,
    llffhold: int = 8,
    keypoints_root: str = "keypoints_to_3d",
) -> SceneInfo:
    """reference `readColmapSceneInfo` (`scene/dataset_readers.py:137-199`)."""
    sparse = os.path.join(path, "sparse/0")
    try:
        cam_extrinsics = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        cam_intrinsics = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        cam_extrinsics = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        cam_intrinsics = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cam_infos = read_colmap_cameras(cam_extrinsics, cam_intrinsics, os.path.join(path, images))
    cam_infos = sorted(cam_infos, key=lambda x: x.image_name)

    ply_path = os.path.join(sparse, "points3D.ply")
    if eval and n_views > 0:
        scene_name = os.path.basename(os.path.normpath(path))
        tag = f"{dataset_name}_{suffix}" if suffix is not None else dataset_name
        dense_ply = os.path.join(keypoints_root, tag, f"{scene_name}_keypoints_to_3d.ply")
        if os.path.exists(dense_ply):
            ply_path = dense_ply
        train_cams, test_cams = select_few_views(cam_infos, dataset_name, n_views, llffhold)
    else:
        train_cams, test_cams = cam_infos, []

    nerf_normalization = get_nerfpp_norm(train_cams)

    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)

    pcd = fetch_point_cloud(ply_path)
    return SceneInfo(pcd, train_cams, test_cams, nerf_normalization, ply_path)


def read_blender_transforms(path: str, transformsfile: str, extension: str = ".png"):
    """NeRF-synthetic transforms.json -> CameraInfo list (reference `:201-241`)."""
    from PIL import Image

    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        with Image.open(cam_name) as im:
            width, height = im.size
        fovy = focal2fov(fov2focal(fovx, width), height)
        infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovy=fovy, fovx=fovx,
                image_path=cam_name, image_name=Path(cam_name).stem, width=width, height=height,
            )
        )
    return infos


def read_blender_scene(
    path: str,
    white_background: bool = False,
    eval: bool = False,
    n_views: int = 8,
    dataset_name: str = "Blender",
    extension: str = ".png",
    rng: np.random.Generator | None = None,
) -> SceneInfo:
    """reference `readNerfSyntheticInfo` (`scene/dataset_readers.py:243-288`)."""
    from ..core.sh import sh_to_rgb

    train_cams = read_blender_transforms(path, "transforms_train.json", extension)
    test_cams = read_blender_transforms(path, "transforms_test.json", extension)

    if eval and n_views > 0:
        if dataset_name != "Blender":
            raise NotImplementedError(dataset_name)
        train_cams = [train_cams[i] for i in BLENDER_TRAIN_INDICES]
        test_cams = [c for i, c in enumerate(test_cams) if i % 8 == 0]
    if not eval:
        train_cams = train_cams + test_cams
        test_cams = []

    nerf_normalization = get_nerfpp_norm(train_cams)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = rng or np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    try:
        pcd = fetch_point_cloud(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train_cams, test_cams, nerf_normalization, ply_path)


def detect_scene_type(source_path: str) -> str:
    """reference `scene/__init__.py:44-50`."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"Could not recognize scene type at {source_path}")


def compute_resolution(
    orig_w: int, orig_h: int, resolution: int, resolution_scale: float = 1.0
) -> tuple[int, int]:
    """Reference resolution policy (`utils/camera_utils.py:21-45`): -1 caps
    width at 1600px; 1/2/4/8 divide; other values set target width."""
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)
