"""COLMAP sparse reconstruction parsers (binary + text).

Behavioral parity target: reference `scene/colmap_loader.py` (PINHOLE and
SIMPLE_PINHOLE models; points3D returned as (xyz, rgb, error) arrays).
Written from the public COLMAP file-format spec. The port's own copy of
`binocular3dgs_tpu/data/colmap.py` (numpy only).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params); COLMAP camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,)


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """w,x,y,z quaternion to rotation matrix (reference `scene/colmap_loader.py:43`)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix to w,x,y,z quaternion (symmetric eigen method)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]), np.array(parts[4:], dtype=np.float64)
            )
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * num_pts), dtype=np.float64).reshape(num_pts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64).copy()
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name_bytes.decode("utf-8"), xys, ids
            )
    return images


def read_images_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array(parts[1:5], dtype=np.float64)
        tvec = np.array(parts[5:8], dtype=np.float64)
        camera_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(elems, dtype=np.float64).reshape(-1, 3)[:, :2] if elems else np.zeros((0, 2))
        ids = (
            np.array(elems, dtype=np.float64).reshape(-1, 3)[:, 2].astype(np.int64)
            if elems
            else np.zeros(0, dtype=np.int64)
        )
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3d_binary(path: str):
    """Returns (xyz (P,3), rgb (P,3) uint8-valued, error (P,1)) like the reference."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty((n, 1))
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz_l.append([float(p) for p in parts[1:4]])
            rgb_l.append([float(p) for p in parts[4:7]])
            err_l.append([float(parts[7])])
    return np.array(xyz_l), np.array(rgb_l), np.array(err_l)


# -- writers (used by tests and the dense-init pipeline fixtures) -----------


def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path: str, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(
                struct.pack(
                    "<QdddBBBd",
                    i,
                    *xyz[i],
                    int(rgb[i][0]),
                    int(rgb[i][1]),
                    int(rgb[i][2]),
                    float(np.asarray(err[i]).reshape(-1)[0]),
                )
            )
            f.write(struct.pack("<Q", 0))
