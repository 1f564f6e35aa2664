"""Self-contained PLY I/O (no plyfile dependency).

The port's own copy of `binocular3dgs_tpu/data/ply.py` (numpy only): files
written by either package are byte-identical.

Two layouts are supported, byte-compatible with the reference so trained
models interoperate with 3DGS viewers:

  * point clouds: x,y,z,nx,ny,nz float32 + red,green,blue uchar
    (reference `scene/dataset_readers.py:120-135`)
  * gaussian models: x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*
    all float32 (reference `scene/gaussian_model.py:177-208`)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}
_INV_PLY_DTYPES = {"<f4": "float", "<f8": "double", "u1": "uchar", "<i4": "int", "<u4": "uint"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY file; returns {element_name: structured array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"comment" or key == b"obj_info":
                continue
            elif key == b"element":
                elements.append((tokens[1].decode(), int(tokens[2]), []))
            elif key == b"property":
                if tokens[1] == b"list":
                    raise ValueError("list properties not supported")
                elements[-1][2].append((tokens[2].decode(), tokens[1].decode()))
            elif key == b"end_header":
                break
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                dtype = np.dtype([(p, _PLY_DTYPES[t].lstrip("<")) for p, t in props])
                rows = [tuple(f.readline().split()) for _ in range(count)]
                arr = np.array(rows, dtype=None)
                rec = np.empty(count, dtype=dtype)
                for i, (p, t) in enumerate(props):
                    rec[p] = arr[:, i].astype(dtype[p])
                out[name] = rec
            else:
                byte_order = "<" if "little" in fmt else ">"
                dtype = np.dtype(
                    [
                        (p, _PLY_DTYPES[t].replace("<", byte_order) if "<" in _PLY_DTYPES[t] else _PLY_DTYPES[t])
                        for p, t in props
                    ]
                )
                out[name] = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count).copy()
        return out


def write_ply(path: str, elements: dict[str, np.ndarray]) -> None:
    """Write structured arrays as binary-little-endian PLY."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0"]
    for name, rec in elements.items():
        header.append(f"element {name} {len(rec)}")
        for field in rec.dtype.names:
            dt = rec.dtype[field]
            key = dt.str.lstrip("=|>")
            key = "<" + key if key[0] not in "<u i" and key not in ("u1", "i1") else key
            ply_t = _INV_PLY_DTYPES.get(dt.str.replace(">", "<").replace("=", "<").replace("|", ""), None)
            if ply_t is None:
                ply_t = _INV_PLY_DTYPES[np.dtype(dt).newbyteorder("<").str]
            header.append(f"property {ply_t} {field}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        for _, rec in elements.items():
            f.write(rec.astype(rec.dtype.newbyteorder("<"), copy=False).tobytes())


# ---------------------------------------------------------------------------
# Point clouds (init PLYs)
# ---------------------------------------------------------------------------


@dataclass
class PointCloud:
    points: np.ndarray  # (P, 3) float
    colors: np.ndarray  # (P, 3) float in [0, 1]
    normals: np.ndarray | None = None


def fetch_point_cloud(path: str) -> PointCloud:
    """Read a colored point cloud (reference `scene/dataset_readers.py:109`)."""
    v = read_ply(path)["vertex"]
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    normals = None
    if "nx" in (v.dtype.names or ()):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    return PointCloud(points=points, colors=colors, normals=normals)


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a colored point cloud; rgb in [0, 255] (reference `:120-135`)."""
    rec = np.empty(
        len(xyz),
        dtype=[
            ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
            ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
            ("red", "u1"), ("green", "u1"), ("blue", "u1"),
        ],
    )
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["nx"] = rec["ny"] = rec["nz"] = 0.0
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    write_ply(path, {"vertex": rec})


# ---------------------------------------------------------------------------
# Gaussian model snapshots
# ---------------------------------------------------------------------------


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,  # (P, 3)
    f_dc: np.ndarray,  # (P, 1, 3)  [coeff, channel] layout
    f_rest: np.ndarray,  # (P, K-1, 3)
    opacity: np.ndarray,  # (P, 1) raw (pre-sigmoid)
    scaling: np.ndarray,  # (P, 3) raw (log)
    rotation: np.ndarray,  # (P, 4) raw quaternion
) -> None:
    """Write the 3DGS attribute layout (reference `scene/gaussian_model.py:191-208`).

    f_dc/f_rest are flattened channel-major (transpose(1,2).flatten in the
    reference), i.e. f_rest column order is ch0k1..ch0kN, ch1k1.., ch2k1..
    """
    P = len(xyz)
    f_dc_flat = np.ascontiguousarray(np.transpose(f_dc, (0, 2, 1))).reshape(P, -1)
    f_rest_flat = np.ascontiguousarray(np.transpose(f_rest, (0, 2, 1))).reshape(P, -1)
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc_flat.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest_flat.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scaling.shape[1])]
    names += [f"rot_{i}" for i in range(rotation.shape[1])]
    rec = np.empty(P, dtype=[(n, "<f4") for n in names])
    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc_flat, f_rest_flat, opacity, scaling, rotation], axis=1
    ).astype(np.float32)
    for i, n in enumerate(names):
        rec[n] = cols[:, i]
    write_ply(path, {"vertex": rec})


def load_gaussian_ply(path: str, max_sh_degree: int):
    """Read a 3DGS snapshot (reference `scene/gaussian_model.py:215-256`).

    Returns dict of raw (pre-activation) arrays with [coeff, channel] feature
    layout: xyz (P,3), f_dc (P,1,3), f_rest (P,K-1,3), opacity (P,1),
    scaling (P,3), rotation (P,4).
    """
    v = read_ply(path)["vertex"]
    names = v.dtype.names or ()
    P = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(v["opacity"], dtype=np.float32)[:, None]
    f_dc = np.zeros((P, 3, 1), dtype=np.float32)
    for ch in range(3):
        f_dc[:, ch, 0] = v[f"f_dc_{ch}"]
    extra = sorted(
        (n for n in names if n.startswith("f_rest_")), key=lambda n: int(n.split("_")[-1])
    )
    expected = 3 * ((max_sh_degree + 1) ** 2 - 1)
    assert len(extra) == expected, f"expected {expected} f_rest fields, got {len(extra)}"
    f_rest = np.zeros((P, len(extra)), dtype=np.float32)
    for i, n in enumerate(extra):
        f_rest[:, i] = v[n]
    f_rest = f_rest.reshape(P, 3, (max_sh_degree + 1) ** 2 - 1)
    scale_names = sorted(
        (n for n in names if n.startswith("scale_")), key=lambda n: int(n.split("_")[-1])
    )
    scaling = np.stack([v[n] for n in scale_names], axis=1).astype(np.float32)
    rot_names = sorted((n for n in names if n.startswith("rot_")), key=lambda n: int(n.split("_")[-1]))
    rotation = np.stack([v[n] for n in rot_names], axis=1).astype(np.float32)
    return {
        "xyz": xyz,
        "f_dc": np.transpose(f_dc, (0, 2, 1)),  # (P, 1, 3)
        "f_rest": np.transpose(f_rest, (0, 2, 1)),  # (P, K-1, 3)
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }
