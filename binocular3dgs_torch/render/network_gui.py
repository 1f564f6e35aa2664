"""SIBR live-viewer network protocol (reference gaussian_renderer/network_gui.py).

Counterpart of `binocular3dgs_tpu/render/network_gui.py`, the same wire
format and server; `viewer_camera` turns a request into the port's Camera,
and a render_fn may return a tensor on any device.

Wire format (little-endian):
  client -> server: 4-byte length + UTF-8 JSON with keys resolution_x/y,
      train, fov_y, fov_x, z_near, z_far, shs_python, rot_scale_python,
      keep_alive, scaling_modifier, view_matrix (16 floats),
      view_projection_matrix (16 floats)
  server -> client: raw RGB bytes (H*W*3, uint8) followed by a 4-byte length
      + ASCII verification string (the model path)

The reference flips the Y/Z columns of the received matrices
(network_gui.py:73-76) because SIBR uses an OpenGL-style camera; we reproduce
that; the transposed torch-convention matrices are the port's row-convention
`Camera.world_view` and `Camera.full_proj` as they stand.

The training-loop hook is opt-in (the reference ships it commented out,
train.py:66-79); `serve_step` is non-blocking and safe to call every
iteration.
"""

from __future__ import annotations

import json
import math
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from ..core.camera import Camera


@dataclass
class ViewerRequest:
    width: int
    height: int
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray  # (4, 4), torch convention (transposed)
    full_proj_transform: np.ndarray


def viewer_camera(req: ViewerRequest, device: str | torch.device = "cuda") -> Camera:
    """The port's Camera of a viewer request (reference MiniCam,
    `scene/cameras.py:61-72`: the centre from the inverse world-view)."""

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    wv = req.world_view_transform.astype(np.float64)
    return Camera(
        world_view=tensor(req.world_view_transform),
        proj=tensor(np.linalg.inv(wv) @ req.full_proj_transform),
        full_proj=tensor(req.full_proj_transform),
        cam_center=tensor(np.linalg.inv(wv)[3, :3]),
        tanfovx=tensor(math.tan(req.fovx / 2.0)),
        tanfovy=tensor(math.tan(req.fovy / 2.0)),
        width=req.width, height=req.height, znear=req.znear, zfar=req.zfar,
    )


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None
        self.port = self.listener.getsockname()[1]

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self) -> ViewerRequest | None:
        """Parse one request (reference network_gui.py:56-86). Returns None
        for a 0-resolution keep-alive ping."""
        length = int.from_bytes(self._read_exact(4), "little")
        message = json.loads(self._read_exact(length).decode("utf-8"))
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None
        wvt = np.array(message["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        fpt = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
        fpt[:, 1] = -fpt[:, 1]
        fpt[:, 2] = -fpt[:, 2]
        return ViewerRequest(
            width=width, height=height,
            do_training=bool(message["train"]),
            keep_alive=bool(message["keep_alive"]),
            scaling_modifier=float(message["scaling_modifier"]),
            fovx=float(message["fov_x"]), fovy=float(message["fov_y"]),
            znear=float(message["z_near"]), zfar=float(message["z_far"]),
            world_view_transform=wvt, full_proj_transform=fpt,
        )

    def send(self, image, verify: str) -> None:
        """image: (H, W, 3) float [0,1] or uint8 array or tensor, or None
        (ping reply)."""
        if image is not None:
            if isinstance(image, torch.Tensor):
                image = image.detach().cpu().numpy()
            image = np.asarray(image)
            if image.dtype != np.uint8:
                image = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
            self.conn.sendall(np.ascontiguousarray(image).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()

    def serve_step(self, render_fn, verify: str, training_done: bool) -> None:
        """One non-blocking poll (reference train.py:66-79 pattern):
        render_fn(ViewerRequest) -> (H, W, 3) image array or tensor."""
        if not self.try_connect():
            return
        try:
            while True:
                req = self.receive()
                image = render_fn(req) if req is not None else None
                self.send(image, verify)
                if req is not None and req.do_training and (not req.keep_alive or training_done):
                    break
        except Exception:
            traceback.print_exc()
            self.disconnect()
