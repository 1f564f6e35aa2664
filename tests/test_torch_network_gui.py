"""The port's viewer server: the round trip of
tests/test_gui_orchestrate.py::test_network_gui_round_trip against it, a
keep-alive ping, the camera of a request against make_camera, and a render
served through `render_tiled` against a direct render, byte for byte."""

import json
import socket
import threading
import time

import numpy as np
import torch

from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.render.network_gui import NetworkGUI, viewer_camera

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)
from test_torch_project import sh1_scene, to_port


def message(width, height, view, proj, fovx=1.0, fovy=0.8, train=True, keep_alive=False):
    return {
        "resolution_x": width, "resolution_y": height, "train": train,
        "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": 1.0,
        "view_matrix": np.asarray(view, np.float32).reshape(-1).tolist(),
        "view_projection_matrix": np.asarray(proj, np.float32).reshape(-1).tolist(),
    }


def serve(gui, msgs, render_fn, n_image_bytes):
    """A client thread sends `msgs` and reads one reply to each; the server
    polls until connected, then serves one serve_step."""
    received = []

    def client():
        c = socket.create_connection(("127.0.0.1", gui.port), timeout=30)
        for msg, n in zip(msgs, n_image_bytes):
            payload = json.dumps(msg).encode()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            img = b""
            while len(img) < n:
                img += c.recv(n - len(img))
            vlen = int.from_bytes(c.recv(4), "little")
            received.append((img, c.recv(vlen).decode()))
        c.close()

    t = threading.Thread(target=client)
    t.start()
    for _ in range(500):
        if gui.try_connect():
            break
        time.sleep(0.01)
    gui.serve_step(render_fn, verify="model/path", training_done=False)
    t.join(timeout=30)
    assert not t.is_alive()
    gui.close()
    return received


def test_round_trip():
    """As tests/test_gui_orchestrate.py::test_network_gui_round_trip."""
    gui = NetworkGUI(port=0)
    wvt = np.eye(4, dtype=np.float32)

    def render_fn(req):
        assert req.width == 8 and req.height == 6
        assert req.do_training and not req.keep_alive
        # Y/Z columns must be flipped (reference network_gui.py:73-76)
        assert req.world_view_transform[1, 1] == -1.0
        assert req.world_view_transform[2, 2] == -1.0
        return np.full((req.height, req.width, 3), 0.5, np.float32)

    ((img, verify),) = serve(gui, [message(8, 6, wvt, wvt)], render_fn, [6 * 8 * 3])
    assert verify == "model/path"
    assert (np.frombuffer(img, np.uint8).reshape(6, 8, 3) == 127).all()


def test_keep_alive_ping_then_a_tensor_image():
    """A 0-resolution ping gets the verification string alone and the loop
    goes on; a render_fn may return a (H, W, 3) tensor."""
    gui = NetworkGUI(port=0)
    wvt = np.eye(4, dtype=np.float32)
    calls = []

    def render_fn(req):
        calls.append(req)
        return torch.full((req.height, req.width, 3), 0.25)

    got = serve(gui, [message(0, 0, wvt, wvt), message(4, 3, wvt, wvt)], render_fn,
                [0, 4 * 3 * 3])
    assert [v for _, v in got] == ["model/path"] * 2 and got[0][0] == b""
    assert len(calls) == 1
    assert (np.frombuffer(got[1][0], np.uint8) == 63).all()


def viewer_matrices(cam):
    """What a SIBR client sends for `cam`: its matrices with the Y and Z
    columns negated (the server negates them back)."""
    view, proj = cam.world_view.numpy().copy(), cam.full_proj.numpy().copy()
    for m in (view, proj):
        m[:, 1:3] *= -1
    return view, proj


def test_viewer_camera_matches_make_camera():
    R = np.array([[0.98, 0.0, 0.199], [0.0, 1.0, 0.0], [-0.199, 0.0, 0.98]])
    R, _ = np.linalg.qr(R)
    cam = make_camera(R, np.array([0.3, -0.2, 0.5]), 1.1, 0.85, 40, 30, device="cpu")
    view, proj = viewer_matrices(cam)
    gui = NetworkGUI(port=0)
    seen = []

    def render_fn(req):
        seen.append(viewer_camera(req, device="cpu"))
        return np.zeros((req.height, req.width, 3), np.float32)

    serve(gui, [message(40, 30, view, proj, fovx=1.1, fovy=0.85)], render_fn, [40 * 30 * 3])
    got = seen[0]
    assert (got.width, got.height) == (40, 30)
    for f in ("world_view", "full_proj", "tanfovx", "tanfovy"):
        torch.testing.assert_close(getattr(got, f), getattr(cam, f), rtol=0, atol=0)
    torch.testing.assert_close(got.cam_center, cam.cam_center, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.proj, cam.proj, rtol=1e-5, atol=1e-6)


def test_served_render_equals_a_direct_render():
    """serve_step with a render_tiled callback sends the bytes of the direct
    render's uint8 image (the chip_smoke phase-14 check, on the CPU)."""
    model = to_port(sh1_scene(21, n=48))
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48, device="cpu")
    with torch.no_grad():
        direct = render_tiled(cam, model, [0.0, 0.0, 0.0], device="cpu").image
    want = (np.clip(direct.permute(1, 2, 0).numpy(), 0, 1) * 255).astype(np.uint8)
    assert want.std() > 0
    view, proj = viewer_matrices(cam)
    gui = NetworkGUI(port=0)

    @torch.no_grad()
    def render_fn(req):
        out = render_tiled(viewer_camera(req, device="cpu"), model, [0.0, 0.0, 0.0],
                           device="cpu")
        return out.image.permute(1, 2, 0)

    ((img, _),) = serve(gui, [message(64, 48, view, proj, fovx=0.9, fovy=0.7)], render_fn,
                        [64 * 48 * 3])
    assert img == want.tobytes()
