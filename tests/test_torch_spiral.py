"""The port's spiral path against the JAX package's on the same inputs: the
pose math, both spiral constructors on a fabricated poses_bounds.npy, the
Turbo table against matplotlib's, the depth colouring, and `cli spiral
--device cpu --no_video` against the JAX CLI on a tiny trained scene."""

import os

import numpy as np
import pytest
from matplotlib import colormaps
from PIL import Image

from binocular3dgs_tpu import cli as jax_cli
from binocular3dgs_tpu.render import pose_utils as jax_pose_utils
from binocular3dgs_tpu.render import spiral as jax_spiral
from binocular3dgs_torch import cli
from binocular3dgs_torch.data import colmap
from binocular3dgs_torch.render import pose_utils, spiral
from binocular3dgs_torch.render.turbo import TURBO, apply_lut

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)
from test_torch_cli import H, W, build_colmap_scene, trained_model_dir
from test_torch_project import sh1_scene


def llff_poses_bounds(cams, points, hwf):
    """poses_bounds.npy rows of COLMAP cameras [(R camera-to-world, T
    world-to-camera)]: the LLFF 3x5 matrix [down, right, backwards, centre,
    (H, W, focal)] and the near and far depth of `points` in each camera."""
    rows = []
    for R, T in cams:
        center = -R @ T
        pose = np.stack([R[:, 1], R[:, 0], -R[:, 2], center, hwf], axis=1)
        z = (points - center) @ R[:, 2]
        rows.append(np.concatenate([pose.ravel(), [z.min(), z.max()]]))
    return np.asarray(rows)


def fabricated_poses_bounds(n=9, seed=0):
    """n forward-facing cameras on a jittered arc before a cloud at z ~ 5."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(n):
        a = (i - n / 2) * 0.04 + rng.normal() * 0.01
        q = np.array([np.cos(a / 2), rng.normal() * 0.01, np.sin(a / 2), 0.0])
        R = colmap.qvec2rotmat(q / np.linalg.norm(q)).T
        cams.append((R, rng.normal(size=3) * 0.05))
    points = rng.normal(size=(200, 3)) * 0.5 + [0, 0, 5]
    return llff_poses_bounds(cams, points, np.array([48.0, 64.0, 60.0]))


def test_pose_utils_match_jax():
    pb = fabricated_poses_bounds()
    poses_o = pb[:, :-2].reshape(-1, 3, 5)
    poses = poses_o[:, :3, :4] @ spiral.FIX_ROTATION
    for name, args in (
        ("normalize", (poses[0, :, 0] * 3,)),
        ("pad_poses", (poses,)),
        ("poses_avg", (poses,)),
        ("recenter_poses", (poses,)),
        ("backcenter_poses", (poses[::-1], poses)),
        ("focus_pt_fn", (poses,)),
        ("generate_spiral_path", (poses, pb[:, -2:])),
        ("generate_spiral_path_dtu", (poses,)),
        ("convert_poses", (np.concatenate([poses_o, poses_o], 0).transpose(1, 2, 0),)),
    ):
        got = getattr(pose_utils, name)(*args)
        want = getattr(jax_pose_utils, name)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w, err_msg=name)  # the same numpy code


@pytest.mark.parametrize("kind", ["llff", "dtu"])
def test_spiral_cameras_match_jax(kind, tmp_path):
    np.save(tmp_path / "poses_bounds.npy", fabricated_poses_bounds(seed=1))
    make = {"llff": "create_llff_spiral", "dtu": "create_dtu_spiral"}[kind]
    got = getattr(spiral, make)(str(tmp_path), n_frames=12)
    want = getattr(jax_spiral, make)(str(tmp_path), n_frames=12)
    assert len(got.test_cameras) == len(want.test_cameras) == 12 and not got.train_cameras
    for g, w in zip(got.test_cameras, want.test_cameras):
        assert (g.width, g.height, g.image_path, g.image_name) == (64, 48, None, w.image_name)
        assert (g.fovx, g.fovy) == (w.fovx, w.fovy)
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.T, w.T)
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    # the cameras move along the path (two turns: frames k and k + 6 differ
    # in height only, except the first pair)
    assert len({tuple(np.round(c.T, 6)) for c in got.test_cameras}) == 11


def test_turbo_table_matches_matplotlib():
    cmap = colormaps["turbo"]
    assert cmap.N == TURBO.shape[0] == 256
    np.testing.assert_allclose(TURBO, cmap(np.arange(256))[:, :3], rtol=0, atol=1e-6)
    x = np.random.default_rng(0).random((40, 50))
    x[0, :4] = [0.0, 1.0, 0.5, 255 / 256]  # the ends and bin edges
    for dtype in (np.float32, np.float64):
        v = x.astype(dtype)
        np.testing.assert_allclose(apply_lut(TURBO, v), cmap(v)[..., :3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_visualize_cmap_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2, 9, (30, 40)).astype(np.float32)
    alpha = (rng.random((30, 40)) > 0.2).astype(np.float32)
    dnorm = 1.0 - (depth - depth.min()) / (depth.max() - depth.min() + 1e-12)
    dshow = 1.0 - dnorm * alpha
    got = spiral.visualize_cmap(dshow, np.ones_like(dshow), curve_fn=spiral.depth_curve_fn)
    want = jax_spiral.visualize_cmap(dshow, np.ones_like(dshow), colormaps.get_cmap("turbo"),
                                     curve_fn=jax_spiral.depth_curve_fn)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    weight = alpha * 0.7
    got = spiral.visualize_cmap(dshow, weight, lut=TURBO, percentile=90.0)
    want = jax_spiral.visualize_cmap(dshow, weight, colormaps.get_cmap("turbo"), percentile=90.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- cli spiral --------------------------------------------------------------


N_FRAMES = 4


def arc_cameras(n, dist=5.0, spread=0.1):
    """n cameras on an arc around the y axis, all looking at (0, 0, dist)."""
    cams = []
    for a in np.linspace(-spread, spread, n):
        c, s = np.cos(a), np.sin(a)
        Rw2c = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        center = np.array([dist * np.sin(a), 0.0, dist * (1.0 - np.cos(a))])
        cams.append((Rw2c.T, -Rw2c @ center))
    return cams


@pytest.fixture(scope="module", params=["llff", "dtu"])
def spirals(request, tmp_path_factory):
    """cli spiral of one trained model in both packages; a scene directory
    named scan* takes the DTU path, as in the reference. The spiral reads
    poses_bounds.npy alone: 9 cameras on an arc looking at the cloud."""
    root = tmp_path_factory.mktemp(f"spiral_{request.param}")
    scene = str(root / ("scan7" if request.param == "dtu" else "scene"))
    build_colmap_scene(scene)
    points = np.random.default_rng(0).normal(size=(50, 3)) * 0.5 + [0, 0, 5]
    np.save(os.path.join(scene, "poses_bounds.npy"),
            llff_poses_bounds(arc_cameras(9), points, np.array([H, W, 60.0])))
    model = sh1_scene(13, n=64)
    outs = {"jax": str(root / "jax"), "port": str(root / "port")}
    for out in outs.values():
        trained_model_dir(out, model)
    args = ["-s", scene, "--n_frames", str(N_FRAMES), "--no_video"]
    jax_cli.cmd_spiral(["-m", outs["jax"]] + args)
    assert cli.main(["spiral", "-m", outs["port"], "--device", "cpu"] + args) == 0
    return outs


@pytest.mark.parametrize("prefix", ["", "depth_", "cdepth_"])
def test_cli_spiral_matches_jax(spirals, prefix):
    sub = os.path.join("spiral", "ours_7")
    names = sorted(n for n in os.listdir(os.path.join(spirals["port"], sub))
                   if n[0].isdigit() == (prefix == "") and n.startswith(prefix))
    assert len(os.listdir(os.path.join(spirals["port"], sub))) == 3 * N_FRAMES
    assert names == [f"{prefix}{i:05d}.png" for i in range(N_FRAMES)]
    for name in names:
        a = np.asarray(Image.open(os.path.join(spirals["jax"], sub, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(spirals["port"], sub, name)), np.int16)
        assert a.shape == b.shape == (H, W, 3) and a.std() > 0, name
        if prefix == "cdepth_":
            # a depth 1e-5 apart may fall in the next of Turbo's 256 bins:
            # each pixel is its bin's colour within 1 LSB, the bins of the
            # two packages are at most 1 apart, and differ on < 2% of pixels
            lut = np.round(TURBO * 255)
            ia, ib = (np.abs(x[:, :, None] - lut).max(-1).argmin(-1) for x in (a, b))
            assert np.abs(a - lut[ia]).max() <= 1 and np.abs(b - lut[ib]).max() <= 1, name
            assert np.abs(ia - ib).max() <= 1 and (ia != ib).mean() < 0.02, name
            a, b = a[ia == ib], b[ia == ib]
        # both packages quantize the same float image (1e-5 apart)
        assert np.abs(a - b).max() <= 1, name
