"""The port's CLI (render + metrics + aggregate, in-process, --device cpu)
against the JAX CLI on the same tiny fabricated COLMAP scene and trained
model; `cli train` is held in test_torch_train.py and
test_torch_checkpoint.py, `cli spiral` in test_torch_spiral.py,
`metrics --lpips_weights` in test_torch_lpips.py, `cli triangulate` in
test_torch_init_pipeline.py and `cli run` in test_torch_orchestrate.py."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from binocular3dgs_tpu import cli as jax_cli
from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.config import save_config as jax_save_config
from binocular3dgs_tpu.models.gaussians import save_ply as jax_save_ply
from binocular3dgs_torch import cli
from binocular3dgs_torch.config import RasterConfig, load_config
from binocular3dgs_torch.data import colmap

from test_torch_project import sh1_scene

W, H = 64, 48


def build_colmap_scene(root, n_views=9, w=W, h=H):
    """9 views on a small arc looking down +z, numpy-seeded images."""
    os.makedirs(f"{root}/sparse/0", exist_ok=True)
    os.makedirs(f"{root}/images", exist_ok=True)
    rng = np.random.default_rng(0)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", w, h, np.array([60.0, 60.0, w / 2, h / 2]))}
    images = {}
    for i in range(1, n_views + 1):
        ang = (i - n_views / 2) * 0.03
        q = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0.0])
        t = np.array([0.02 * i, 0.0, 0.0])
        images[i] = colmap.ColmapImage(
            i, q, t, 1, f"im_{i:02d}.png", np.zeros((0, 2)), np.zeros(0, dtype=np.int64)
        )
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
            f"{root}/images/im_{i:02d}.png"
        )
    pts = rng.normal(size=(50, 3)) * 0.5 + [0, 0, 5]
    colmap.write_cameras_binary(f"{root}/sparse/0/cameras.bin", cams)
    colmap.write_images_binary(f"{root}/sparse/0/images.bin", images)
    colmap.write_points3d_binary(
        f"{root}/sparse/0/points3D.bin", pts, rng.integers(0, 255, (50, 3)), np.zeros((50, 1))
    )


def trained_model_dir(path, model):
    """A model directory as training leaves it: cfg_args.json + one PLY."""
    os.makedirs(f"{path}/point_cloud/iteration_7", exist_ok=True)
    cfg = JaxConfig()
    cfg.model.eval = True
    jax_save_config(cfg, f"{path}/cfg_args.json")
    jax_save_ply(model, f"{path}/point_cloud/iteration_7/point_cloud.ply")


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = str(root / "scene")
    build_colmap_scene(scene)
    model = sh1_scene(11, n=64)
    outs = {"jax": str(root / "jax"), "port": str(root / "port")}
    for out in outs.values():
        trained_model_dir(out, model)
    args = ["-s", scene, "--eval"]
    jax_cli.cmd_render(["-m", outs["jax"]] + args)
    jax_cli.cmd_metrics(["-m", outs["jax"]])
    assert cli.main(["render", "-m", outs["port"], "--device", "cpu"] + args) == 0
    assert cli.main(["metrics", "-m", outs["port"], "--device", "cpu"]) == 0
    return outs


@pytest.mark.parametrize("split", ["train", "test"])
def test_renders_match_jax(rendered, split):
    sub = f"{split}/ours_7/renders"
    names = sorted(os.listdir(os.path.join(rendered["jax"], sub)))
    assert names == sorted(os.listdir(os.path.join(rendered["port"], sub)))
    assert len(names) == (3 if split == "train" else 2)  # LLFF: 3 views, every 8th held out
    for name in names:
        a = np.asarray(Image.open(os.path.join(rendered["jax"], sub, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(rendered["port"], sub, name)), np.int16)
        assert a.shape == (H, W, 3) and a.std() > 0
        # both packages quantize the same float image; 1e-5 differences may
        # cross a rounding edge
        assert np.abs(a - b).max() <= 1, name


def test_results_match_jax(rendered):
    with open(os.path.join(rendered["jax"], "results.json")) as f:
        want = json.load(f)["ours_7"]
    with open(os.path.join(rendered["port"], "results.json")) as f:
        got = json.load(f)["ours_7"]
    assert got["LPIPS"] is None
    for k in ("PSNR", "SSIM"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 1e-4, k  # 1-LSB image differences, float32 sums


def test_aggregate_and_config(rendered, capsys):
    assert cli.main(["aggregate", "-m", rendered["port"]]) == 0
    assert "ours_7" in json.loads(capsys.readouterr().out)
    cfg = load_config(os.path.join(rendered["port"], "cfg_args.json"))  # written by the JAX package
    assert cfg.model.eval and cfg.raster == RasterConfig()


def test_render_reads_settings_from_cfg_args_alone(tmp_path):
    """A cfg_args.json without `eval`: both packages ignore the command
    line's --eval (and -r, -i, -w, --sh_degree) and render every view as a
    train view."""
    scene = str(tmp_path / "scene")
    build_colmap_scene(scene)
    model = sh1_scene(12, n=32)
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for out in outs.values():
        os.makedirs(f"{out}/point_cloud/iteration_3", exist_ok=True)
        jax_save_config(JaxConfig(), f"{out}/cfg_args.json")  # eval false
        jax_save_ply(model, f"{out}/point_cloud/iteration_3/point_cloud.ply")
    flags = ["-s", scene, "--eval", "-r", "2", "-w", "--sh_degree", "3"]
    jax_cli.cmd_render(["-m", outs["jax"]] + flags)
    assert cli.main(["render", "-m", outs["port"], "--device", "cpu"] + flags) == 0
    for out in outs.values():
        assert not os.path.exists(os.path.join(out, "test"))  # no held-out split
        names = os.listdir(os.path.join(out, "train", "ours_3", "renders"))
        assert len(names) == 9  # every view, at the full 64x48
        im = Image.open(os.path.join(out, "train", "ours_3", "renders", names[0]))
        assert im.size == (W, H)
    for name in os.listdir(os.path.join(outs["jax"], "train", "ours_3", "renders")):
        a = np.asarray(Image.open(os.path.join(outs["jax"], "train/ours_3/renders", name)),
                       np.int16)
        b = np.asarray(Image.open(os.path.join(outs["port"], "train/ours_3/renders", name)),
                       np.int16)
        assert np.abs(a - b).max() <= 1, name  # as in test_renders_match_jax
