"""`cli triangulate --matcher pdcnet --pdcnet_weights` of the port on the
CPU: the same seeded random weights (no checkpoint is in the repository) as
a `.pth` and as the npz both packages read give equal PLYs, the matcher
finds matches (P_R >= 0.1 leaves them with random weights), and without
weights the command raises as the JAX CLI does. The GOCor iterations are
cut to 1 and 1 and the views to 2 to keep it short on the CPU (8 network
passes of 256x256 per run: mode h and cyclic consistency)."""

import functools
import os

import numpy as np
import pytest
import torch

from binocular3dgs_torch import cli
from binocular3dgs_torch.data.ply import fetch_point_cloud
from binocular3dgs_torch.init.matchers import PDCNetPlusMatcher
from binocular3dgs_torch.init.pdcnet import convert
from binocular3dgs_torch.init.pdcnet.inference import PDCNetPlus
from binocular3dgs_torch.init.pdcnet.model import random_model

from test_cli import build_colmap_scene
from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

H_IMG, W_IMG = 96, 128


def test_cli_triangulate_pth_and_npz(tmp_path, monkeypatch):
    scene = str(tmp_path / "scene")
    build_colmap_scene(scene, n_views=9, w=W_IMG, h=H_IMG)
    pth, npz = str(tmp_path / "w.pth"), str(tmp_path / "w.npz")
    weights = random_model(0).state_dict()
    torch.save(weights, pth)
    convert.save_npz(weights, npz)
    monkeypatch.setattr(PDCNetPlus, "__init__", functools.partialmethod(
        PDCNetPlus.__init__, global_optim_iter=1, local_optim_iter=1))
    counts = []
    original = PDCNetPlusMatcher.get_matches_and_confidence

    def counted(self, ref, src):
        out = original(self, ref, src)
        counts.append(len(out["kp_source"]))
        return out

    monkeypatch.setattr(PDCNetPlusMatcher, "get_matches_and_confidence", counted)
    plys = []
    for name, w in (("pth", pth), ("npz", npz)):
        out = str(tmp_path / name)
        argv = ["triangulate", "-s", scene, "--output_path", out, "--resolution", "1",
                "--n_views", "2", "--matcher", "pdcnet", "--pdcnet_weights", w,
                "--growth_iterations", "2", "--ssim_threshold", "0.0", "--device", "cpu"]
        assert cli.main(argv) == 0
        plys.append(os.path.join(out, "scene_keypoints_to_3d.ply"))
    assert len(counts) == 4 and counts[:2] == counts[2:] and min(counts) >= 200, counts
    a, b = fetch_point_cloud(plys[0]), fetch_point_cloud(plys[1])
    assert len(a.points) > 0
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.colors, b.colors)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        cli.main(["triangulate", "-s", scene, "--matcher", "pdcnet", "--device", "cpu"])
