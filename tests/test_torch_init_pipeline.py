"""The port's dense-init pipeline (binocular3dgs_torch/init/pipeline.py, `cli
triangulate`) against the JAX package's on the CPU:

  * `load_scene_for_init`: the same images bit for bit and the same K
  * `triangulate_pairs` with one fake matcher fed to both: points within
    1e-9 (float64 DLT and filters), colours equal, DTU shell included
  * `grow_points_llff`: every iteration's candidate scores within 1e-5, and
    every keep decision equal wherever the JAX score is more than 1e-4 from
    the threshold (the count of candidates inside that margin is printed)
  * `triangulate_scene` / `cli triangulate` on `test_cli.build_colmap_scene`,
    compared as point sets (matches of equal confidence are ordered
    differently by the two sorts)
"""

import os

import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init import pipeline as jax_pipeline
from binocular3dgs_tpu.init.matchers import FarnebackMatcher as JaxMatcher
from binocular3dgs_torch import cli
from binocular3dgs_torch.data.ply import fetch_point_cloud
from binocular3dgs_torch.init import pipeline
from binocular3dgs_torch.init.matchers import FarnebackMatcher

from test_cli import build_colmap_scene
from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

MARGIN = 1e-4  # |JAX score - threshold| beyond which keep decisions must agree


def three_cameras():
    K = np.array([[100.0, 0, 32.0], [0, 100.0, 24.0], [0, 0, 1]])
    c2ws = []
    for t in ([0, 0, 0], [0.5, 0.1, 0.0], [-0.3, 0.2, 0.1]):
        c2w = np.eye(4)
        c2w[:3, 3] = t
        c2ws.append(c2w)
    return K, c2ws


class FakeMatcher:
    """Projections of 40 seeded points, a quarter of them corrupted, for
    each (ref, src) pair; the views are told apart by their first pixel."""

    def __init__(self, K, c2ws):
        rng = np.random.default_rng(0)
        self.pts = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                             rng.uniform(4, 8, 40)], 1)
        self.K, self.c2ws = K, c2ws
        self.noise = rng.uniform(5, 20, (10, 2))

    def uv(self, i):
        w2c = np.linalg.inv(self.c2ws[i])
        pc = self.pts @ w2c[:3, :3].T + w2c[:3, 3]
        pi = pc @ self.K.T
        return pi[:, :2] / pi[:, 2:3]

    def get_matches_and_confidence(self, a, b):
        i, j = int(np.asarray(a)[0, 0, 0]), int(np.asarray(b)[0, 0, 0])
        s, t = self.uv(i), self.uv(j).copy()
        t[:10] += self.noise
        return {"kp_source": s.astype(np.float32), "kp_target": t.astype(np.float32),
                "confidence_value": np.ones(40, np.float32)}


@pytest.mark.parametrize("dataset", ["LLFF", "DTU"])
def test_triangulate_pairs_matches_jax(dataset):
    K, c2ws = three_cameras()
    rng = np.random.default_rng(1)
    images = []
    for i in range(3):
        img = rng.integers(0, 200, (48, 64, 3), dtype=np.uint8)
        img[:6, 40:52] = 255  # near-white: the DTU shell
        img[0, 0, 0] = i
        images.append(img)
    cfg_j = jax_pipeline.TriangulateConfig(dataset_name=dataset, growth_iterations=0)
    cfg_t = pipeline.TriangulateConfig(dataset_name=dataset, growth_iterations=0)
    pj, cj = jax_pipeline.triangulate_pairs(images, K, c2ws, [0, 1, 2], FakeMatcher(K, c2ws), cfg_j)
    pt, ct = pipeline.triangulate_pairs(images, K, c2ws, [0, 1, 2], FakeMatcher(K, c2ws), cfg_t)
    assert len(pt) == len(pj) > (3 * 6 * 12 if dataset == "DTU" else 0)
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ct, cj)


def recording(module, calls):
    """Wrap `module._make_candidate_scorer` to record every score vector."""
    make = module._make_candidate_scorer

    def wrapped(h):
        score = make(h)

        def run(*a):
            out = score(*a)
            calls.append(np.asarray(out.cpu() if torch.is_tensor(out) else out, np.float64))
            return out
        return run
    return wrapped


def growth_scene():
    """tests/test_init.py's growth scene: two cameras, smooth gradient
    images, 10 seeds on the optical axis."""
    K, c2ws = three_cameras()
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 2, yy * 3, xx + yy], -1).astype(np.uint8)
    seeds = np.stack([np.zeros(10), np.zeros(10), np.linspace(4.5, 5.5, 10)], 1)
    return [img, img], K, c2ws[:2], seeds, np.full((10, 3), 128, np.uint8)


def test_growth_scores_and_decisions_match_jax(monkeypatch):
    images, K, c2ws, seeds, colors = growth_scene()
    kw = dict(dataset_name="LLFF", growth_iterations=12, growth_alpha=0.3,
              sample_points_num=10, sample_num=50, ssim_threshold=0.95, seed=0)
    calls_j, calls_t = [], []
    monkeypatch.setattr(jax_pipeline, "_make_candidate_scorer", recording(jax_pipeline, calls_j))
    monkeypatch.setattr(pipeline, "_make_candidate_scorer", recording(pipeline, calls_t))
    pj, cj = jax_pipeline.grow_points_llff(seeds, colors, images, K, c2ws, [0, 1],
                                           jax_pipeline.TriangulateConfig(**kw))
    pt, ct = pipeline.grow_points_llff(seeds, colors, images, K, c2ws, [0, 1],
                                       pipeline.TriangulateConfig(**kw), device="cpu")
    assert len(calls_j) == len(calls_t) == kw["growth_iterations"]
    near, same = 0, True
    for it, (sj, st) in enumerate(zip(calls_j, calls_t)):
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5, err_msg=f"iteration {it}")
        far = np.abs(sj - kw["ssim_threshold"]) > MARGIN
        near += int((~far).sum())
        np.testing.assert_array_equal((st >= 0.95)[far], (sj >= 0.95)[far])
        same &= bool(np.array_equal(st >= 0.95, sj >= 0.95))
    print(f"candidates within {MARGIN} of the threshold: {near} of "
          f"{sum(len(s) for s in calls_j)}; all decisions equal: {same}")
    assert len(pj) > len(seeds)
    if same:  # the same candidates kept: the same points and colours
        np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(ct, cj)


def test_growth_repeats_and_respects_threshold():
    images, K, c2ws, seeds, colors = growth_scene()
    kw = dict(dataset_name="LLFF", growth_iterations=3, growth_alpha=0.3,
              sample_points_num=10, sample_num=30, seed=4)
    cfg = pipeline.TriangulateConfig(**kw)
    a, _ = pipeline.grow_points_llff(seeds, colors, images, K, c2ws, [0, 1], cfg, device="cpu")
    b, _ = pipeline.grow_points_llff(seeds, colors, images, K, c2ws, [0, 1], cfg, device="cpu")
    np.testing.assert_array_equal(a, b)
    cfg.ssim_threshold = 1.1  # unreachable: nothing grows
    c, _ = pipeline.grow_points_llff(seeds, colors, images, K, c2ws, [0, 1], cfg, device="cpu")
    assert len(c) == len(seeds)


@pytest.mark.parametrize("resolution", [1, 2])
def test_load_scene_matches_jax(tmp_path, resolution):
    scene = str(tmp_path / "scene")
    build_colmap_scene(scene, w=67, h=51)
    ij, Kj, cj, nj = jax_pipeline.load_scene_for_init(scene, "images", resolution)
    it, Kt, ct, nt = pipeline.load_scene_for_init(scene, "images", resolution, device="cpu")
    assert nt == nj and len(it) == len(ij) == 9
    for a, b in zip(it, ij):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_allclose(np.stack(ct), np.stack(cj), rtol=1e-12, atol=1e-12)


def assert_same_point_set(got, want, tol=1e-4, share=0.99):
    """Each cloud's points have a partner in the other within `tol` on at
    least `share` of them, and the counts agree within 1 - share."""
    assert abs(len(got) - len(want)) <= (1 - share) * len(want) + 1, (len(got), len(want))
    for a, b in ((got, want), (want, got)):
        d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)
        assert (d <= tol).mean() >= share, np.quantile(d, [0.5, 0.99, 1.0])


def test_triangulate_scene_matches_jax(tmp_path):
    scene = str(tmp_path / "scene")
    build_colmap_scene(scene, n_views=9)
    kw = dict(dataset_name="LLFF", n_views=3, resolution=1, growth_iterations=0)
    ply_j = jax_pipeline.triangulate_scene(scene, str(tmp_path / "jax"),
                                           JaxMatcher(scaling=1.0, stride=2),
                                           jax_pipeline.TriangulateConfig(**kw))
    ply_t = pipeline.triangulate_scene(scene, str(tmp_path / "port"),
                                       FarnebackMatcher(scaling=1.0, stride=2, device="cpu"),
                                       pipeline.TriangulateConfig(**kw), device="cpu")
    assert os.path.basename(ply_t) == os.path.basename(ply_j) == "scene_keypoints_to_3d.ply"
    want, got = fetch_point_cloud(ply_j), fetch_point_cloud(ply_t)
    assert len(want.points) > 100
    assert_same_point_set(got.points, want.points)
    key = lambda pc: {tuple(np.round(p, 4)) + tuple(c) for p, c in zip(pc.points, pc.colors)}
    assert len(key(got) & key(want)) >= 0.99 * len(key(want))


def test_cli_triangulate(tmp_path, capsys):
    """`cli triangulate --device cpu` with the default matcher and growth,
    against the JAX triangulate_scene without growth: the grown cloud holds
    the JAX package's dense points; `--matcher pdcnet` exits non-zero; the
    default device, cuda, raises without a card."""
    scene = str(tmp_path / "scene")
    build_colmap_scene(scene, n_views=9)
    out = str(tmp_path / "kp")
    argv = ["triangulate", "-s", scene, "--output_path", out, "--resolution", "1",
            "--growth_iterations", "3", "--ssim_threshold", "0.6", "--device", "cpu"]
    assert cli.main(argv) == 0
    ply = os.path.join(out, "scene_keypoints_to_3d.ply")
    assert f"wrote {ply}" in capsys.readouterr().out
    want = jax_pipeline.triangulate_scene(
        scene, str(tmp_path / "jax"), JaxMatcher(),
        jax_pipeline.TriangulateConfig(resolution=1, growth_iterations=0))
    got, dense = fetch_point_cloud(ply).points, fetch_point_cloud(want).points
    assert len(got) >= len(dense) > 0
    assert_same_point_set(got[:len(dense)], dense)
    assert cli.main(["triangulate", "-s", scene, "--matcher", "pdcnet", "--device", "cpu"]) != 0
    assert "not yet ported" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the default device is cuda: no card, no run
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["triangulate", "-s", scene, "--output_path", out])
