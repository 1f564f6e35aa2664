"""The port's dispatcher (binocular3dgs_torch/orchestrate.py, `cli run`) against
the JAX package's: the same protocols, the same stage order and flags (plus
`--device`), GPU slots pinned by CUDA_VISIBLE_DEVICES, the dense-PLY path
that both packages share with its difference from the reference, and one
`cli run` of a tiny scene on the CPU through real subprocesses."""

import dataclasses
import inspect
import os

import pytest

from binocular3dgs_tpu import orchestrate as jax_orchestrate
from binocular3dgs_tpu.data import readers as jax_readers
from binocular3dgs_torch import cli, orchestrate
from binocular3dgs_torch.data import readers
from binocular3dgs_torch.data.ply import fetch_point_cloud

from test_cli import build_colmap_scene
from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_protocols_match_jax():
    assert orchestrate.PROTOCOLS.keys() == jax_orchestrate.PROTOCOLS.keys()
    for name, proto in orchestrate.PROTOCOLS.items():
        assert dataclasses.asdict(proto) == dataclasses.asdict(jax_orchestrate.PROTOCOLS[name])
    llff, dtu, blender = (orchestrate.PROTOCOLS[k] for k in ("LLFF", "DTU", "Blender"))
    assert (llff.n_views, llff.resolution, llff.iterations) == (3, 2, 30000)
    assert (dtu.n_views, dtu.resolution) == (3, 4)
    assert blender.n_views == 8 and blender.iterations == 7000 and not blender.run_triangulate
    assert "--shift_cam_start" in blender.extra_train_flags


def record_calls(monkeypatch, module):
    calls = []

    def fake_cli(args, env=None):
        calls.append([str(a) for a in args])
        return 0

    monkeypatch.setattr(module, "_cli", fake_cli)
    return calls


@pytest.mark.parametrize("dataset", ["LLFF", "Blender"])
def test_dispatch_stage_order_and_flags(monkeypatch, tmp_path, dataset):
    """Both packages run triangulate (not for Blender) -> train -> render ->
    metrics with the protocol's flags; the port adds `--device` to each."""
    out = str(tmp_path / "out")
    got, want = record_calls(monkeypatch, orchestrate), record_calls(monkeypatch, jax_orchestrate)
    assert orchestrate.dispatch_jobs(dataset, str(tmp_path), out, scenes=["s"], max_workers=1,
                                     device="cpu") == {"s": True}
    assert jax_orchestrate.dispatch_jobs(dataset, str(tmp_path), out, scenes=["s"],
                                         max_workers=1) == {"s": True}
    stages = ["train", "render", "metrics"]
    if dataset == "LLFF":
        stages = ["triangulate"] + stages
    assert [c[0] for c in got] == [c[0] for c in want] == stages
    for g, w in zip(got, want):
        assert g == w + ["--device", "cpu"]


def test_dense_ply_path_differs_from_train_lookup(monkeypatch, tmp_path):
    """The JAX defect the port keeps: run_scene writes the dense PLY under
    <out>/keypoints_to_3d/<dataset>, train is given no keypoints root, and
    both readers look under ./keypoints_to_3d/<tag>/ of the working
    directory."""
    out = str(tmp_path / "out")
    for module, reader in ((orchestrate, readers), (jax_orchestrate, jax_readers)):
        calls = record_calls(monkeypatch, module)
        module.run_scene("fern", str(tmp_path), out, module.PROTOCOLS["LLFF"])
        tri, train = calls[0], calls[1]
        assert tri[tri.index("--output_path") + 1] == os.path.join(out, "keypoints_to_3d", "LLFF")
        assert not any("keypoints" in a for a in train)
        root = inspect.signature(reader.read_colmap_scene).parameters["keypoints_root"].default
        assert root == "keypoints_to_3d"  # relative to the working directory


def test_device_slots(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert orchestrate.available_device_slots() == [
        {"CUDA_VISIBLE_DEVICES": str(i)} for i in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert orchestrate.available_device_slots() == [{}]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert orchestrate.available_device_slots() == [{}]


def test_run_without_a_card_raises(tmp_path):
    """`cli run` defaults to cuda and raises before any stage when there is
    no card (this host has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["run", "--dataset_name", "LLFF", "--data_path", str(tmp_path)])


def test_cli_run_tiny_scene_on_cpu(monkeypatch, tmp_path):
    """`cli run --device cpu` of a 49-view 64x48 scene under the DTU
    protocol cut to 3 iterations (DTU: no growth, whose 1000 iterations of
    20,000 candidates take minutes on a CPU), each stage a subprocess of the
    port's CLI: the dense PLY is written, and, with the default output path,
    training starts from the sparse COLMAP cloud, as in the JAX package."""
    data = tmp_path / "data"
    build_colmap_scene(str(data / "scan1"), n_views=49)
    monkeypatch.setitem(orchestrate.PROTOCOLS, "DTU",
                        dataclasses.replace(orchestrate.PROTOCOLS["DTU"], iterations=3))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO)
    assert cli.main(["run", "--dataset_name", "DTU", "--data_path", str(data),
                     "--scenes", "scan1", "--max_workers", "1", "--device", "cpu"]) == 0
    out = tmp_path / "output" / "DTU"
    dense = fetch_point_cloud(str(out / "keypoints_to_3d" / "DTU" / "scan1_keypoints_to_3d.ply"))
    model = out / "scan1_3views"
    loaded = fetch_point_cloud(str(model / "input.ply"))
    sparse = fetch_point_cloud(str(data / "scan1" / "sparse" / "0" / "points3D.ply"))
    assert len(dense.points) > 0 and len(loaded.points) == len(sparse.points) == 150
    assert (model / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()
    assert (model / "results.json").exists()
