"""What the benchmark loads, and how it refuses to run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as run_mod

ROOT = run_mod.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "binocular3dgs_tpu"}


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    found = top_level_modules("import benchmark.reference, benchmark.work, benchmark.scene, "
                              "benchmark.compare, benchmark.trace")
    assert not found & (FORBIDDEN | {"binocular3dgs_torch"})


def test_a_run_loads_no_jax():
    """A whole run of a cell, cut to the tiny size on the CPU, with its
    traced block and per-layer readers: no module whose top-level name,
    compared whole, is JAX's or the JAX package's."""
    code = (
        "import pytest, torch\n"
        "from benchmark import run as run_mod\n"
        "from benchmark.tests.tiny_cells import CPU, use_tiny_cells\n"
        "mp = pytest.MonkeyPatch()\n"
        "use_tiny_cells(mp)\n"
        "out = run_mod.run_cell('blender8.train', 7, 0.0, True, CPU)\n"
        "assert out['correct'] and out['metrics'], out\n"
    )
    found = top_level_modules(code)
    assert "binocular3dgs_torch" in found and not found & FORBIDDEN


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run_mod.main(["--workload", "llff3.train", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits with another code than 0 and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run_mod.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "llff3.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "blender8.train",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
