"""The port stands alone: no file of binocular3dgs_torch/, nor chip_smoke.py,
imports jax, flax or binocular3dgs_tpu, nor cv2 or scipy, which the card's
machine lacks (checked on the source, so a lazy import inside a function is
caught too)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "binocular3dgs_tpu", "cv2", "scipy")
FILES = sorted((REPO / "binocular3dgs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scans_the_port():
    assert len(FILES) > 15 and (REPO / "chip_smoke.py").exists()
    names = {str(p.relative_to(REPO)) for p in FILES}
    for module in ("ops/warp.py", "ops/knn.py", "models/densify.py", "train/state.py",
                   "train/step.py", "train/loop.py", "render/spiral.py", "render/pose_utils.py",
                   "render/network_gui.py", "eval/lpips.py", "quality_run.py",
                   "init/image_io.py", "init/geometry.py", "init/correlation.py",
                   "init/farneback.py", "init/matchers.py", "init/pipeline.py",
                   "init/pdcnet/model.py", "init/pdcnet/homography.py",
                   "init/pdcnet/inference.py", "orchestrate.py"):
        assert f"binocular3dgs_torch/{module}" in names, module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
