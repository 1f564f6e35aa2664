"""The port's quality twin (`python -m binocular3dgs_torch.quality_run`):
its golden renders against the JAX `render_dense` on the same scene and
cloud at a reduced size, and the whole protocol on the CPU at a tiny size
and a few iterations."""

import json
import os

import jax.numpy as jnp
import numpy as np

from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.data.dataset import Scene as JaxScene
from binocular3dgs_tpu.models.gaussians import GaussianModel as JaxModel
from binocular3dgs_tpu.models.gaussians import GaussianParams as JaxParams
from binocular3dgs_tpu.ops.rasterize_reference import render_dense as jax_render_dense
from binocular3dgs_torch import quality_run
from binocular3dgs_torch.models.gaussians import PARAM_NAMES

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

SIZE = 48  # the protocol's 256, reduced


def test_golden_renders_match_jax(tmp_path):
    scene = str(tmp_path / "scene")
    renders = quality_run.build_scene(scene, size=SIZE, device="cpu")
    assert len(renders) == quality_run.N_VIEWS
    model, _, _ = quality_run.golden_model(np.random.default_rng(7), "cpu")
    jmodel = JaxModel(
        params=JaxParams(**{n: jnp.asarray(getattr(model.params, n).numpy())
                            for n in PARAM_NAMES}),
        active=jnp.asarray(model.active.numpy()), max_sh_degree=1, active_sh_degree=0)
    cfg = JaxConfig()
    cfg.model.source_path, cfg.model.eval = scene, True
    cfg.train.dataset_name, cfg.train.n_views = "LLFF", 7
    jscene = JaxScene.load(cfg, shuffle=False)
    views = list(jscene.train_views) + list(jscene.test_views)
    assert sorted(f"{v.image_name}.png" for v in views) == sorted(renders)
    for v in views:
        want = np.asarray(jax_render_dense(v.camera, jmodel, jnp.zeros(3)).image)
        got = renders[f"{v.image_name}.png"].numpy()
        assert got.shape == (3, SIZE, SIZE) and want.std() > 0.05
        # float32 dense blends of ~1.2k splats in another order
        assert np.abs(got - want).max() <= 1e-4, v.image_name


def test_quality_run_end_to_end_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "q")
    ret = quality_run.run(out, "cpu", iterations=20, size=SIZE)
    with open(os.path.join(out, "quality.json")) as f:
        rec = json.load(f)
    assert rec == ret
    assert rec["device"] == "cpu" and rec["card"] is None and rec["iterations"] == 20
    assert rec["method"] == "ours_20" and rec["lpips"] is None
    assert np.isfinite(rec["psnr"]) and 0 < rec["ssim"] <= 1
    tests = os.listdir(os.path.join(out, "model", "test", "ours_20", "renders"))
    assert len(tests) == 2  # views 0 and 8 held out of 9
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
