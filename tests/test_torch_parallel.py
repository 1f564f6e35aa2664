"""The port's parallel/sharding.py over gloo ranks on the CPU, against the
JAX package's sharded render (on the conftest's virtual CPU mesh) and
single-device step, and against the port's single-process render, on the
same numpy inputs at W, H = 64, 48 (TH = 3 tile rows). 2 ranks take the
tile rows 0-1 and 2-3, the second band's last row below the image; 4 ranks
take one row each, rank 3's band wholly below the image. Each rank is a
process (tests/torch_parallel_worker.py, one torch thread) and they meet
over a file:// rendezvous in the test's temporary directory."""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.config import Config as JaxConfig
from binocular3dgs_tpu.ops.rasterize import render_tiled as jax_render_tiled
from binocular3dgs_tpu.parallel.sharding import make_mesh as jax_make_mesh
from binocular3dgs_tpu.parallel.sharding import make_sharded_render as jax_make_sharded_render
from binocular3dgs_tpu.train import state as jax_state
from binocular3dgs_tpu.train.step import make_train_step as jax_make_train_step
from binocular3dgs_torch.models.gaussians import PARAM_NAMES
from binocular3dgs_torch.ops.rasterize import render_tiled
from binocular3dgs_torch.parallel.multihost import run_processes
from binocular3dgs_torch.train import state as state_mod

from test_torch_project import FOVX, FOVY, H, W, camera_pair, to_port
from test_torch_train import (
    JAX_XLA, STEP_ITER, assert_first_step_state_close, jax_trans, step_inputs,
)
from torch_parallel_worker import render_grads

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
RANKS = (2, 4)
OUTPUTS = ("image", "depth", "alpha", "radii")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs and every rank's results at each world size."""
    m, gt, aw = step_inputs()  # 40 gaussians at capacity 48: 24 and 12 rows per rank
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(3)
    c = SimpleNamespace(m=m, gt=gt, aw=aw, key=key, trans=jax_trans(key, 0.4),
                        bg=np.asarray([0.2, 0.1, 0.3], np.float32),
                        tgt=rng.random((3, H, W)).astype(np.float32))
    root = tmp_path_factory.mktemp("parallel")
    inputs = str(root / "inputs.npz")
    np.savez(inputs, **{f"params.{n}": np.asarray(getattr(m.params, n)) for n in PARAM_NAMES},
             active=np.asarray(m.active), active_sh=m.active_sh_degree, size=[W, H],
             fov=[FOVX, FOVY], bg=c.bg, tgt=c.tgt, gt=gt, aw=aw, trans=c.trans)
    c.outs = {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for n in RANKS:
        out = root / f"ranks{n}"
        out.mkdir()
        run_processes([[sys.executable, WORKER, "cpu", inputs, str(out), f"file://{root}/rdv{n}",
                        str(n), str(r)] for r in range(n)], timeout=300, env=env)
        c.outs[n] = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return c


def port_render(cam, model, bg, mean2d_carrier=None):
    return render_tiled(cam, model, bg, device="cpu", mean2d_carrier=mean2d_carrier)


@pytest.mark.parametrize("ranks", RANKS)
def test_every_rank_holds_the_same_results(case, ranks):
    """The gathered images, the all-reduced gradients and the states are
    replicated: every rank's bits equal rank 0's."""
    first = case.outs[ranks][0]
    for other in case.outs[ranks][1:]:
        assert other.keys() == first.keys()
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("ranks", RANKS)
def test_band_render_matches_jax_and_the_single_render(case, ranks):
    got = case.outs[ranks][0]
    jcam, pcam = camera_pair()
    jax_sharded = jax_make_sharded_render(jax_make_mesh(ranks), W, H, JAX_XLA)
    want = jax.jit(lambda mm: jax_sharded(jcam, mm, jnp.asarray(case.bg)))(case.m)
    with torch.no_grad():
        single = port_render(pcam, to_port(case.m), torch.from_numpy(case.bg))
    # the tolerances of tests/test_parallel.py (float32 blends in another order)
    for name, ref in (("jax", want), ("port single", single)):
        ref = {k: np.asarray(getattr(ref, k)) for k in OUTPUTS}
        np.testing.assert_allclose(got["rep.image"], ref["image"], atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got["rep.depth"], ref["depth"], atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got["rep.alpha"], ref["alpha"], atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got["rep.radii"], ref["radii"], err_msg=name)
    assert got["rep.image"].shape == (3, H, W) and got["rep.alpha"].max() > 0.5
    # the largest band's pairs, at most the whole image's
    assert 0 < int(got["rep.num_pairs"]) <= int(single.num_pairs)


def single_grads(case):
    _, pcam = camera_pair()
    return render_grads(port_render, pcam, to_port(case.m), torch.from_numpy(case.bg),
                        torch.from_numpy(case.tgt))


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("tag", ["rep", "shg"])
def test_band_render_gradients_match_the_single_render(case, ranks, tag):
    """The parameters' and the carrier's gradients through the band gather
    (`rep`) and through the gathered vertex stage of shard_gaussians (`shg`),
    each field within 1e-5 of its largest value: sums over bands and ranks
    in another order than the single render's."""
    got = case.outs[ranks][0]
    for k, want in single_grads(case).items():
        scale = np.abs(want).max()
        assert (scale > 0) == (k != "grad.f_rest"), k  # SH degree 0: f_rest has none
        np.testing.assert_allclose(got[f"{tag}.{k}"], want, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("ranks", RANKS)
def test_shard_gaussians_renders_as_the_replicated_vertex_stage(case, ranks):
    """Projecting capacity / ranks rows per rank and gathering the fields
    gives the replicated render's outputs: the projection is row by row."""
    got = case.outs[ranks][0]
    for k in (*OUTPUTS, "num_pairs", "max_tile_pairs"):
        np.testing.assert_array_equal(got[f"shg.{k}"], got[f"rep.{k}"], err_msg=k)


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_step_matches_the_jax_single_device_step(case, ranks):
    """One band-sharded binocular step against JAX's make_train_step on one
    device, at the tolerances of test_torch_train.py's
    test_binocular_step_matches_jax."""
    got = case.outs[ranks][0]
    jcam, _ = camera_pair()

    def jax_render(cam, model, bg, mean2d_carrier=None):
        return jax_render_tiled(cam, model, bg, mean2d_carrier=mean2d_carrier, raster=JAX_XLA)

    jstep = jax_make_train_step(jax_render, JaxConfig(), 1.0, binocular=True,
                                use_alpha_weight=True)
    want, wm = jstep(jax_state.init_train_state(case.m), jcam, jnp.asarray(case.gt),
                     jnp.asarray(case.aw), jnp.int32(STEP_ITER), case.key, jnp.zeros(3))
    for k in ("loss", "l1", "disparity_loss", "alpha_loss"):
        w = float(getattr(wm, k))
        assert abs(float(got[f"step.metrics.{k}"]) - w) <= 1e-5 * abs(w), k
    assert int(got["step.metrics.n_visible"]) == int(wm.n_visible)
    assert int(got["step.adam_step"]) == int(want.adam_step) == 1
    m = case.m
    state = state_mod.from_numpy(
        {n: got[f"step.{n}"] for n in PARAM_NAMES}, np.asarray(m.active),
        {n: got[f"step.adam_m.{n}"] for n in PARAM_NAMES},
        {n: got[f"step.adam_v.{n}"] for n in PARAM_NAMES}, 1, got["step.grad_accum"],
        got["step.denom"], got["step.max_radii2d"], m.max_sh_degree, m.active_sh_degree,
        1.0, device="cpu")
    assert_first_step_state_close(state, want, m)


@pytest.mark.parametrize("ranks", RANKS)
def test_shard_adam_equals_the_replicated_adam(case, ranks):
    """3 steps with the moments split by rows (each rank holds capacity /
    ranks rows of each) against 3 with them replicated: losses, parameters,
    moments and statistics equal bit for bit (elementwise Adam on the same
    values, rows exchanged by exact copies)."""
    got = case.outs[ranks][0]
    cap = case.m.capacity
    np.testing.assert_array_equal(got["adam_shd.moment_rows"], cap // ranks)
    rep = {k[len("adam_rep."):]: v for k, v in got.items() if k.startswith("adam_rep.")}
    assert len(rep) == 3 * len(PARAM_NAMES) + 5
    for k, v in rep.items():
        np.testing.assert_array_equal(got[f"adam_shd.{k}"], v, err_msg=k)
    assert int(got["adam_shd.adam_step"]) == 3
    assert np.abs(got["adam_shd.adam_m.xyz"]).max() > 0
