"""The PDCNet+ port's model (binocular3dgs_torch/init/pdcnet/model.py) and
weight converter (convert.py) against the JAX package's `pdcnet_forward`
and `convert`, on the CPU, with seeded random weights (`random_model`: no
checkpoint is in the repository).

  * names and shapes: the JAX forward, traced at full depth (3 global and
    7 local iterations) on the port's state_dict through the converter,
    reads every key the port has and no other (a missing key raises
    KeyError, a wrong channel count fails in JAX's convolution);
  * numbers: the four levels' flows and [log_var, weight] at 256x256 with
    the iterations cut to 1 global and 2 local (one JAX compile per module),
    within 1e-4 of each output's largest value (float32 convolutions and
    matmuls summed in another order, through ~40 layers; see PERF.md);
  * the converter both ways: a reference-style `.pth.tar` into the port, the
    port's npz into the JAX package, the JAX package's npz into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.init.pdcnet import convert as jconvert
from binocular3dgs_tpu.init.pdcnet.model import pdcnet_forward
from binocular3dgs_torch.init.pdcnet import convert
from binocular3dgs_torch.init.pdcnet.model import PDCNetModel, random_model

FORWARD_RTOL = 1e-4
ITERS = dict(global_iters=1, local_iters=2)


class RecordingParams(dict):
    """A params dict that records each key the JAX forward reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in self:
            self.read.add(key)
        return super().get(key, default)


def images(h=256, w=256, seed=0):
    """ImageNet-normalized-like (1, h, w, 3) target, source and their
    256x256 copies."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1,) + s + (3,)).astype(np.float32)
            for s in ((h, w), (h, w), (256, 256), (256, 256))]


@pytest.fixture(scope="module")
def model():
    return random_model(0)


@pytest.fixture(scope="module")
def outputs(model):
    ims = images()
    params = {k: jnp.asarray(v) for k, v in convert.jax_params_from_state_dict(
        model.state_dict()).items()}
    fwd = jax.jit(pdcnet_forward, static_argnames=("global_iters", "local_iters"))
    want = fwd(*[jnp.asarray(x) for x in ims], params, **ITERS)
    with torch.inference_mode():
        got = model(*[torch.from_numpy(x).permute(0, 3, 1, 2) for x in ims], **ITERS)
    return got, want


def test_state_dict_is_what_jax_reads(model):
    params = RecordingParams(convert.jax_params_from_state_dict(model.state_dict()))
    ims = [jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in images()]
    out_256, out = jax.eval_shape(lambda *xs: pdcnet_forward(*xs, params), *ims)
    assert params.read == set(params), (sorted(set(params) - params.read)[:5],)
    # every JAX param has the port's shape through the converter
    back = convert.state_dict_from_jax_params(params)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(own)
    assert all(back[k].shape == own[k].shape for k in own)
    assert [f.shape for f in out_256["flow_estimates"] + out["flow_estimates"]] == [
        (1, 16, 16, 2), (1, 32, 32, 2), (1, 32, 32, 2), (1, 64, 64, 2)]
    # the deconvolutions keep torch's IOHW in the port
    assert tuple(model.upfeat2.weight.shape) == (32, 2, 4, 4)
    assert params["upfeat2.weight"].shape == (4, 4, 32, 2)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("which", ["output_256", "output"])
def test_forward_levels(outputs, which, level):
    """level 4 and 3 (output_256), level 2 and 1 (output)."""
    got, want = outputs
    g, w = got[which == "output"], want[which == "output"]
    pairs = [(g["flow_estimates"][level], w["flow_estimates"][level])]
    pairs += list(zip(g["uncertainty_estimates"][level], w["uncertainty_estimates"][level]))
    for t, a in pairs:
        t = t.permute(0, 2, 3, 1).numpy()
        a = np.asarray(a)
        assert t.shape == a.shape and np.isfinite(t).all()
        assert t.std() > 0  # random weights still give a flow and maps that vary
        np.testing.assert_allclose(t, a, rtol=0, atol=FORWARD_RTOL * float(np.abs(a).max()))


def test_pth_into_port(tmp_path, model):
    """A reference-style checkpoint: a dict with `state_dict`, DataParallel's
    `module.` prefixes, num_batches_tracked, and the image pyramid's
    unread level 4, which the load leaves out."""
    sd = model.state_dict()
    extra = {f"pyramid.level_4.{j}.{k}": torch.zeros(3) for j in (0, 2, 4)
             for k in ("weight", "bias")}
    path = str(tmp_path / "PDCNet_plus_megadepth.pth.tar")
    torch.save({"epoch": 3, "state_dict": {"module." + k: v for k, v in {**sd, **extra}.items()}},
               path)
    loaded = convert.load_checkpoint(path)
    fresh = convert.load_into(PDCNetModel(), loaded)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="lack"):
        convert.load_into(PDCNetModel(), {k: v for k, v in sd.items() if "decoder2" not in k})


def test_npz_both_ways(tmp_path, model):
    sd = model.state_dict()
    # the port's npz -> the JAX package
    npz = str(tmp_path / "port.npz")
    convert.save_npz(sd, npz)
    got = jconvert.load_checkpoint(npz)
    want = jconvert.convert_state_dict(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX package's npz -> the port
    jnpz = str(tmp_path / "jax.npz")
    jconvert.save_npz(want, jnpz)
    fresh = convert.load_into(PDCNetModel(), convert.load_checkpoint(jnpz))
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    # and the CLI, as JAX's `convert.main`
    out = str(tmp_path / "cli.npz")
    pth = str(tmp_path / "w.pth")
    torch.save(sd, pth)
    convert.main([pth, out])
    with np.load(out) as z, np.load(npz) as y:
        assert set(z.files) == set(y.files)
        assert all(np.array_equal(z[k], y[k]) for k in z.files)
