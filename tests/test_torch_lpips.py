"""The port's LPIPS against the JAX package's `make_lpips` on the same
random weights (npz layout) and images, for all three backbones, and
`cli metrics --lpips_weights` against the JAX `evaluate_dir`."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from binocular3dgs_tpu.eval.lpips import make_lpips as jax_make_lpips
from binocular3dgs_tpu.eval.lpips import save_lpips_weights
from binocular3dgs_tpu.eval.metrics import evaluate_dir as jax_evaluate_dir
from binocular3dgs_torch import cli
from binocular3dgs_torch.eval.lpips import load_lpips_weights, make_lpips, random_lpips_weights

from test_torch_checkpoint import one_thread  # noqa: F401  (autouse)

RTOL = 1e-5  # float32 convolutions summed in another order


def images(seed, h, w, batch=None):
    """Two related images in [0, 1]: a smooth field and a noisy copy."""
    rng = np.random.default_rng(seed)
    shape = (batch, h, w, 3) if batch else (h, w, 3)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = 0.5 + 0.4 * np.sin(6 * xx + rng.uniform(0, 6, 3)[:, None, None]
                              ) * np.cos(4 * yy)[None]
    a = np.broadcast_to(base.transpose(1, 2, 0), shape).copy()
    b = np.clip(a + rng.normal(size=shape) * 0.1, 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
@pytest.mark.parametrize("hw", [(64, 48), (61, 47)])
def test_lpips_matches_jax(net, hw):
    weights = random_lpips_weights(net, seed=3)
    a, b = images(1, *hw)
    want = float(jax_make_lpips(weights, net)(jnp.asarray(a), jnp.asarray(b)))
    fn = make_lpips(weights, device="cpu")  # net_type from the weights' tag
    assert fn.net_type == net
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0 and want > 1e-3
    assert abs(float(got) - want) <= RTOL * want, (float(got), want)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_lpips_batch_matches_jax_per_image():
    weights = random_lpips_weights("squeeze", seed=4)
    a, b = images(2, 40, 56, batch=3)
    got = make_lpips(weights, "squeeze", device="cpu")(torch.from_numpy(a), torch.from_numpy(b))
    jfn = jax_make_lpips(weights, "squeeze")
    want = [float(jfn(jnp.asarray(a[i]), jnp.asarray(b[i]))) for i in range(3)]
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_lpips_rejects_an_unknown_backbone():
    with pytest.raises(ValueError, match="unknown LPIPS backbone"):
        make_lpips(random_lpips_weights("vgg"), "resnet", device="cpu")


def test_cli_metrics_reports_lpips(tmp_path, capsys):
    """metrics --lpips_weights on renders and gt PNGs, against the JAX
    evaluate_dir with the JAX LPIPS on the same files."""
    weights_path = str(tmp_path / "vgg.npz")
    save_lpips_weights(weights_path, random_lpips_weights("vgg", seed=5))
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    rng = np.random.default_rng(6)
    for i in range(3):
        a, b = images(10 + i, 48, 64)
        b = np.clip(b + rng.normal(size=b.shape) * 0.05, 0, 1)
        for d in dirs.values():
            for sub, img in (("renders", b), ("gt", a)):
                os.makedirs(d / "test" / "ours_5" / sub, exist_ok=True)
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    d / "test" / "ours_5" / sub / f"{i:05d}.png")
    jax_evaluate_dir(str(dirs["jax"]),
                     lpips_fn=jax_make_lpips(load_lpips_weights(weights_path), "vgg"))
    assert cli.main(["metrics", "-m", str(dirs["port"]), "--device", "cpu",
                     "--lpips_weights", weights_path]) == 0
    assert "LPIPS weights not provided" not in capsys.readouterr().out
    res = {}
    for k, d in dirs.items():
        with open(d / "per_view.json") as f:
            res[k] = json.load(f)["ours_5"]
    assert sorted(res["port"]["LPIPS"]) == ["00000.png", "00001.png", "00002.png"]
    for name, want in res["jax"]["LPIPS"].items():
        assert abs(res["port"]["LPIPS"][name] - want) <= RTOL * want, name
    with open(dirs["port"] / "results.json") as f:
        mean = json.load(f)["ours_5"]["LPIPS"]
    assert abs(mean - np.mean(list(res["jax"]["LPIPS"].values()))) <= RTOL * mean
