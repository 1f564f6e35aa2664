"""Scenes of the training cells, made on the device from `--seed`.

A configuration file's `scene` group names a camera layout and a cloud
recipe with their parameters; `make_scene` builds from them and the seed:

  * the cameras (`arc`: views on an arc around the y axis facing +z, as
    LLFF's forward-facing captures; `sphere`: views on a sphere looking at
    the origin, as Blender's object captures),
  * the "true" cloud (`slab`: a box of opaque splats in front of the
    cameras; `shell`: an opaque object, a bumpy closed surface of splats),
  * the ground-truth images, rendered from the true cloud by the
    reference's plain renderer (and the alpha masks where the protocol
    has them),
  * the trained model: a seeded perturbation of the true cloud (positions,
    colours, opacities, scales, rotations and the higher SH band), so that
    it is near a fit, padded to its capacity with the program's sentinels,
    with a warm Adam second moment (`warm_moment`).

Every draw comes from a `torch.Generator` on the device in a few large
calls; the same seed gives the same scene on the same device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import reference as ref


def sub_seed(seed: int, k: int) -> int:
    """The k-th 63-bit seed derived from `seed` (any non-negative int)."""
    state = np.random.SeedSequence([int(seed), k]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def look_at(center: np.ndarray, target: np.ndarray, down: np.ndarray):
    """(R camera-to-world, T world-to-camera) of a camera at `center`
    looking at `target`: x right, y down, z forward."""
    f = target - center
    f = f / np.linalg.norm(f)
    x = np.cross(down, f)
    x = x / np.linalg.norm(x)
    y = np.cross(f, x)
    Rw2c = np.stack([x, y, f])
    return Rw2c.T, -Rw2c @ center


def camera_poses(c: dict) -> list:
    """The training views' (R, T) of a layout."""
    if c["layout"] == "arc":
        # `of` views on linspace(-span, span), the training ones picked by
        # index; radius r around (0, 0, r), so each looks along +z
        angles = np.linspace(-c["span"], c["span"], c["of"])[c["pick"]]
        r = c["radius"]
        poses = []
        for a in angles:
            Rw2c = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                             [-math.sin(a), 0.0, math.cos(a)]])
            center = np.array([r * math.sin(a), 0.0, r * (1.0 - math.cos(a))])
            poses.append((Rw2c.T, -Rw2c @ center))
        return poses
    if c["layout"] == "sphere":
        # views at (azimuth, elevation) in degrees on a sphere of `radius`
        # around the origin, z up
        poses = []
        for az, el in c["views"]:
            az, el = math.radians(az), math.radians(el)
            center = c["radius"] * np.array([math.cos(el) * math.cos(az),
                                             math.cos(el) * math.sin(az), math.sin(el)])
            poses.append(look_at(center, np.zeros(3), np.array([0.0, 0.0, -1.0])))
        return poses
    raise ValueError(f"unknown camera layout {c['layout']!r}")


def cameras_extent(poses) -> float:
    """The scene radius of the training cameras: 1.1 x the largest distance
    of a camera centre from their mean (reference `getNerfppNorm`)."""
    centers = np.stack([-np.asarray(R) @ np.asarray(T) for R, T in poses])
    return float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1)) * 1.1)


def _uniform(gen, n, lo, hi, device):
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return lo + (hi - lo) * torch.rand(n, *lo.shape, generator=gen, device=device)


def true_cloud(c: dict, n: int, sh_degree: int, gen, device) -> dict:
    """The true cloud's raw parameters (n rows), by the recipe `c["kind"]`."""
    if c["kind"] == "slab":
        xyz = _uniform(gen, n, c["lo"], c["hi"], device)
    elif c["kind"] == "shell":
        # a closed surface r(d) = radius (1 + sum_k amp_k max(0, d.u_k)^2)
        # around the origin: `bumps` random lobes on a sphere
        d = torch.randn(n, 3, generator=gen, device=device)
        d = d / d.norm(dim=1, keepdim=True)
        u = torch.randn(len(c["bumps"]), 3, generator=gen, device=device)
        u = u / u.norm(dim=1, keepdim=True)
        amp = torch.as_tensor(c["bumps"], dtype=torch.float32, device=device)
        r = c["radius"] * (1.0 + (amp * torch.clamp(d @ u.T, min=0.0) ** 2).sum(1))
        xyz = d * r[:, None]
    else:
        raise ValueError(f"unknown cloud recipe {c['kind']!r}")
    log_lo, log_hi = math.log(c["scale"][0]), math.log(c["scale"][1])
    K = (sh_degree + 1) ** 2
    return dict(
        xyz=xyz,
        f_dc=torch.randn(n, 1, 3, generator=gen, device=device) * c["color_sigma"],
        f_rest=torch.zeros(n, K - 1, 3, device=device),
        opacity=torch.full((n, 1), float(c["opacity_logit"]), device=device),
        scaling=_uniform(gen, n, [log_lo] * 3, [log_hi] * 3, device),
        rotation=torch.cat([torch.ones(n, 1, device=device), torch.zeros(n, 3, device=device)],
                           1),
    )


def perturb(true: dict, p: dict, gen, device) -> dict:
    """The trained model: the true cloud moved by a seeded fraction of each
    splat's size, with its colours, opacities, scales and rotations
    jittered and a small higher SH band."""
    n = true["xyz"].shape[0]

    def noise(*shape):
        return torch.randn(n, *shape, generator=gen, device=device)

    size = torch.exp(true["scaling"]).amax(1, keepdim=True)
    rot = true["rotation"] + torch.cat([torch.zeros(n, 1, device=device),
                                        p["rotation"] * noise(3)], 1)
    return dict(
        xyz=true["xyz"] + p["xyz_of_size"] * size * noise(3),
        f_dc=true["f_dc"] + p["f_dc"] * noise(1, 3),
        f_rest=p["f_rest"] * noise(*true["f_rest"].shape[1:]),
        opacity=true["opacity"] + p["opacity_logit"] * noise(1),
        scaling=true["scaling"] + p["log_scale"] * noise(3),
        rotation=rot,
    )


def pad(rows: dict, capacity: int) -> tuple[dict, torch.Tensor]:
    """`rows` in `capacity` rows: the first P active, the rest carrying the
    program's sentinels (zeros, log-scale -20, identity rotation)."""
    P = rows["xyz"].shape[0]
    out = {}
    for n in ref.PARAM_NAMES:
        x = rows[n]
        full = x.new_full((capacity,) + x.shape[1:], ref.FILL.get(n, 0.0))
        full[:P] = x
        if n == "rotation":
            full[P:, 0] = 1.0
        out[n] = full.contiguous()
    active = torch.arange(capacity, device=rows["xyz"].device) < P
    return out, active


@dataclass
class SceneData:
    cams: list  # reference.Cam per training view
    gt: list  # (3, H, W) float32 per view
    alpha: list | None  # (H, W) per view, where the protocol has masks
    model: dict  # padded raw parameters of the trained model
    active: torch.Tensor
    v0: dict  # Adam's second moment of the trained model, per leaf
    extent: float
    bg: list
    sh_degree: int


@torch.no_grad()
def make_scene(config: dict, seed: int, device) -> SceneData:
    s = config["scene"]
    sh = config["model"]["sh_degree"]
    cams_cfg, img = s["cameras"], s["images"]
    poses = camera_poses(cams_cfg)
    cams = [ref.make_cam(R, T, cams_cfg["fovx"], cams_cfg["fovy"], img["width"], img["height"],
                         device) for R, T in poses]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    n = config["model"]["gaussians"]
    true = true_cloud(s["cloud"], n, sh, gen, device)
    bg = [1.0] * 3 if config["trainer"]["model"]["white_background"] else [0.0] * 3
    raster = config["trainer"]["raster"]
    gt, alpha = [], []
    t_params, t_active = pad(true, n)
    for cam in cams:
        out = ref.render(cam, t_params, t_active, sh, bg, raster)
        gt.append(torch.clamp(out["image"], 0.0, 1.0).contiguous())
        alpha.append(out["alpha"].contiguous())
    del t_params
    gen.manual_seed(sub_seed(seed, 1))
    model_rows = perturb(true, s["perturb"], gen, device)
    capacity = next_pow2(int(n * config["trainer"]["capacity"]["initial_margin"]))
    model, active = pad(model_rows, capacity)
    return SceneData(cams, gt, alpha if s.get("alpha_masks") else None, model, active,
                     warm_moment(model, active, s["adam_v_rms"]), cameras_extent(poses), bg, sh)


def warm_moment(model: dict, active, rms: dict) -> dict:
    """Adam's second moment of a model trained for thousands of
    iterations: each active value's running mean square gradient, taken as
    its leaf's typical square (`rms` per leaf); zero on inactive rows, as
    the program keeps them. With a second moment of zero, a first step
    moves every value whose gradient is not exactly zero by the full
    learning rate, rounding's sign included."""
    out = {}
    for n, t in model.items():
        mask = active.reshape((-1,) + (1,) * (t.ndim - 1))
        out[n] = torch.where(mask, torch.full_like(t, float(rms[n]) ** 2), 0.0)
    return out
