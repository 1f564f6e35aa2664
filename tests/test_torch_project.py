"""Port vertex stage (binocular3dgs_torch.ops.project) against the JAX
project_gaussians, field by field, on the random_scene shapes of
test_rasterize_tiled; the backward kernel's formulas (project_backward_torch)
against autograd of project_gaussians; the CPU branch of
project_for_render against project_gaussians. Also holds the helpers that carry a JAX model and
camera into the port, used by the other test_torch_* files."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binocular3dgs_tpu.core.camera import make_camera as jax_make_camera
from binocular3dgs_tpu.ops.rasterize import project_for_render as jax_project_for_render
from binocular3dgs_torch import tracing
from binocular3dgs_torch.core.camera import make_camera
from binocular3dgs_torch.core.sh import C0, num_sh_coeffs
from binocular3dgs_torch.models.gaussians import PARAM_NAMES, GaussianParams, from_numpy
from binocular3dgs_torch.ops.project import (
    _geometry_rows, project_backward_torch, project_gaussians,
)
from binocular3dgs_torch.ops.rasterize import project_for_render

from test_rasterize_tiled import random_scene

W, H = 64, 48
FOVX, FOVY = 0.9, 0.7


def to_port(m, device="cpu"):
    """The JAX GaussianModel `m` as the port's model (same buffers)."""
    params = {n: np.asarray(getattr(m.params, n)) for n in PARAM_NAMES}
    return from_numpy(
        params, np.asarray(m.active), m.max_sh_degree, m.active_sh_degree,
        m.spatial_lr_scale, device=device,
    )


def camera_pair(R=None, T=None, fovx=FOVX, fovy=FOVY, w=W, h=H):
    """The same camera built by both packages."""
    R = np.eye(3) if R is None else R
    T = np.zeros(3) if T is None else T
    return (
        jax_make_camera(R, T, fovx, fovy, w, h),
        make_camera(R, T, fovx, fovy, w, h, device="cpu"),
    )


def sh1_scene(seed, n=32):
    m = random_scene(seed=seed, n=n)
    rest = np.random.default_rng(seed + 100).normal(size=(n, 3, 3)) * 0.1
    return m.replace(active_sh_degree=1, params=m.params.replace(f_rest=jnp.asarray(rest)))


def behind_scene():
    """Some gaussians behind the camera or inside the z <= 0.2 cull."""
    m = random_scene(seed=9, n=40)
    xyz = np.asarray(m.params.xyz).copy()
    xyz[:8] = 0.0
    xyz[:8, 2] = np.linspace(-2.0, 0.0, 8)
    return m.replace(params=m.params.replace(xyz=jnp.asarray(xyz)))


SCENES = {
    "seed0": lambda: random_scene(seed=0),
    "seed1": lambda: random_scene(seed=1),
    "sh1": lambda: sh1_scene(3),
    "inactive": lambda: random_scene(seed=5, n=16, cap=32),
    "culled": behind_scene,
}

# float32 elementwise algebra in the same order in both packages; the
# tolerances cover the last bits of XLA's fused CPU code against PyTorch's
# (4-term camera matmuls, exp/log/sqrt implementations)
TOL = {
    "mean2d": dict(rtol=1e-5, atol=1e-4),  # pixels
    "depth": dict(rtol=1e-6, atol=1e-6),
    "conic": dict(rtol=1e-4, atol=1e-6),
    "color": dict(rtol=1e-6, atol=1e-6),
    "opacity": dict(rtol=1e-6, atol=1e-7),
    "radius": dict(rtol=0, atol=0),
    "bin_extent": dict(rtol=1e-5, atol=1e-4),  # pixels
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_project_matches_jax(scene):
    m = SCENES[scene]()
    R = np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]])
    jcam, pcam = camera_pair(R=R, T=np.array([0.05, -0.02, 0.1]))
    pj = jax_project_for_render(jcam, m)
    pt = project_for_render(pcam, to_port(m))
    np.testing.assert_array_equal(pt.visible.numpy(), np.asarray(pj.visible))
    for name, tol in TOL.items():
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), err_msg=name, **tol
        )
    assert pt.visible.any()
    if scene == "culled":
        assert not pt.visible[:8].any()


def test_from_numpy_keeps_buffers():
    m = random_scene(seed=5, n=16, cap=32)
    pm = to_port(m)
    assert pm.capacity == 32 and int(pm.count()) == 16
    for n in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(pm.params, n).numpy(), np.asarray(getattr(m.params, n)))
    np.testing.assert_allclose(
        pm.get_opacity().numpy(), np.asarray(m.get_opacity()), rtol=1e-6
    )
    assert pm.params.xyz.dtype == torch.float32 and pm.active.dtype == torch.bool


# -- the backward kernel's formulas (project_backward_torch) against autograd

def bounds_model():
    """Rows at the bounds of the vertex stage's clamps and masks, for the
    identity camera (t = xyz exactly, centre 0): the linearisation point at
    +1.3 tan(fovx) and -1.3 tan(fovy) exactly (clamp passes there) and
    beyond both, a colour whose pre-clamp value is exactly 0 (passes), a
    direction whose norm is exactly the 1e-8 clamp (passes), a depth of
    exactly znear_cull (culled), rows behind the camera, inactive rows, and
    ordinary rows. Returns (params, active) as numpy arrays; rows whose
    bound needs the float type are filled by `fit_bounds`."""
    rng = np.random.default_rng(21)
    n = 24
    q = rng.normal(size=(n, 4))
    params = dict(
        xyz=np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(2.0, 6.0, n)], 1),
        f_dc=rng.normal(size=(n, 1, 3)) * 0.8,
        f_rest=rng.normal(size=(n, 3, 3)) * 0.3,
        opacity=rng.uniform(-2.0, 3.0, (n, 1)),
        scaling=np.log(rng.uniform(0.05, 0.5, (n, 3))),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
    )
    params["xyz"][6] = [0.3, -0.2, -1.5]  # behind the camera
    params["xyz"][7] = [0.0, 0.0, 0.1]  # inside the cull
    params["f_rest"][3] = 0.0  # row 3's colour: exactly C0 * f_dc
    active = np.ones(n, bool)
    active[[8, 9]] = False
    return params, active


def fit_bounds(model, camera):
    """Row 0 at tx/tz = +limx, row 1 at ty/tz = -limy (z = 1), row 2 beyond
    both bounds, row 3's pre-clamp colour exactly -0.5 + 0.5 = 0, in the
    model's float type; row 4 at (1e-8, 0, 0) (the direction's norm exactly
    at its clamp, and culled: z = 0), row 5 at depth exactly znear_cull."""
    p = model.params
    limx, limy = 1.3 * camera.tanfovx, 1.3 * camera.tanfovy
    p.xyz[0] = torch.stack([limx, 0.1 * limy, torch.ones_like(limx)])
    p.xyz[1] = torch.stack([0.1 * limx, -limy, torch.ones_like(limx)])
    p.xyz[2] = torch.stack([2.0 * limx, 3.0 * limy, torch.ones_like(limx)]) * 2.0
    f0 = torch.tensor(-0.5 / C0, dtype=p.xyz.dtype)
    for _ in range(64):  # the f0 with C0 * f0 == -0.5 in this float type
        prod = C0 * f0
        if prod == -0.5:
            break
        f0 = torch.nextafter(f0, f0 + (1.0 if prod < -0.5 else -1.0))
    assert C0 * f0 == -0.5
    p.f_dc[3] = f0
    p.xyz[4] = torch.tensor([1e-8, 0.0, 0.0], dtype=p.xyz.dtype)
    p.xyz[5, 2] = 0.2


BACKWARD_SCENES = {
    "seed0": lambda: (random_scene(seed=0), 0),
    "sh1": lambda: (sh1_scene(3), 1),
    "inactive": lambda: (random_scene(seed=5, n=16, cap=32), 0),
    "culled": lambda: (behind_scene(), 0),
}


def port_scene(name, dtype):
    """(model, camera, SH degree) of a backward case on the CPU in `dtype`."""
    if name in BACKWARD_SCENES:
        m, deg = BACKWARD_SCENES[name]()
        model = to_port(m)
        R = np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]])
        cam = camera_pair(R=R, T=np.array([0.05, -0.02, 0.1]))[1]
    else:  # "bounds" at SH degree 1, "sh0" and "sh3" on the same rows
        params, active = bounds_model()
        deg = {"bounds": 1, "sh0": 0, "sh3": 3}[name]
        if deg == 3:
            params["f_rest"] = np.random.default_rng(22).normal(size=(24, 15, 3)) * 0.3
            params["f_rest"][3] = 0.0
        model = from_numpy(params, active, max(deg, 1), deg, device="cpu")
        cam = camera_pair()[1]
    model = dataclasses.replace(model, params=GaussianParams(
        **{n: getattr(model.params, n).to(dtype) for n in PARAM_NAMES}))
    cam = dataclasses.replace(cam, **{k: getattr(cam, k).to(dtype) for k in (
        "world_view", "proj", "full_proj", "cam_center", "tanfovx", "tanfovy")})
    if name not in BACKWARD_SCENES:
        fit_bounds(model, cam)
    return model, cam, deg


def autograd_of_project(model, cam, deg, carrier, cots):
    """torch.autograd.grad of project_gaussians (the CPU path of
    project_for_render) with respect to the raw leaves and the carrier."""
    leaves = [getattr(model.params, n).clone().requires_grad_(True) for n in PARAM_NAMES]
    xyz, f_dc, f_rest, opacity, scaling, rotation = leaves
    inputs = leaves + ([carrier.clone().requires_grad_(True)] if carrier is not None else [])
    proj = project_gaussians(
        xyz=xyz, scaling=torch.exp(scaling), rotation_raw=rotation,
        opacity=torch.sigmoid(opacity)[..., 0], features=torch.cat([f_dc, f_rest], 1),
        active=model.active, camera=cam, sh_degree=deg,
        mean2d_carrier=inputs[6] if carrier is not None else None)
    outs = [proj.mean2d, proj.depth, proj.conic, proj.color, proj.opacity]
    return torch.autograd.grad(outs, inputs, grad_outputs=cots), proj


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("with_carrier", [True, False], ids=["carrier", "no_carrier"])
@pytest.mark.parametrize("scene", sorted(BACKWARD_SCENES) + ["bounds", "sh0", "sh3"])
def test_backward_torch_matches_autograd(scene, with_carrier, dtype):
    model, cam, deg = port_scene(scene, dtype)
    n = model.capacity
    g = torch.Generator().manual_seed(len(scene) * 7 + with_carrier)
    carrier = torch.randn(n, 2, generator=g, dtype=dtype) * 1e-3 if with_carrier else None
    cots = [torch.randn(shape, generator=g, dtype=dtype)
            for shape in ((n, 2), (n,), (n, 3), (n, 3), (n,))]
    want, proj = autograd_of_project(model, cam, deg, carrier, cots)
    got = project_backward_torch(*(getattr(model.params, k) for k in PARAM_NAMES), model.active,
                                 cam, deg, 0.3, 0.2, *cots, with_carrier)
    assert (got[6] is None) == (not with_carrier)
    # float64: the derivation, to rounding; float32: the same formulas in
    # another order of operations than autograd's. Row by row against the
    # row's largest gradient of the leaf (rows differ by orders of magnitude:
    # the direction's gradient at norm 1e-8 is ~1e8); float32 rows read up to
    # 1.9e-5 (the rotation's projection off q cancels), float64 2.5e-14
    tol = 1e-12 if dtype == torch.float64 else 2e-4
    for name, w, a in zip(PARAM_NAMES + ("carrier",), want, got):
        assert a.dtype == dtype and a.shape == w.shape, name
        w, a = w.reshape(n, -1), a.reshape(n, -1)
        row = w.abs().amax(1, keepdim=True)
        assert torch.all((a - w).abs() <= tol * row), (name, ((a - w).abs() / row).max())
    invisible = ~proj.visible
    for k in (3, 4, 5):  # opacity, scaling, rotation: nothing reaches an invisible row
        assert torch.all(got[k][invisible] == 0)
    if with_carrier:
        assert torch.all(got[6][invisible] == 0)
    if scene in ("bounds", "sh0", "sh3"):
        assert proj.visible[:4].all() and not proj.visible[4:10].any()
        # each row sits on its bound as built, and the bound passes a gradient
        geo = _geometry_rows(model.params.xyz, model.params.scaling, model.params.rotation, cam,
                             0.3, 0.2)
        assert geo["ux"][0] == geo["limx"] and geo["uy"][1] == -geo["limy"]
        assert geo["ux"][2] > geo["limx"] and geo["uy"][2] > geo["limy"]
        assert geo["pv"][2][5] == 0.2
        assert torch.linalg.vector_norm(model.params.xyz[4]) == torch.tensor(1e-8, dtype=dtype)
        assert proj.color[3].eq(0).all() and want[1][3].ne(0).all()
    if deg < 3:  # unused SH coefficients get zeros
        assert torch.all(got[2][:, num_sh_coeffs(deg) - 1:] == 0)


def test_project_for_render_on_the_cpu_is_project_gaussians():
    """The CPU branch of project_for_render is project_gaussians of the
    activated parameters, bit for bit, forward and backward, and launches
    no kernel."""
    m = sh1_scene(4)
    _, pcam = camera_pair()
    before = tracing.launches()
    outs, grads = [], []
    for via_render in (True, False):
        model = to_port(m)
        leaves = [getattr(model.params, n).requires_grad_(True) for n in PARAM_NAMES]
        carrier = torch.zeros(model.capacity, 2, requires_grad=True)
        if via_render:
            proj = project_for_render(pcam, model, mean2d_carrier=carrier)
        else:
            proj = project_gaussians(
                xyz=leaves[0], scaling=model.get_scaling(), rotation_raw=leaves[5],
                opacity=model.get_opacity()[..., 0], features=model.get_features(),
                active=model.active, camera=pcam, sh_degree=1, mean2d_carrier=carrier)
        loss = sum((f.float() * (k + 1)).sum() for k, f in enumerate(proj) if f.is_floating_point())
        grads.append(torch.autograd.grad(loss, leaves + [carrier], allow_unused=True))
        outs.append(proj)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert tracing.launches() == before
