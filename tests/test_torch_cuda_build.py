"""The seam between the ops' wrappers and csrc/ (ops/cuda_build.py) on the
CPU: the C signatures read from the `extern "C"` prototypes, and `launch`'s
protocol (argument count, stream, error, launch counts) on a fake
library."""

import collections
import ctypes
import types

import pytest
import torch

from binocular3dgs_torch import tracing
from binocular3dgs_torch.ops import cuda_build

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The argument types the wrappers were written against, stream last: the
# table the library was loaded with before the prototypes were parsed.
ARGTYPES = {
    "b3dgs_blend_plan": [P, I, LL, I, P, P, P, P],
    "b3dgs_blend_forward": [P, LL, P, P, I, I, I, P, P, P, P, P],
    "b3dgs_blend_backward": [P, LL, P, P, P, P, P, I, I, I, P, P, P, P],
    "b3dgs_warp_forward": [P, P, I, I, I, P, P, P],
    "b3dgs_warp_backward": [P, P, I, I, I, P, P],
    "b3dgs_project_forward": [P] * 13 + [LL, I, I, I, I, F, F] + [P] * 9,
    "b3dgs_project_backward": [P] * 12 + [LL, I, I, I, I, F, F] + [P] * 13,
    "b3dgs_ssim_forward": [P, P, I, I, I, P, I, P, LL, P, P, P, P, P],
    "b3dgs_ssim_backward": [P] * 6 + [I, I, I, P, I, P, P],
    "b3dgs_bin_keys": [P, I, P, LL, P, P],
    "b3dgs_bin_count": [P, P, P, I, LL, I, I, I, P, P, P, P, P],
    "b3dgs_bin_sort": [P, P, LL, LL, I, I, I] + [P] * 16,
    "b3dgs_gather_forward": [P] * 8 + [LL, P, P],
    "b3dgs_gather_backward": [P, LL, P, P, P, P, LL] + [P] * 7,
    # per group p, g, m, v, width, rate (xyz's with its device pointer);
    # then the mask, the rows and the two factors with their device pointers
    "b3dgs_adam_update": [P, P, P, P, I, F, P] + [P, P, P, P, I, F] * 5 + [P, I, F, P, F, P, P],
}


@pytest.mark.parametrize("symbol", sorted(ARGTYPES))
def test_prototype_gives_the_wrappers_argtypes(symbol):
    assert cuda_build.signatures()[symbol] == ARGTYPES[symbol]


def test_every_entry_point_is_parsed():
    assert sorted(cuda_build.signatures()) == sorted(ARGTYPES)


@pytest.mark.parametrize("prototype, why", [
    ('extern "C" int b3dgs_x(double scale, void* stream) {', "double scale"),
    ('extern "C" int b3dgs_x(const float* a, int n) {', "void\\* stream"),
    ('extern "C" int b3dgs_x(void* stream);\nextern "C" int b3dgs_x(void* stream) {',
     "declared twice"),
])
def test_a_prototype_ctypes_cannot_pass_is_an_error(tmp_path, prototype, why):
    (tmp_path / "k.cu").write_text(prototype + "\n  return 0;\n}\n")
    with pytest.raises(ValueError, match=why):
        cuda_build.signatures(tmp_path)


class FakeEntry:
    """An entry point of a fake library: records its calls, returns `err`."""

    def __init__(self, argtypes, err):
        self.argtypes, self.err, self.calls = argtypes, err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_library(monkeypatch):
    """A library of every entry point, each returning cudaSuccess until a
    test sets its `err`; the CPU build's stream query stubbed to stream 0."""
    lib = types.SimpleNamespace(**{s: FakeEntry(a, 0) for s, a in ARGTYPES.items()})
    monkeypatch.setattr(cuda_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tracing, "_launches", tracing.launches())
    return lib


def test_launch_passes_pointers_and_the_stream_and_counts(fake_library):
    before = tracing.launches()
    d, x = torch.zeros(2, 3), torch.zeros(3, 2, 3)
    out, diff = torch.empty_like(x), torch.empty_like(x)
    # device -1: torch.cuda.device changes no device (a CPU build has none)
    cuda_build.launch("b3dgs_warp_forward", -1, x, d, 3, 2, 3, out, diff)
    assert fake_library.b3dgs_warp_forward.calls == [
        (x.data_ptr(), d.data_ptr(), 3, 2, 3, out.data_ptr(), diff.data_ptr(), 0)]
    cuda_build.launch("b3dgs_gather_backward", -1, *[None] * 13,
                      launches={"gather_transpose": 1, "gather_backward": 1})
    assert tracing.launches() - before == collections.Counter(
        warp_forward=1, gather_transpose=1, gather_backward=1)


@pytest.mark.parametrize("extra", [-1, 1])
def test_a_wrong_argument_count_raises_before_any_call(fake_library, extra):
    before = tracing.launches()
    args = [None] * (len(ARGTYPES["b3dgs_bin_keys"]) - 1 + extra)
    with pytest.raises(TypeError, match="b3dgs_bin_keys takes 5 arguments"):
        cuda_build.launch("b3dgs_bin_keys", -1, *args)
    assert fake_library.b3dgs_bin_keys.calls == [] and tracing.launches() == before


def test_a_failed_launch_raises_and_counts_nothing(fake_library):
    fake_library.b3dgs_ssim_backward.err = 700
    before = tracing.launches()
    with pytest.raises(RuntimeError, match="b3dgs_ssim_backward .*cudaError 700"):
        cuda_build.launch("b3dgs_ssim_backward", -1, *[None] * 12)
    assert len(fake_library.b3dgs_ssim_backward.calls) == 1
    assert tracing.launches() == before


# -- the Adam kernel's arguments (train/state.py:adam_kernel_args) ---------------


def adam_trees(rows=10, deg_rest=3):
    """Parameters, gradients and both moments of `rows` rows (f_rest with
    `deg_rest` coefficients), and the mask."""
    from binocular3dgs_torch.models.gaussians import GaussianParams

    shapes = dict(xyz=(3,), f_dc=(1, 3), f_rest=(deg_rest, 3), opacity=(1,), scaling=(3,),
                  rotation=(4,))
    trees = [GaussianParams(**{k: torch.randn(rows, *s) for k, s in shapes.items()})
             for _ in range(4)]
    return (*trees, torch.arange(rows) % 3 > 0)


def kind(ctype, arg):
    """Whether `arg` is what `launch` passes for `ctype`: a tensor (its
    pointer) or None for c_void_p, a Python int or float for the others."""
    if ctype is P:
        return arg is None or isinstance(arg, torch.Tensor)
    return isinstance(arg, int) if ctype in (I, LL) else isinstance(arg, float)


@pytest.mark.parametrize("on_device", [False, True], ids=["numbers", "tensors"])
@pytest.mark.parametrize("deg_rest", [3, 0, 15])
def test_adam_kernel_args_fit_the_prototype(on_device, deg_rest):
    """Every group's tensors, its width and its rate (a number; xyz's also
    a 0-d tensor passed by its address with 0.0 beside it), then the mask,
    the rows and the factors: one argument for each of the prototype's but
    the stream, of the kind ctypes is told to pass."""
    from binocular3dgs_torch.models.gaussians import PARAM_NAMES
    from binocular3dgs_torch.train.state import adam_kernel_args, group_lrs
    from binocular3dgs_torch.config import Config

    p, g, m, v, active = adam_trees(deg_rest=deg_rest)
    lrs = group_lrs(Config().opt, torch.tensor(1.6e-4) if on_device else 1.6e-4)
    corrections = tuple(torch.tensor(x) for x in (10.0, 2.5)) if on_device else (10.0, 2.5)
    args = adam_kernel_args(p, g, m, v, lrs, active, corrections)
    argtypes = cuda_build.signatures()["b3dgs_adam_update"]
    assert len(args) + 1 == len(argtypes)
    assert all(kind(t, a) for t, a in zip(argtypes, args))
    for i, n in enumerate(PARAM_NAMES):
        group = args[6 * i + (i > 0):6 * i + 7]
        assert all(a is getattr(tree, n) for a, tree in zip(group, (p, g, m, v)))
        assert group[4] == getattr(p, n)[0].numel()
        if n != "xyz":
            assert group[5:] == [float(lrs[n])]
        elif on_device:
            assert group[5:] == [0.0, lrs["xyz"]]
        else:
            assert group[5:] == [float(lrs[n]), None]
    assert args[37:39] == [active, 10]
    if on_device:
        assert args[39:] == [0.0, corrections[0], 0.0, corrections[1]]
    else:
        assert args[39:] == [10.0, None, 2.5, None]


def test_adam_kernel_args_of_a_row_slice():
    """A row slice at an offset (as parallel/sharding.py's sharded Adam
    passes the parameters): contiguous, taken as it is."""
    from binocular3dgs_torch.models.gaussians import GaussianParams, PARAM_NAMES
    from binocular3dgs_torch.train.state import adam_kernel_args

    p, g, m, v, active = adam_trees(rows=12)
    lo, n = 5, 4

    def rows(tree):
        return GaussianParams(**{k: getattr(tree, k)[lo:lo + n] for k in PARAM_NAMES})

    lrs = dict.fromkeys(PARAM_NAMES, 1e-3)
    sliced = rows(p)
    args = adam_kernel_args(sliced, rows(g), rows(m), rows(v), lrs, active[lo:lo + n],
                            (1.0, 1.0))
    assert args[0].data_ptr() == p.xyz.data_ptr() + 4 * 3 * lo
    assert args[37].data_ptr() == active.data_ptr() + lo and args[38] == n


def _bad_adam_input(what):
    """(params, grads, m, v, lrs, active, corrections) with one fault."""
    import dataclasses

    from binocular3dgs_torch.models.gaussians import PARAM_NAMES

    p, g, m, v, active = adam_trees()
    lrs, corrections = dict.fromkeys(PARAM_NAMES, 1e-3), (1.0, 1.0)
    if what == "non-contiguous parameter":
        p = dataclasses.replace(p, xyz=torch.randn(3, 10).t())
    elif what == "float64 gradient":
        g = dataclasses.replace(g, scaling=g.scaling.double())
    elif what == "moment of another shape":
        m = dataclasses.replace(m, rotation=m.rotation[:, :3].contiguous())
    elif what == "mask of other rows":
        active = active[:9]
    elif what == "mask not bool":
        active = active.to(torch.uint8)
    elif what == "rate not 0-d":
        lrs["xyz"] = torch.tensor([1e-3])
    elif what == "constant rate a tensor":
        lrs["f_dc"] = torch.tensor(1e-3)
    elif what == "factor not float32":
        corrections = (torch.tensor(1.0, dtype=torch.float64), 1.0)
    return p, g, m, v, lrs, active, corrections


@pytest.mark.parametrize("what", [
    "non-contiguous parameter", "float64 gradient", "moment of another shape",
    "mask of other rows", "mask not bool", "rate not 0-d", "constant rate a tensor",
    "factor not float32"])
def test_adam_kernel_args_refuse_what_the_kernel_cannot_read(what):
    """The kernel reads contiguous float32 (rows, width) arrays, a bool mask,
    numbers for the rates but xyz's and 0-d float32 tensors for xyz's rate
    and the factors: anything else raises before any launch."""
    from binocular3dgs_torch.train.state import adam_kernel_args

    with pytest.raises(ValueError, match="adam_update"):
        adam_kernel_args(*_bad_adam_input(what))
