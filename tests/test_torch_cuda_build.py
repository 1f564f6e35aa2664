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
