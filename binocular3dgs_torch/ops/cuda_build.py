"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for `sm_90a` (one nvcc process per
source, all started together), then linked into one shared library with a
plain C interface, `build/libbinocular_kernels.<key>.so` at the repository
root, which is loaded with ctypes. Nothing links against PyTorch, so a build
takes seconds. `<key>` hashes the sources, the headers, the compile and link
flags and `nvcc --version`: a library built from other sources, under other
flags or by another compiler is never reused (the flags decide the kernels'
rounding, see NVCC_FLAGS). No build happens at import: the first kernel
launch calls `load_library()`.

`launch` is how Python calls a kernel: it passes the device's stream,
checks the returned cudaError and counts the launch. The C signatures it
calls through are read from the `extern "C"` prototypes in csrc/*.cu
(`signatures`), so a kernel's interface is written once, in its source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .. import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_STEM = "libbinocular_kernels"
# --fmad=false: no multiply-add contraction, so a kernel rounds each product
# as the plain PyTorch version (one elementwise op per product) does and the
# two compute bit-identical alphas; a one-ulp alpha at the 1/255 cut would
# otherwise flip a pair in or out of a pixel (~1e-3 in the image).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(b3dgs_\w+)\s*\(([^)]*)\)')
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _build_key(nvcc: str, files: list[Path]) -> str:
    """Hash of everything that decides the library's code."""
    h = hashlib.sha256()
    h.update(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                            check=True).stdout.encode())
    h.update("\0".join(NVCC_FLAGS + ["|"] + LINK_FLAGS).encode())
    for f in files:
        h.update(f"\0{f.name}\0".encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/libbinocular_kernels.<key>.so unless a
    library of the same key is there; returns its path. With `verbose`, the
    compiler's output (ptxas register and shared-memory use) is printed."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    nvcc = _nvcc()
    lib = BUILD_DIR / f"{LIB_STEM}.{_build_key(nvcc, sources + headers)}.so"
    if lib.exists():
        return lib
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"  # private to this build
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / (src.stem + ".o") for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if verbose or proc.returncode:
            print(f"[nvcc {src.name}]\n{out}", flush=True)
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)], check=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(obj_dir)
    return lib


def signatures(csrc: Path = CSRC) -> dict:
    """Each entry point's ctypes argument types, read from its `extern "C"
    int b3dgs_*(...)` prototype in `csrc`/*.cu: a pointer is c_void_p,
    `int`, `long long` and `float` are themselves, any other type is an
    error. The last parameter must be `void* stream`, which `launch`
    passes."""
    out = {}
    for src in sorted(csrc.glob("*.cu")):
        for name, params in _PROTOTYPE.findall(src.read_text()):
            params = [" ".join(p.split()) for p in params.split(",")]
            if name in out or not re.fullmatch(r"void ?\* ?stream", params[-1]):
                raise ValueError(f"{src.name}: {name} is declared twice or does not end "
                                 f"in void* stream")
            argtypes = []
            for p in params:
                *words, _ = p.removeprefix("const ").split()
                ctype = ctypes.c_void_p if "*" in p else _C_TYPES.get(" ".join(words))
                if ctype is None:
                    raise ValueError(f"{src.name}: {name} takes {p!r}, which ctypes is not "
                                     f"told how to pass")
                argtypes.append(ctype)
            out[name] = argtypes
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use, each entry point's C
    signature set from its prototype (`signatures`)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in signatures().items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _lib = lib
        return _lib


def launch(symbol: str, device, *args, launches: dict | None = None) -> None:
    """Call the entry point `symbol` on `device` with `args` (a tensor
    passes its data pointer) and that device's current stream; raise on a
    non-zero cudaError. Its kernels count into `tracing.launched`:
    `launches` ({name: count}) for an entry point that runs several, else
    one launch of `symbol` less its `b3dgs_` prefix."""
    fn = getattr(load_library(), symbol)
    if len(args) + 1 != len(fn.argtypes):  # ctypes passes extra arguments silently
        raise TypeError(f"{symbol} takes {len(fn.argtypes) - 1} arguments and the stream, "
                        f"got {len(args)}")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    for name, n in (launches or {symbol.removeprefix("b3dgs_"): 1}).items():
        for _ in range(n):
            tracing.launched(name)
