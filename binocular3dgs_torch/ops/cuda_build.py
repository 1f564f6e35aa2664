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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            signatures = {
                "b3dgs_blend_forward": [P, LL, P, P, I, I, P, P, P],
                "b3dgs_blend_backward": [P, LL, P, P, P, P, P, I, I, P, P],
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
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = I
            _lib = lib
        return _lib
