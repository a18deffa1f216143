"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

`load_library()` compiles every source in `pynama_tpu_torch/csrc/` into one
shared library with a plain C interface, at first use, and binds it with
ctypes. The library goes to `pynama_tpu_torch/_build/`, named by a hash of
the sources and the compiler flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time: the package
imports on machines without nvcc or a GPU.

A missing nvcc or a failed build raises with the compiler's output. There is
no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
#: seconds the build in this process took (0.0: the library was built
#: before) and the compiler's output (ptxas -v: registers, spills, smem)
last_build_seconds = 0.0
last_build_log = ""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            if os.path.exists(cand):
                nvcc = cand
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
            "pynama_tpu_torch are built from source at first use")
    return nvcc


def _lib_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpynama_kernels_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global last_build_seconds, last_build_log
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temp name + atomic rename: concurrent builders never load a
    # half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    if _lib is not None:
        return _lib
    out = _lib_path()
    if not os.path.exists(out):
        _build(out)
    lib = ctypes.CDLL(out)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in ("pn_fused_apply_f32", "pn_fused_apply_f64"):
        fn = getattr(lib, name)
        # t, matT, u, y, bnd, E, nnc_in, ngl, ncomp_out, dim,
        # ne0, ne1, ne2, stream
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32,
                       i32, i32, i32, vp]
        fn.restype = i32
    lib.pn_cuda_error_string.argtypes = [i32]
    lib.pn_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
