"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

`load_library()` compiles every source in `pynama_tpu_torch/csrc/` into one
shared library with a plain C interface, at first use, and binds it with
ctypes. Each `*.cu` compiles in its own nvcc process, all started together,
and one nvcc call links the objects. The library goes to
`pynama_tpu_torch/_build/`, named by a hash of every file the build reads
(`*.cu` and the `*.cuh` headers they include) and the compiler flags, so an
edited source or header builds anew and an unchanged tree is reused. Nothing
here runs at import time: the package imports on machines without nvcc or a
GPU.

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

COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]
#: flags of single sources on top of COMPILE_FLAGS: the sumfact kernel's 28
#: instantiations optimize in parallel threads, which cut the library's
#: whole build from 23.7 to 14.9 s on the H100 machine (the code and its
#: times unchanged)
SOURCE_FLAGS = {"sumfact_apply.cu": ["-split-compile=0"]}

_lib = None
#: seconds the build in this process took (0.0: the library was built
#: before) and the compiler's output (ptxas -v: registers, spills, smem)
last_build_seconds = 0.0
last_build_log = ""

# C entry points: name -> argument types. vp = pointer or stream, i64 = an
# element count, i32 = a small int. Every pointer must be c_void_p: without
# argtypes ctypes passes a Python int as a 32-bit int and cuts the pointer.
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# t, matT, u, y, bnd, E, nnc_in, ngl, ncomp_out, dim, ne0, ne1, ne2, stream
_FUSED = [_VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32,
          _I32, _I32, _I32, _VP]
# t, matT, y, M, K, N, stream
_PLAINMM = [_VP, _VP, _VP, _I64, _I32, _I32, _VP]
# t, matT, u, y, E, nnc_in, ngl, ncomp_out, dim, ne0, ne1, ne2, block,
# do_rolls, stream
_VARIANT = [_VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32,
            _I32, _I32, _I32, _I32, _I32, _VP]
# t, matT, split, split_bytes, u, y, E, nnc_in, ngl, ncomp_out, dim, ne0,
# ne1, ne2, stream
_FUSED3X = [_VP, _VP, _VP, _I64, _VP, _VP, _I64, _I32, _I32, _I32, _I32,
            _I32, _I32, _I32, _VP]
# t, matT, split, split_bytes, u, M, K, N, stream
_GEMM3X = [_VP, _VP, _VP, _I64, _VP, _I64, _I32, _I32, _VP]
# t, M, K, N, out (int[9]); launches nothing
_GEMM3X_PLAN = [_VP, _I64, _I32, _I32, ctypes.POINTER(_I32)]
# t, matT, y, K, N, elem_bytes, out (int[3]); launches nothing
_GEMM_PLAN = [_VP, _VP, _VP, _I32, _I32, _I32, ctypes.POINTER(_I32)]
# u, y, bnd, ngl, ncomp, dim, ne0, ne1, ne2, chunk, stream
_DSS = [_VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _VP]
# ngl, ncomp, dim, ne0, ne1, ne2, elem_bytes, chunk, out (int[5]); launches
# nothing
_DSS_PLAN = [_I32] * 8 + [ctypes.POINTER(_I32)]
# the address of a kernel's argument block (ArgBlock; ops/cg_epilogue.py,
# ops/sumfact.py and solver/fdm.py _Args)
_BLOCK = [_VP]
# an argument block (solver/fdm.py _Args), out (int[9]); launches nothing
_FDM_PLAN = [_VP, ctypes.POINTER(_I32)]
SIGNATURES = {
    "pn_fused_apply_f32": _FUSED, "pn_fused_apply_f64": _FUSED,
    "pn_plainmm_f32": _PLAINMM, "pn_plainmm_f64": _PLAINMM,
    "pn_gemm_plan": _GEMM_PLAN,
    "pn_variant_apply_f32": _VARIANT, "pn_variant_apply_f64": _VARIANT,
    "pn_fused3x_f32": _FUSED3X, "pn_gemm3x_f32": _GEMM3X,
    "pn_gemm3x_plan": _GEMM3X_PLAN,
    "pn_dss_f32": _DSS, "pn_dss_f64": _DSS, "pn_dss_plan": _DSS_PLAN,
    "pn_cg_pap": _BLOCK, "pn_cg_xr": _BLOCK, "pn_cg_rz": _BLOCK,
    "pn_cg_p": _BLOCK,
    "pn_sumfact_apply": _BLOCK, "pn_fdm_apply": _BLOCK,
    "pn_fdm_plan": _FDM_PLAN,
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _inputs() -> list[str]:
    """Every file the build reads: the sources and their headers."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


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
    for src in _inputs():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return os.path.join(BUILD_DIR,
                        f"libpynama_kernels_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global last_build_seconds, last_build_log
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temp names + atomic rename: a concurrent build never loads a
    # half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = _sources()
    objs = [f"{out}.{os.getpid()}.{i}.o" for i in range(len(srcs))]
    t0 = time.perf_counter()
    cmds = [[nvcc, *COMPILE_FLAGS,
             *SOURCE_FLAGS.get(os.path.basename(src), []), "-c", "-o", obj,
             src] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    log = "".join(o + e for o, e in outs)
    try:
        for cmd, p, (o, e) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                                   f"{' '.join(cmd)}\n{o}\n{e}")
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.unlink(f)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = log


def launch(symbol: str, device, *args) -> None:
    """Call the library's C entry point `symbol` with `args` and PyTorch's
    current stream on `device`; raise if it returns a CUDA error (a launch
    the card refused never runs, and no later synchronize reports it)."""
    import torch
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        _raise(lib, symbol, rc)


class ArgBlock:
    """A kernel's argument block, bound once: `args` is a ctypes.Structure
    that mirrors the kernel's Args field for field and has a `stream`
    field, into which the block writes PyTorch's current stream on
    `device`; `symbols` are the library's entry points that take the
    block's address. A launch is one ctypes call. A caller that launches on
    another stream later writes it into `args.stream` first."""

    def __init__(self, args: ctypes.Structure, device, *symbols: str):
        import torch
        self._lib = load_library()
        self.args = args
        args.stream = torch.cuda.current_stream(device).cuda_stream
        self._addr = ctypes.addressof(args)
        self._fns = {s: getattr(self._lib, s) for s in symbols}

    def launch(self, symbol: str) -> None:
        """One launch of `symbol` with the block; raise as `launch`."""
        rc = self._fns[symbol](self._addr)
        if rc != 0:
            _raise(self._lib, symbol, rc)


def _raise(lib, symbol: str, rc: int):
    raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc} "
                       f"({lib.pn_cuda_error_string(rc).decode()})")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    if _lib is not None:
        return _lib
    out = _lib_path()
    if not os.path.exists(out):
        _build(out)
    lib = ctypes.CDLL(out)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    lib.pn_cuda_error_string.argtypes = [_I32]
    lib.pn_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
