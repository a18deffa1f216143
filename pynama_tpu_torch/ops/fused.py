"""Fused element matmul + DSS for structured box meshes: the Hopper kernel.

``fused_apply(t, matT, nelem, ngl, ncomp_out) -> (y, bnd)`` computes
``y = DSS(t @ matT)`` on the canonical element-local layout of a box mesh,
and ``bnd``, the raw first and last axis-0 planes (axes 1..dim-1 assembled,
no axis-0 adds), shape (2, prod(nelem[1:]), ngl**(dim-1) * ncomp_out).

It replaces the Pallas kernel ``pynama_tpu/ops/fused.py::_fused_kernel``.
On a CUDA tensor it launches the hand-written CUDA C++ kernel in
``csrc/fused_apply.cu`` (a GEMM, FFMA in f32 and FP64 tensor cores in f64,
then an index-arithmetic DSS and the boundary planes; built by nvcc for
sm_90a at first use, see ``ops/_build.py``), on PyTorch's current stream. On
a CPU tensor it runs ``fused_apply_ref``, the plain PyTorch version. There
is no fallback from the kernel to the plain version: a CUDA call launches
the kernel or raises.

What bounds it on an H100: at 24^3 ngl=4 one K apply is about 1.0 GFLOP
against about 42 MB of HBM traffic; the GEMM is bound by FFMA issue, the
DSS pass by its per-slot work (details in the .cu files).

``fused_apply.launches`` counts the kernel launches made by this process
(one per call on a CUDA tensor; plain-version calls do not count).
"""
from __future__ import annotations

import functools
import math

import torch

from pynama_tpu_torch.ops import local as L

_DTYPES = {torch.float32: "pn_fused_apply_f32",
           torch.float64: "pn_fused_apply_f64"}


def _shapes(nelem, ngl, ncomp_out):
    dim = len(nelem)
    E = math.prod(nelem)
    R = math.prod(nelem[1:])
    nnc_out = ngl ** dim * ncomp_out
    plane = ngl ** (dim - 1) * ncomp_out
    return dim, E, R, nnc_out, plane


@functools.lru_cache(maxsize=64)
def _perms(ngl: int, dim: int, ncomp: int, device: torch.device) -> tuple:
    return L.make_perms(ngl, dim, ncomp, device)


def fused_apply_ref(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                    ngl: int, ncomp_out: int):
    """Plain PyTorch version: (dss(emm(t, matT)), raw boundary planes)."""
    nelem = tuple(int(n) for n in nelem)
    dim, E, R, nnc, plane = _shapes(nelem, ngl, ncomp_out)
    perms = _perms(ngl, dim, ncomp_out, t.device)
    z = L.emm(t, matT)
    y = L.dss_box(z, nelem, ngl, ncomp_out, perms)
    # boundary planes: the single-slice DSS (axes 1..dim-1) of the first
    # and last axis-0 slices
    sub = (1,) + nelem[1:]
    first = L.dss_box(z[:R], sub, ngl, ncomp_out, perms)[:, :plane]
    last = L.dss_box(z[E - R:], sub, ngl, ncomp_out, perms)[:, nnc - plane:]
    return y, torch.stack([first, last])


def check_inputs(t, matT, nelem, ngl, ncomp_out, name="fused_apply"):
    """Raise on what the box-mesh apply kernels do not take; `name` is the
    caller's, for the message."""
    if not isinstance(t, torch.Tensor) or not isinstance(matT, torch.Tensor):
        raise TypeError(f"{name} takes torch tensors")
    if t.device != matT.device:
        raise ValueError(f"t on {t.device}, matT on {matT.device}")
    if t.dtype not in _DTYPES or matT.dtype != t.dtype:
        raise TypeError(f"{name} takes float32 or float64 tensors of "
                        f"one dtype; got {t.dtype} and {matT.dtype}")
    if len(nelem) not in (2, 3) or min(nelem) < 1 or ngl < 2 \
            or ncomp_out < 1:
        raise ValueError(f"bad mesh shape nelem={nelem} ngl={ngl} "
                         f"ncomp_out={ncomp_out}")
    dim, E, _, nnc_out, _ = _shapes(nelem, ngl, ncomp_out)
    if E >= 2**31:
        raise ValueError(f"{E} elements: the kernel indexes elements "
                         "with 32-bit integers")
    if t.dim() != 2 or t.shape[0] != E:
        raise ValueError(f"t must be (E={E}, nnc_in); got {tuple(t.shape)}")
    if matT.dim() != 2 or matT.shape != (t.shape[1], nnc_out):
        raise ValueError(f"matT must be ({t.shape[1]}, {nnc_out}); got "
                         f"{tuple(matT.shape)}")
    if not (t.is_contiguous() and matT.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def check_device(t, name="fused_apply"):
    """Raise unless t lies on the CPU (plain version) or a CUDA card."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def fused_apply(t: torch.Tensor, matT: torch.Tensor, nelem: tuple, ngl: int,
                ncomp_out: int):
    """y = DSS(t @ matT) and the raw axis-0 boundary planes; see the module
    docstring. CPU tensors take the plain version, CUDA tensors the kernel."""
    nelem = tuple(int(n) for n in nelem)
    ngl, ncomp_out = int(ngl), int(ncomp_out)
    check_inputs(t, matT, nelem, ngl, ncomp_out)
    check_device(t)
    if t.device.type == "cpu":
        return fused_apply_ref(t, matT, nelem, ngl, ncomp_out)

    from pynama_tpu_torch.ops._build import launch
    dim, E, R, nnc_out, plane = _shapes(nelem, ngl, ncomp_out)
    u = torch.empty((E, nnc_out), dtype=t.dtype, device=t.device)
    y = torch.empty_like(u)
    bnd = torch.empty((2, R, plane), dtype=t.dtype, device=t.device)
    ne = list(nelem) + [1] * (3 - dim)
    launch(_DTYPES[t.dtype], t.device, t.data_ptr(), matT.data_ptr(),
           u.data_ptr(), y.data_ptr(), bnd.data_ptr(), E, int(t.shape[1]),
           ngl, ncomp_out, dim, ne[0], ne[1], ne[2])
    fused_apply.launches += 1
    return y, bnd


fused_apply.launches = 0
