"""Fused element matmul + DSS for structured box meshes: the Hopper kernel.

``fused_apply(t, matT, nelem, ngl, ncomp_out) -> (y, bnd)`` computes
``y = DSS(t @ matT)`` on the canonical element-local layout of a box mesh,
and ``bnd``, the raw first and last axis-0 planes (axes 1..dim-1 assembled,
no axis-0 adds), shape (2, prod(nelem[1:]), ngl**(dim-1) * ncomp_out).

It replaces the Pallas kernel ``pynama_tpu/ops/fused.py::_fused_kernel``.
On a CUDA tensor it launches the hand-written CUDA C++ kernel in
``csrc/fused_apply.cu`` (a GEMM, FFMA in f32 and FP64 tensor cores in f64,
then a DSS pass over shared-memory tiles that also writes the boundary
planes; built by nvcc for sm_90a at first use, see ``ops/_build.py``), on
PyTorch's current stream. On a CPU tensor it runs ``fused_apply_ref``, the
plain PyTorch version. There is no fallback from the kernel to the plain
version: a CUDA call launches the kernel or raises.

What bounds it on an H100: at 24^3 ngl=4 one K apply is about 1.0 GFLOP
against about 42 MB of HBM traffic; the GEMM is bound by FFMA issue, the
DSS pass by HBM (details in the .cu files).

``dss_pass(u, ...)`` runs the DSS pass alone on a given u (the kernel on a
CUDA tensor, ``dss_ref`` on a CPU one), for checks and timing.
``dss_tile_plan`` and the ``dss_tile_*`` helpers restate in Python how the
kernel covers a mesh: which rows and planes a CTA stages, which tile entries
each of its passes adds (axis 0, then 1, then 2), and which tile entries
become ``y`` and ``bnd``; the CPU tests run ``u`` through them and compare
with the plain version bit for bit.

``fused_apply.launches`` and ``dss_pass.launches`` count the kernel launches
made by this process (one per call on a CUDA tensor; plain-version calls do
not count).
"""
from __future__ import annotations

import ctypes
import itertools
import math

import numpy as np
import torch

from pynama_tpu_torch.ops import local as L

_DTYPES = {torch.float32: "pn_fused_apply_f32",
           torch.float64: "pn_fused_apply_f64"}
_DSS = {torch.float32: "pn_dss_f32", torch.float64: "pn_dss_f64"}
# make_dss_plan's rule (csrc/fused_common.cuh)
DSS_SM_SMEM = 228 * 1024
DSS_MAX_TILE = 227 * 1024
DSS_SM_THREADS = 768
DSS_MAX_THREADS = 512


def _shapes(nelem, ngl, ncomp_out):
    dim = len(nelem)
    E = math.prod(nelem)
    R = math.prod(nelem[1:])
    nnc_out = ngl ** dim * ncomp_out
    plane = ngl ** (dim - 1) * ncomp_out
    return dim, E, R, nnc_out, plane


def dss_ref(z: torch.Tensor, nelem: tuple, ngl: int, ncomp: int):
    """Plain PyTorch version of the DSS pass: (dss(z), raw boundary
    planes)."""
    nelem = tuple(int(n) for n in nelem)
    dim, E, R, nnc, plane = _shapes(nelem, ngl, ncomp)
    perms = L.make_perms(ngl, dim, ncomp, z.device)
    y = L.dss_box(z, nelem, ngl, ncomp, perms)
    # boundary planes: the single-slice DSS (axes 1..dim-1) of the first
    # and last axis-0 slices
    sub = (1,) + nelem[1:]
    first = L.dss_box(z[:R], sub, ngl, ncomp, perms)[:, :plane]
    last = L.dss_box(z[E - R:], sub, ngl, ncomp, perms)[:, nnc - plane:]
    return y, torch.stack([first, last])


def fused_apply_ref(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                    ngl: int, ncomp_out: int):
    """Plain PyTorch version: (dss(emm(t, matT)), raw boundary planes)."""
    return dss_ref(L.emm(t, matT), nelem, ngl, ncomp_out)


def _check_mesh(nelem, ngl, ncomp_out):
    """(E, nnc_out) of a mesh shape the kernels take; raise on another."""
    if len(nelem) not in (2, 3) or min(nelem) < 1 or ngl < 2 \
            or ncomp_out < 1:
        raise ValueError(f"bad mesh shape nelem={nelem} ngl={ngl} "
                         f"ncomp_out={ncomp_out}")
    dim, E, _, nnc_out, _ = _shapes(nelem, ngl, ncomp_out)
    if E >= 2**31:
        raise ValueError(f"{E} elements: the kernel indexes elements "
                         "with 32-bit integers")
    return E, nnc_out


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
    E, nnc_out = _check_mesh(nelem, ngl, ncomp_out)
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


def dss_pass(u: torch.Tensor, nelem: tuple, ngl: int, ncomp: int,
             chunk: int = 0):
    """K1's DSS pass alone: (y, bnd) of u (E, ngl**dim * ncomp), as
    ``dss_ref`` computes them. CPU tensors take ``dss_ref``, CUDA tensors
    the kernel. chunk > 0 forces the kernel's chunk length (a measurement
    knob); 0 takes make_dss_plan's rule."""
    nelem = tuple(int(n) for n in nelem)
    ngl, ncomp = int(ngl), int(ncomp)
    if not isinstance(u, torch.Tensor) or u.dtype not in _DSS:
        raise TypeError("dss_pass takes a float32 or float64 tensor")
    E, nnc = _check_mesh(nelem, ngl, ncomp)
    if tuple(u.shape) != (E, nnc) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous (E={E}, {nnc}) tensor; "
                         f"got {tuple(u.shape)}")
    check_device(u, "dss_pass")
    if u.device.type == "cpu":
        return dss_ref(u, nelem, ngl, ncomp)

    from pynama_tpu_torch.ops._build import launch
    dim, _, R, _, plane = _shapes(nelem, ngl, ncomp)
    y = torch.empty_like(u)
    bnd = torch.empty((2, R, plane), dtype=u.dtype, device=u.device)
    ne = list(nelem) + [1] * (3 - dim)
    launch(_DSS[u.dtype], u.device, u.data_ptr(), y.data_ptr(),
           bnd.data_ptr(), ngl, ncomp, dim, ne[0], ne[1], ne[2], int(chunk))
    dss_pass.launches += 1
    return y, bnd


dss_pass.launches = 0


def dss_library_plan(nelem: tuple, ngl: int, ncomp: int, elem_bytes: int,
                     chunk: int = 0) -> dict:
    """The plan the kernel library's DSS pass takes for this shape (needs
    nvcc; launches nothing), in dss_tile_plan's names."""
    from pynama_tpu_torch.ops._build import load_library
    nelem = tuple(int(n) for n in nelem)
    ne = list(nelem) + [1] * (3 - len(nelem))
    out = (ctypes.c_int * 5)()
    rc = load_library().pn_dss_plan(ngl, ncomp, len(nelem), *ne, elem_bytes,
                                    chunk, out)
    if rc != 0:
        raise ValueError(f"no DSS plan for {elem_bytes}-byte elements")
    return dict(zip(("C", "nch", "threads", "tile_bytes", "copy_bytes"),
                    out))


# ------------------------------------------------------- the DSS tile plan
def dss_tile_plan(nelem: tuple, ngl: int, ncomp: int, elem_bytes: int,
                  chunk: int = 0) -> dict:
    """How the CUDA DSS pass covers a mesh: csrc/fused_common.cuh's
    make_dss_plan, restated. The mesh is viewed as 3D with axis 2 fastest
    (``ne``, ``nn``: elements and nodes per element per axis; a 2D mesh
    gets a leading axis of one element with one node; ``fa`` is the view
    axis of the mesh's axis 0). A CTA owns ``C`` consecutive elements of an
    axis-2 row; slab 3 (i0 + 1) + (i1 + 1) of its tile holds C + 2 elements
    of the neighbour row (e0 + i0, e1 + i1), ``sz[slab]`` entries each, from
    ``base[slab]`` on."""
    nelem = tuple(int(n) for n in nelem)
    dim = len(nelem)
    lead = 3 - dim
    ne = (1,) * lead + nelem
    nn = (1,) * lead + (ngl,) * dim
    line = ngl * ncomp
    nnc = ngl ** dim * ncomp
    sz = [((1 if i0 else nn[0]) * (1 if i1 else nn[1]) * line
           if (i0 == 0 or ne[0] > 1) and (i1 == 0 or ne[1] > 1) else 0)
          for i0 in (-1, 0, 1) for i1 in (-1, 0, 1)]
    ne2, rows = ne[2], ne[0] * ne[1]
    threads = min(max(-(-nnc // 32) * 32, 64), DSS_MAX_THREADS)

    def too_long(c):
        nbytes = (c + 2) * sum(sz) * elem_bytes
        return nbytes > DSS_MAX_TILE or \
            DSS_SM_SMEM // (nbytes + 1024) * threads < DSS_SM_THREADS

    C = min(chunk, ne2) if chunk > 0 else ne2
    if chunk <= 0:
        nch = 1
        while C > 1 and too_long(C):
            nch += 1
            C = -(-ne2 // nch)
    nch = -(-ne2 // C)
    base = list(itertools.accumulate(((C + 2) * n for n in sz), initial=0))
    return dict(ne=ne, nn=nn, nc=ncomp, nnc=nnc, line=line, fa=lead,
                R=(ne[1] if lead == 0 else 1) * ne2, plane=nnc // ngl, C=C,
                nch=nch, sz=sz, base=base[:9], tile=base[9], threads=threads,
                ctas=rows * nch, tile_bytes=base[9] * elem_bytes,
                copy_bytes=16 if line % (16 // elem_bytes) == 0
                else elem_bytes)


def dss_tile_cta(plan: dict, b: int) -> dict:
    """CTA b of the plan: its row (e0, e1), first element c0 and length C
    along axis 2; the slab elements that exist, [klo, khi); the runs it
    stages, as (entry of u, entry of the tile, length); the runs it writes,
    as (entry of the tile, entry of y or of bnd.ravel(), length), for y
    (`y_runs`) and bnd (`bnd_runs`)."""
    ne, nn, line, nnc = plan["ne"], plan["nn"], plan["line"], plan["nnc"]
    row, ch = divmod(b, plan["nch"])
    c0 = ch * plan["C"]
    e0, e1 = divmod(row, ne[1])
    C = min(plan["C"], ne[2] - c0)
    klo, khi = (1 if c0 == 0 else 0), min(C + 2, ne[2] - c0 + 1)
    runs = []
    for i0, i1 in itertools.product((-1, 0, 1), repeat=2):
        if not (0 <= e0 + i0 < ne[0] and 0 <= e1 + i1 < ne[1]):
            continue
        slab = 3 * (i0 + 1) + (i1 + 1)
        sz = plan["sz"][slab]
        # a slab element: nr runs of `length` entries, rstride apart in u,
        # from the facing a0 plane (i0 != 0) and a1 line (i1 != 0) on
        f0 = nn[0] - 1 if i0 < 0 else 0
        f1 = nn[1] - 1 if i1 < 0 else 0
        nr = nn[0] if i1 and not i0 else 1
        length = line if i1 else sz
        rstride = nn[1] * line
        soff = f0 * rstride + (f1 * line if i1 else 0)
        for kk in range(klo, khi):
            src = ((row + i0 * ne[1] + i1) * ne[2] + c0 - 1 + kk) * nnc
            runs += [(src + soff + j * rstride,
                      plan["base"][slab] + kk * sz + j * length, length)
                     for j in range(nr)]
    # y: the chunk's rows of the own slab; bnd: their first (last) plane,
    # for a CTA on the first (last) slice along the mesh's axis 0
    t0 = plan["base"][4] + nnc
    y_runs = [(t0, (row * ne[2] + c0) * nnc, C * nnc)]
    fa, plane = plan["fa"], plan["plane"]
    ef = e0 if fa == 0 else e1
    r0 = (e1 * ne[2] if fa == 0 else 0) + c0
    bnd_runs = [(t0 + k * nnc + (nnc - plane if side else 0),
                 (side * plan["R"] + r0 + k) * plane, plane)
                for side in (0, 1) if ef == (ne[fa] - 1 if side else 0)
                for k in range(C)]
    return dict(e0=e0, e1=e1, c0=c0, C=C, klo=klo, khi=khi, runs=runs,
                y_runs=y_runs, bnd_runs=bnd_runs)


def dss_tile_passes(plan: dict, cta: dict) -> list:
    """The kernel's passes over a CTA's tile, in order: axis 0, 1, 2. A
    pass is (a, b, to_a, to_b), index arrays of its pairs of tile entries:
    each pair's sum tile[a] + tile[b] is written to a where to_a and to b
    where to_b. No entry is in two pairs of one pass."""
    nn, ne, nc, line, nnc = (plan["nn"], plan["ne"], plan["nc"],
                             plan["line"], plan["nnc"])
    base, own = plan["base"], plan["base"][4]
    ks = np.arange(cta["klo"], cta["khi"])[:, None]
    has = [[cta["e0"] > 0, cta["e0"] < ne[0] - 1],
           [cta["e1"] > 0, cta["e1"] < ne[1] - 1]]
    F0, F1 = nn[1] * line, nn[0] * line

    def pairs(a, b):
        return a.ravel(), b.ravel()

    # axis 0: own a0 faces + slabs (+-1, 0); a0 faces of slabs (0, +-1) +
    # the diagonal slabs
    p0 = []
    for s0 in (0, 1):
        if not has[0][s0]:
            continue
        f = nn[0] - 1 if s0 else 0
        j = np.arange(F0)
        p0.append(pairs(own + ks * nnc + f * F0 + j,
                        base[7 if s0 else 1] + ks * F0 + j))
        for s1 in (0, 1):
            if has[1][s1]:
                j = np.arange(line)
                p0.append(pairs(base[5 if s1 else 3] + ks * F1 + f * line + j,
                                base[(6 if s0 else 0) + (2 if s1 else 0)]
                                + ks * line + j))
    # axis 1: own a1 faces + slabs (0, +-1)
    p1 = []
    for s1 in (0, 1):
        if has[1][s1]:
            g = nn[1] - 1 if s1 else 0
            a0, r = np.divmod(np.arange(F1), line)
            p1.append(pairs(own + ks * nnc + (a0 * nn[1] + g) * line + r,
                            base[5 if s1 else 3] + ks * F1 + a0 * line + r))
    out = []
    for ps in (p0, p1):
        a = np.concatenate([p[0] for p in ps]) if ps else np.zeros(0, int)
        b = np.concatenate([p[1] for p in ps]) if ps else np.zeros(0, int)
        out.append((a, b, np.ones(a.size, bool), np.zeros(b.size, bool)))
    # axis 2: (element kk - 1 at a2 = nn2 - 1, element kk at a2 = 0), the
    # sum written to whichever is the chunk's own
    kk = np.arange(cta["klo"] + 1, cta["khi"])[:, None]
    a01, comp = np.divmod(np.arange(nn[0] * nn[1] * nc), nc)
    hi = own + kk * nnc + a01 * line + comp
    lo = hi - nnc + (nn[2] - 1) * nc
    out.append((lo.ravel(), hi.ravel(),
                np.broadcast_to(kk > 1, hi.shape).ravel(),
                np.broadcast_to(kk <= cta["C"], hi.shape).ravel()))
    return out
