"""Sum-factorized (matrix-free geometry) application of the element KLE
operator K: the Deville-Fischer-Mund SEM apply, in flat-quadrature form.

Port of pynama_tpu/ops/sumfact.py. On unstructured meshes every element has
its own geometry, so the engine's dense path stores a per-element K of
(nnode·dim)² floats — 147 KB per element at 3D ngl=4 in f32 — and every CG
iteration reads all of it. The sum-factorized form stores only
per-quadrature-point geometry:

    full family:  G[q]  = w_q |J_q| · J_q⁻¹ J_q⁻ᵀ   (dim×dim symmetric)
    reduced:      Jr[q] = J_q⁻¹,  wr[q] = w_q |J_q|

≈ 2.6 KB per element at 3D ngl=4.

Every reference-space gradient comes from ONE shared matmul per quadrature
family,

    g = z_cm @ Dstack            Dstack: (nn, dim·nq), columns r-major,
                                 Dstack[:, r·nq+q] = Π_ax A_ax[q_ax, i_ax],
                                 A_ax = D1d if ax == r else H1d

with z_cm the component-major (E·c, nn) view of the element vector; the
dim×dim geometry contractions are unrolled pointwise multiply-adds over
(E, c, nq) tensors, and the transposed scatter Σ_r D_rᵀ s_r is one matmul
with Dstackᵀ per family. Four shared matmuls in all, in full f32
(config.py pins TF32 off).

`build_sumfact` is host numpy (setup) and returns a `SumFactK` of tensors
on the given device. `apply_sumfact_k` has two routes:

- on a CUDA tensor, one launch of the hand-written kernel of
  `csrc/sumfact_apply.cu` (built into the kernels' library by
  `ops/_build.py`), which applies the 1D operators of `one_d_tables` axis by
  axis and keeps every intermediate on chip; a shape it does not take
  raises, there is no fallback;
- on a CPU tensor, the plain PyTorch version `apply_sumfact_k_ref` below
  (the chain of matmuls and pointwise ops described above).

The result equals `elements/kle.py compute_kle_matrices`' K applied per
element (same quadrature families). The engine uses it for K on
unstructured meshes by default, and on box meshes when asked
(`build_engine(..., sumfact=True)`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

import pynama_tpu_torch.config  # noqa: F401 -- full-f32 matmul pins
from pynama_tpu_torch.basis.lagrange import lagrange_basis
from pynama_tpu_torch.basis.quadrature import gauss_points, lobatto_points
from pynama_tpu_torch.elements.kle import ALPHA_D, ALPHA_W, curl_tensor


@dataclasses.dataclass(frozen=True)
class SumFactK:
    """Per-element geometric factors + shared flat tables for one mesh."""
    #: (E, dim, dim, nqf) full-family w|J|·J⁻¹J⁻ᵀ, Gt[e,r,s,q] (symmetric)
    Gt: torch.Tensor
    #: (E, dim, dim, nqr) reduced-family J⁻¹, Jrt[e,p,r,q]:
    #: ∂u/∂x_p = Σ_r Jrt[p,r] ∂u/∂ξ_r
    Jrt: torch.Tensor
    #: (E, nqr) reduced-family w|J|
    wr: torch.Tensor
    #: stacked flat derivative operators, (nn, dim·nq), columns r-major
    Df_flat: torch.Tensor
    Dr_flat: torch.Tensor
    #: column gathers (int64): interleaved (node-major) <-> component-major
    v2cm: torch.Tensor
    cm2v: torch.Tensor
    dim: int
    ngl: int
    alpha_w: float = ALPHA_W
    alpha_d: float = ALPHA_D

    @property
    def nqf(self) -> int:
        return self.Gt.shape[-1]

    @property
    def nqr(self) -> int:
        return self.wr.shape[-1]


#: the fields of a SumFactK, as `engine.local_engine.ops_from_numpy` takes
#: them (prefixed "sumfact.")
FIELDS = ("Gt", "Jrt", "wr", "Df_flat", "Dr_flat", "v2cm", "cm2v", "dim",
          "ngl", "alpha_w", "alpha_d")


def _family_geometry(DCoo: np.ndarray, weights: np.ndarray,
                     corners: np.ndarray):
    """Jinv (E, nq, dim, dim) and w|J| (E, nq) from corner coords."""
    J = np.einsum('qra,eap->eqrp', DCoo, corners)
    detJ = np.abs(np.linalg.det(J))   # w|J|: orientation-safe
    Jinv = np.linalg.inv(J)
    return Jinv, weights[None, :] * detJ


def _flat_stack(H: np.ndarray, D: np.ndarray, dim: int) -> np.ndarray:
    """(nn, dim·nq) stacked kron operators, q-major rows (q0 slowest),
    i-major columns (i0 slowest), matching the canonical tensor orders of
    both the element vector and the families' DCoo point grids."""
    blocks = []
    for r in range(dim):
        M = np.ones((1, 1))
        for ax in range(dim):
            M = np.kron(M, D if ax == r else H)
        blocks.append(M.T)                       # (nn, nq)
    return np.concatenate(blocks, axis=1)        # (nn, dim*nq)


def one_d_tables(ngl: int):
    """(Hf, Df, Hr, Dr), float64: the Lagrange values and derivatives of
    the ngl Lobatto nodes, [q, i], at the full family's 1D points (Gauss
    for ngl <= 3, else Lobatto) and at the reduced family's (ngl-1 Gauss).
    `sumfact_arrays`' flat tables are their Kronecker products
    (`_flat_stack`); the kernel applies them axis by axis."""
    nodes1d, _ = lobatto_points(ngl)
    if ngl <= 3:
        fq, _ = gauss_points(ngl)
    else:
        fq, _ = lobatto_points(ngl)
    rq, _ = gauss_points(ngl - 1)
    Hf, Df = lagrange_basis(nodes1d, fq)
    Hr, Dr = lagrange_basis(nodes1d, rq)
    return Hf, Df, Hr, Dr


def sumfact_arrays(basis, corners: np.ndarray, alpha_w: float = ALPHA_W,
                   alpha_d: float = ALPHA_D) -> dict:
    """The numpy fields of a SumFactK (keys: FIELDS), float64, from a
    TensorBasis and (E, 2**dim, dim) corner coords."""
    dim, ngl = basis.dim, basis.ngl
    nn = ngl ** dim
    corners = np.asarray(corners, dtype=np.float64)
    if corners.ndim == 2:
        corners = corners[None]

    Jf, wf = _family_geometry(basis.full.DCoo, basis.full.weights, corners)
    # G[e,q,r,s] = w|J| Σ_p Jinv[p,r] Jinv[p,s] -> transpose q last
    G = np.einsum('eq,eqpr,eqps->eqrs', wf, Jf, Jf)
    Jr, wr = _family_geometry(basis.reduced.DCoo, basis.reduced.weights,
                              corners)

    Hf, Df, Hr, Dr = one_d_tables(ngl)

    dst = np.arange(dim * nn)
    return dict(
        Gt=np.moveaxis(G, 1, -1),                # (E, r, s, nqf)
        Jrt=np.moveaxis(Jr, 1, -1),              # (E, p, r, nqr)
        wr=wr, Df_flat=_flat_stack(Hf, Df, dim),
        Dr_flat=_flat_stack(Hr, Dr, dim),
        v2cm=(dst % nn) * dim + dst // nn, cm2v=(dst % dim) * nn + dst // dim,
        dim=dim, ngl=ngl, alpha_w=float(alpha_w), alpha_d=float(alpha_d))


def sumfact_from_numpy(arrays: dict, *, device, dtype) -> SumFactK:
    """SumFactK from numpy arrays keyed by FIELDS (either package's fields
    carry over one to one): float arrays cast to `dtype` on `device`, the
    column gathers to int64, the rest to Python scalars."""
    f = lambda k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                                  device=device).contiguous()
    idx = lambda k: torch.as_tensor(np.asarray(arrays[k], dtype=np.int64),
                                    device=device)
    return SumFactK(
        Gt=f("Gt"), Jrt=f("Jrt"), wr=f("wr"), Df_flat=f("Df_flat"),
        Dr_flat=f("Dr_flat"), v2cm=idx("v2cm"), cm2v=idx("cm2v"),
        dim=int(arrays["dim"]), ngl=int(arrays["ngl"]),
        alpha_w=float(arrays["alpha_w"]), alpha_d=float(arrays["alpha_d"]))


def build_sumfact(basis, corners: np.ndarray, *, device, dtype,
                  alpha_w: float = ALPHA_W,
                  alpha_d: float = ALPHA_D) -> SumFactK:
    """SumFactK on `device` from a TensorBasis and (E, 2**dim, dim) corner
    coords (the geometry is computed on the host in float64)."""
    return sumfact_from_numpy(sumfact_arrays(basis, corners, alpha_w,
                                             alpha_d),
                              device=device, dtype=dtype)


def apply_sumfact_k_ref(sf: SumFactK, t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `apply_sumfact_k` (its route on the
    CPU): the chain of shared matmuls and pointwise multiply-adds."""
    dim, N = sf.dim, sf.ngl
    nn = N ** dim
    E = t.shape[0]
    nqf, nqr = sf.nqf, sf.nqr
    Tc = curl_tensor(dim)                         # host numpy constant
    dim_w = Tc.shape[0]

    zc = t[:, sf.v2cm].reshape(E * dim, nn)       # component-major rows

    # ---- reference-space gradients, both families: ONE matmul each
    gf = (zc @ sf.Df_flat).reshape(E, dim, dim, nqf)     # [e, c, r, q]
    gr = (zc @ sf.Dr_flat).reshape(E, dim, dim, nqr)

    # ---- stiffness cotangent: s[p,c] = Σ_r G[r,p] g[r,c]  (G symmetric)
    s_p = []
    for p in range(dim):
        acc = None
        for r in range(dim):
            term = sf.Gt[:, r, p, :][:, None, :] * gf[:, :, r, :]
            acc = term if acc is None else acc + term
        s_p.append(acc)                           # (E, c, nqf)

    # ---- penalties: physical gradient gp[p][e,c,q] = ∂u_c/∂x_p
    gp = []
    for p in range(dim):
        acc = None
        for r in range(dim):
            term = sf.Jrt[:, p, r, :][:, None, :] * gr[:, :, r, :]
            acc = term if acc is None else acc + term
        gp.append(acc)
    div = None                                    # (E, nqr)
    for c in range(dim):
        d = gp[c][:, c, :]
        div = d if div is None else div + d
    curl_w = []
    for w in range(dim_w):
        acc = None
        for c in range(dim):
            for d in range(dim):
                tv = float(Tc[w, c, d])
                if tv == 0.0:
                    continue
                term = tv * gp[d][:, c, :]
                acc = term if acc is None else acc + term
        curl_w.append(acc)                        # (E, nqr)

    # cotangent sp[p][e,c,q] = α_d w div δ_pc + α_w w Σ_w T[w,c,p] curl_w
    wdiv = sf.alpha_d * (sf.wr * div)
    sp = []
    for p in range(dim):
        cols = []
        for c in range(dim):
            val = wdiv if c == p else None
            for w in range(dim_w):
                tv = float(Tc[w, c, p])
                if tv == 0.0:
                    continue
                term = (sf.alpha_w * tv) * (sf.wr * curl_w[w])
                val = term if val is None else val + term
            if val is None:
                val = t.new_zeros((E, nqr))
            cols.append(val)
        sp.append(torch.stack(cols, dim=1))       # (E, c, nqr)

    # back to reference axes: sr[r][e,c,q] = Σ_p Jr[p,r] sp[p]
    sr = []
    for r in range(dim):
        acc = None
        for p in range(dim):
            term = sf.Jrt[:, p, r, :][:, None, :] * sp[p]
            acc = term if acc is None else acc + term
        sr.append(acc)

    # ---- transposed scatters: one matmul per family with Dstackᵀ
    sf_stack = torch.stack(s_p, dim=2).reshape(E * dim, dim * nqf)
    sr_stack = torch.stack(sr, dim=2).reshape(E * dim, dim * nqr)
    y = sf_stack @ sf.Df_flat.T + sr_stack @ sf.Dr_flat.T
    return y.reshape(E, dim * nn)[:, sf.cm2v]


# ------------------------------------------------------------- the kernel
#: the (dim, ngl) the kernel is instantiated for (csrc/sumfact_apply.cu)
KERNEL_DIMS = (2, 3)
KERNEL_NGL = range(2, 9)
#: float64 slots of _Args.tab: Hf, Df, Hr, Dr row-major at ngl 8
TAB_SLOTS = 4 * 8 * 8


class _Args(ctypes.Structure):
    """csrc/sumfact_apply.cu's Args, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "t", "y", "Gt", "Jr", "wr", "stream")] + [
        ("E", ctypes.c_int64), ("dim", ctypes.c_int), ("ngl", ctypes.c_int),
        ("f64", ctypes.c_int), ("pad", ctypes.c_int),
        ("alpha_w", ctypes.c_double), ("alpha_d", ctypes.c_double),
        ("tab", ctypes.c_double * TAB_SLOTS)]


def kernel_tables(ngl: int) -> np.ndarray:
    """The kernel's 1D tables as its arguments carry them: Hf, Df, Hr, Dr
    of `one_d_tables`, each row-major, one after the other (float64)."""
    return np.concatenate([a.ravel() for a in one_d_tables(ngl)])


def check_input(sf: SumFactK, t: torch.Tensor) -> None:
    """Raise unless t is a contiguous (E, dim·ngl^dim) tensor of sf's dtype
    on sf's device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError("apply_sumfact_k takes a torch tensor")
    if t.dtype != sf.Gt.dtype:
        raise TypeError(f"apply_sumfact_k: t is {t.dtype}, the SumFactK "
                        f"{sf.Gt.dtype}")
    if t.device != sf.Gt.device:
        raise ValueError(f"apply_sumfact_k: t on {t.device}, the SumFactK "
                         f"on {sf.Gt.device}")
    shape = (sf.Gt.shape[0], sf.dim * sf.ngl ** sf.dim)
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"apply_sumfact_k: t must be a contiguous {shape} "
                         f"tensor, got {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


#: the kernel's argument block of each SumFactK that has run on a card, by
#: id, bound at its first CUDA call and dropped when it is collected
_BLOCKS = {}


def _bind(sf: SumFactK):
    """The argument block of sf's product (checked once)."""
    from pynama_tpu_torch.ops._build import ArgBlock
    if sf.dim not in KERNEL_DIMS or sf.ngl not in KERNEL_NGL:
        raise ValueError(f"the sumfact kernel takes dim {KERNEL_DIMS} and "
                         f"ngl 2-8, not dim {sf.dim} ngl {sf.ngl}")
    if sf.Gt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the sumfact kernel takes float32 or float64, not "
                        f"{sf.Gt.dtype}")
    for name in ("Gt", "Jrt", "wr"):
        a = getattr(sf, name)
        if a.dtype != sf.Gt.dtype or a.device != sf.Gt.device \
                or not a.is_contiguous():
            raise ValueError(f"SumFactK.{name}: a contiguous "
                             f"{sf.Gt.dtype} tensor on {sf.Gt.device}")
    tab = kernel_tables(sf.ngl)
    a = _Args(Gt=sf.Gt.data_ptr(), Jr=sf.Jrt.data_ptr(),
              wr=sf.wr.data_ptr(), E=sf.Gt.shape[0], dim=sf.dim,
              ngl=sf.ngl, f64=int(sf.Gt.dtype == torch.float64),
              alpha_w=sf.alpha_w, alpha_d=sf.alpha_d)
    a.tab[:tab.size] = tab.tolist()
    block = _BLOCKS[id(sf)] = ArgBlock(a, sf.Gt.device, "pn_sumfact_apply")
    weakref.finalize(sf, _BLOCKS.pop, id(sf), None)
    return block


def apply_sumfact_k(sf: SumFactK, t: torch.Tensor) -> torch.Tensor:
    """y = t @ K_eᵀ per element, (E, nnode·dim) -> (E, nnode·dim): the
    un-assembled element product (the caller DSSes, as with the dense
    path). On a CUDA tensor one launch of csrc/sumfact_apply.cu on the
    current stream, else `apply_sumfact_k_ref`; t must be a contiguous
    (E, dim·ngl^dim) tensor of sf's dtype and device."""
    check_input(sf, t)
    if t.device.type != "cuda":
        return apply_sumfact_k_ref(sf, t)
    block = _BLOCKS.get(id(sf)) or _bind(sf)
    y = torch.empty_like(t)
    a = block.args
    a.t, a.y = t.data_ptr(), y.data_ptr()
    # this call's stream: a CUDA graph capture runs on a stream of its own
    a.stream = torch.cuda.current_stream(t.device).cuda_stream
    block.launch("pn_sumfact_apply")
    apply_sumfact_k.launches += 1
    return y


#: kernel launches of this process (CPU calls do not count)
apply_sumfact_k.launches = 0
