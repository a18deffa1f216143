"""Element-local KLE matrices and nodal operators.

Re-derivation of reference `src/domain/elements/spectral.py:92-228`
(`getElemKLEMatrices`, `getElemKLEOperators`) in vectorized tensor form, with
local dofs in plain tensor order (axis 0 slowest) and interleaved components
(dof = node*dim + comp). Supports a single element geometry or a batch of
element geometries (leading E axis) — on a uniform box mesh every element
shares one geometry, so a single set of matrices serves the whole mesh.

The KLE ("kinematic Laplacian") element system is
  K  = integral grad(v):grad(v)                     (full quadrature)
       + alpha_d * div(v) div(v) + alpha_w * curl(v).curl(v)   (reduced quad)
  Rw = integral v . curl(w)      (full)  + alpha_w curl(v).w   (reduced)
  Rd = -integral v . grad(.)     (full)  + alpha_d div-term    (reduced)
with alpha_w = 1e2, alpha_d = 1e3 (spectral.py:96-97).

Nodal operators (GLL nodal quadrature, spectral.py:162-228): SrT (velocity ->
symmetric strain components), DivSrT (strain -> velocity), Curl (velocity ->
vorticity), and the lumped weight vector used for row scaling.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pynama_tpu_torch.basis.tables import QuadFamily, TensorBasis

ALPHA_W = 1.0e2
ALPHA_D = 1.0e3


# ---------------------------------------------------------------------------
# sign/index tensors (the ind* tables of spectral.py:26-33 in dense form)
# ---------------------------------------------------------------------------

def curl_tensor(dim: int) -> np.ndarray:
    """T[w, c, d] with (curl v)_w = sum_{c,d} T[w,c,d] d_d v_c.

    2D: scalar curl  w_z = dv_y/dx - dv_x/dy   (dim_w = 1)
    3D: standard Levi-Civita curl              (dim_w = 3)
    """
    if dim == 2:
        T = np.zeros((1, 2, 2))
        T[0, 1, 0] = 1.0
        T[0, 0, 1] = -1.0
        return T
    T = np.zeros((3, 3, 3))
    for w in range(3):
        for d in range(3):
            for c in range(3):
                T[w, c, d] = _eps(w, d, c)
    return T


def _eps(i, j, k):
    return ((i - j) * (j - k) * (k - i)) / 2.0


def vorticity_curl_tensor(dim: int) -> np.ndarray:
    """T[c, e, d] with (curl w)_c = sum_{e,d} T[c,e,d] d_d w_e.

    2D: curl of scalar w -> (dw/dy, -dw/dx); 3D: standard curl.
    (reference indWCurl, spectral.py:26,31)
    """
    if dim == 2:
        T = np.zeros((2, 1, 2))
        T[0, 0, 1] = 1.0
        T[1, 0, 0] = -1.0
        return T
    T = np.zeros((3, 3, 3))
    for c in range(3):
        for e in range(3):
            for d in range(3):
                T[c, e, d] = _eps(c, d, e)
    return T


def srt_tensor(dim: int) -> np.ndarray:
    """T[s, c, d] with strain component s = sum T[s,c,d] d_d v_c.

    Reduced symmetric components (reference B_srt, spectral.py:199-217):
    2D: [du/dx, (du/dy+dv/dx)/2, dv/dy]
    3D: [du/dx, (u_y+v_x)/2, dv/dy, (v_z+w_y)/2, dw/dz, (u_z+w_x)/2]
    """
    if dim == 2:
        T = np.zeros((3, 2, 2))
        T[0, 0, 0] = 1.0
        T[2, 1, 1] = 1.0
        T[1, 1, 0] = 0.5
        T[1, 0, 1] = 0.5
        return T
    T = np.zeros((6, 3, 3))
    T[0, 0, 0] = 1.0
    T[2, 1, 1] = 1.0
    T[4, 2, 2] = 1.0
    for s, c, d in [(1, 1, 0), (1, 0, 1), (3, 2, 1), (3, 1, 2),
                    (5, 2, 0), (5, 0, 2)]:
        T[s, c, d] = 0.5
    return T


def div_srt_tensor(dim: int) -> np.ndarray:
    """T[c, s, d] with (div sigma)_c = sum T[c,s,d] d_d sigma_s.

    Uses the symmetric-component index map indBdiv (spectral.py:28,33):
    2D [[0,1],[1,2]]; 3D [[0,1,5],[1,2,3],[5,3,4]] with rows indexed by the
    derivative axis and columns by the velocity component.
    """
    ind = [[0, 1], [1, 2]] if dim == 2 else [[0, 1, 5], [1, 2, 3], [5, 3, 4]]
    dim_s = 3 if dim == 2 else 6
    T = np.zeros((dim, dim_s, dim))
    for d in range(dim):
        for c in range(dim):
            T[c, ind[d][c], d] = 1.0
    return T


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _geometry(fam: QuadFamily, corners: np.ndarray):
    """Physical derivatives and weighted Jacobian determinant.

    corners: (..., 2**dim, dim). Returns (Hxy, wdet):
      Hxy:  (..., nq, dim, nnode)   d h_a / d x_p at each quad point
      wdet: (..., nq)               w_q * det J_q
    """
    # J[..., q, r, p] = sum_a DCoo[q, r, a] corners[..., a, p]
    J = np.einsum('qra,...ap->...qrp', fam.DCoo, corners, optimize=True)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)  # (..., q, p, r) inverse as matrix
    Hxy = np.einsum('...qpr,qra->...qpa', Jinv, fam.D, optimize=True)
    wdet = fam.weights * detJ
    return Hxy, wdet


def _interleave_quad(M: np.ndarray, dims: tuple[int, int]) -> np.ndarray:
    """(..., a, c, b, e) -> (..., a*dc + c, b*de + e)."""
    dc, de = dims
    sh = M.shape
    return M.reshape(sh[:-4] + (sh[-4] * dc, sh[-2] * de))


# ---------------------------------------------------------------------------
# element matrices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElementMatrices:
    """K, Rw, Rd with interleaved dof layout; possibly batched over elements."""
    K: np.ndarray    # (..., nnode*dim, nnode*dim)
    Rw: np.ndarray   # (..., nnode*dim, nnode*dim_w)
    Rd: np.ndarray   # (..., nnode*dim, nnode)


@dataclasses.dataclass(frozen=True)
class ElementOperators:
    SrT: np.ndarray     # (..., nnode*dim_s, nnode*dim)
    DivSrT: np.ndarray  # (..., nnode*dim, nnode*dim_s)
    Curl: np.ndarray    # (..., nnode*dim_w, nnode*dim)
    weight: np.ndarray  # (..., nnode) lumped weights (w_q * detJ at nodes)


def compute_kle_matrices(basis: TensorBasis, corners: np.ndarray,
                         alpha_w: float = ALPHA_W,
                         alpha_d: float = ALPHA_D,
                         gemm_dtype=None) -> ElementMatrices:
    """Element K/Rw/Rd (reference getElemKLEMatrices, spectral.py:92-160).

    The quadratic forms run as explicit batched GEMMs with the big outputs
    built by strided slab assignment (5-index einsums + interleave copies
    materialized 2.4-4.7 GB f64 intermediates and dominated the
    unstructured setup).

    gemm_dtype: dtype of the batched quadratic-form GEMMs and outputs.
    Geometry stays f64. Default float64 (exact path, used by the shared
    box-mesh build and the f64 tests). float32 engages this OpenBLAS
    build's fast sgemm batch path — measured 100x faster than its
    pathological small-batch dgemm (5 ms per (192,27)@(27,192) call) —
    and is what a float32 production engine consumes anyway; the ~1e-6
    relative rounding sits two orders below lambda_min/||K|| = 6e-4 (the
    precision hazard threshold of DESIGN.md §3). K is explicitly
    symmetrized under f32 so CG's SPD contract holds bitwise.
    """
    dim = basis.dim
    gdt = np.float64 if gemm_dtype is None else np.dtype(gemm_dtype)
    Tc = curl_tensor(dim)        # (dim_w, dim, dim)
    Tw = vorticity_curl_tensor(dim)  # (dim, dim_w, dim)
    dim_w = Tc.shape[0]
    eye = np.eye(dim)
    corners = np.asarray(corners, dtype=np.float64)
    if corners.ndim not in (2, 3):
        raise ValueError(
            f"corners must be (n_corners, dim) or (E, n_corners, dim); "
            f"got ndim={corners.ndim} (arbitrary leading batch dims are "
            "not supported by the batched-GEMM forms)")
    batched = corners.ndim == 3
    C = corners if batched else corners[None]
    E = C.shape[0]

    # --- full quadrature: vector Laplacian, Rw, Rd main terms
    Hxy, wdet = _geometry(basis.full, C)       # (E, nq, dim, nn), (E, nq)
    Hxy = Hxy.astype(gdt, copy=False)
    wdet = wdet.astype(gdt, copy=False)
    H = basis.full.H.astype(gdt, copy=False)   # (nq, nn)
    nqf, nn = H.shape
    # scalar Laplacian L[a,b] = sum_{q,d} w Hxy[q,d,a] Hxy[q,d,b]
    Xf = Hxy.reshape(E, nqf * dim, nn)
    L = np.matmul((wdet[:, :, None, None] * Hxy)
                  .reshape(E, nqf * dim, nn).transpose(0, 2, 1), Xf)
    # interleaved K main term by strided slab assignment: the broadcast
    # L[:,:,None,:,None]*eye form materialized an (E, nn, dim, nn, dim)
    # f64 array (2.4 GB at E=1000 ngl=4) + a reshape copy — measured as
    # the dominant unstructured-setup cost (round-5 profile)
    K = np.zeros((E, nn * dim, nn * dim), dtype=gdt)
    Kv = K.reshape(E, nn, dim, nn, dim)
    for c in range(dim):
        Kv[:, :, c, :, c] = L

    # shared full-family mixed form M[a,d,b] = sum_q (w H)[q,a] Hxy[q,d,b]
    # as ONE batched GEMM; downstream consumers read d-slices of the view
    # (einsum's path materialized transposed copies)
    wH = wdet[:, :, None] * H[None]
    Mv = np.matmul(wH.transpose(0, 2, 1),
                   Hxy.reshape(E, nqf, dim * nn)) \
        .reshape(E, nn, dim, nn)               # [e, a, d, b]

    # Rw full: [(a,c),(b,f)] = sum_d Tw[c,f,d] M[a,d,b] — sparse-tensor
    # slab loop instead of a 5-index einsum + interleave copy
    Rw = np.zeros((E, nn * dim, nn * basis.dim_w), dtype=gdt)
    Rwv = Rw.reshape(E, nn, dim, nn, basis.dim_w)
    for c in range(dim):
        for f in range(basis.dim_w):
            for d in range(dim):
                t = float(Tw[c, f, d])
                if t != 0.0:
                    Rwv[:, :, c, :, f] += t * Mv[:, :, d, :]

    # Rd full: [(a,c), b] = -M[a,c,b]
    Rd = np.zeros((E, nn * dim, nn), dtype=gdt)
    Rdv = Rd.reshape(E, nn, dim, nn)
    for c in range(dim):
        Rdv[:, :, c, :] = -Mv[:, :, c, :]

    # --- reduced quadrature penalties
    Hxy_r, wdet_r = _geometry(basis.reduced, C)
    Hxy_r = Hxy_r.astype(gdt, copy=False)
    wdet_r = wdet_r.astype(gdt, copy=False)
    H_r = basis.reduced.H.astype(gdt, copy=False)
    nqr = H_r.shape[0]
    # div penalty: rows/cols directly in interleaved (a*dim + c) order
    Zi = Hxy_r.transpose(0, 1, 3, 2).reshape(E, nqr, nn * dim)
    wZi = wdet_r[:, :, None] * Zi
    K += alpha_d * np.matmul(wZi.transpose(0, 2, 1), Zi)
    # curl penalty: Bc rows (q,w), cols (a,c) interleaved
    Bc = np.einsum('wcd,eqda->eqwac', Tc, Hxy_r, optimize=True)
    Bf = Bc.reshape(E, nqr * dim_w, nn * dim)
    wBf = (wdet_r[:, :, None, None, None] * Bc) \
        .reshape(E, nqr * dim_w, nn * dim)
    K += alpha_w * np.matmul(wBf.transpose(0, 2, 1), Bf)
    # Rw penalty: [(a,c),(b,e)] = sum_q (w Bc)[q,e,a,c] H_r[q,b]
    wBq = (wdet_r[:, :, None, None, None] * Bc).reshape(E, nqr, -1)
    Npen = np.matmul(wBq.transpose(0, 2, 1), H_r) \
        .reshape(E, dim_w, nn, dim, nn)            # [e, w, a, c, b]
    Rwv = Rw.reshape(E, nn, dim, nn, dim_w)
    for w in range(dim_w):
        for c in range(dim):
            Rwv[:, :, c, :, w] += alpha_w * Npen[:, w, :, c, :]
    # Rd penalty: [(a,c), b] = alpha_d sum_q w Hxy_r[q,c,a] H_r[q,b]
    Rd += (alpha_d * np.matmul(wZi.transpose(0, 2, 1), H_r)).astype(
        gdt, copy=False)
    if gdt != np.float64:
        # sgemm A^T B with B = A is not bitwise symmetric; CG assumes SPD
        # (out-of-place: in-place += with a transposed view of self
        # overlaps memory)
        K = gdt.type(0.5) * (K + np.swapaxes(K, -1, -2))

    if not batched:
        K, Rw, Rd = K[0], Rw[0], Rd[0]
    return ElementMatrices(K=K, Rw=Rw, Rd=Rd)


def compute_operators(basis: TensorBasis, corners: np.ndarray,
                      gemm_dtype=None) -> ElementOperators:
    """Nodal SrT/DivSrT/Curl/weights (reference getElemKLEOperators,
    spectral.py:162-228). gemm_dtype as in compute_kle_matrices."""
    dim = basis.dim
    fam = basis.operator
    corners = np.asarray(corners, dtype=np.float64)
    if corners.ndim not in (2, 3):
        raise ValueError(
            f"corners must be (n_corners, dim) or (E, n_corners, dim); "
            f"got ndim={corners.ndim}")
    batched = corners.ndim == 3
    C = corners if batched else corners[None]
    Hxy, wdet = _geometry(fam, C)
    H = fam.H
    Ts = srt_tensor(dim)
    Td = div_srt_tensor(dim)
    Tc = curl_tensor(dim)

    # shared mixed form M[a,d,b] = sum_q (w H)[q,a] Hxy[q,d,b]: ONE batched
    # GEMM feeds all three operators; the interleaved outputs are then
    # built by SPARSE-TENSOR SLAB ASSIGNMENT (loop over the few nonzero
    # T[o,c,d] entries, each a strided (E, nn, nn) write). The previous
    # 5-index einsums + interleave reshapes materialized (E, nn, do, nn,
    # di) f64 intermediates — 2.4-4.7 GB each at E=1000 ngl=4 — and were
    # the dominant unstructured-setup cost (round-5 profile: 20.6 s of
    # einsum + 17.6 s of reshape copies in a 63 s operators phase).
    gdt = np.float64 if gemm_dtype is None else np.dtype(gemm_dtype)
    Hxy = Hxy.astype(gdt, copy=False)
    wdet = wdet.astype(gdt, copy=False)
    H = H.astype(gdt, copy=False)
    E, nq, nn = Hxy.shape[0], Hxy.shape[1], Hxy.shape[3]
    wH = wdet[:, :, None] * H[None]
    Mv = np.matmul(wH.transpose(0, 2, 1),
                   Hxy.reshape(E, nq, dim * nn)) \
        .reshape(E, nn, dim, nn)               # [e, a, d, b]

    def sparse_interleave(T, do):
        """OUT[(a,o),(b,c)] = sum_d T[o,c,d] M[a,d,b] for a sparse T
        of shape (do, dim, dim) indexed [out_comp, in_comp, deriv]."""
        out = np.zeros((E, nn * do, nn * dim), dtype=gdt)
        ov = out.reshape(E, nn, do, nn, dim)
        for o, c, d in zip(*np.nonzero(T)):
            ov[:, :, o, :, c] += float(T[o, c, d]) * Mv[:, :, d, :]
        return out

    SrT = sparse_interleave(Ts, basis.dim_s)
    # DivSrT rows are velocity components, columns strain: T[c, s, d]
    DivSrT = np.zeros((E, nn * dim, nn * basis.dim_s), dtype=gdt)
    dv = DivSrT.reshape(E, nn, dim, nn, basis.dim_s)
    for c, s, d in zip(*np.nonzero(Td)):
        dv[:, :, c, :, s] += float(Td[c, s, d]) * Mv[:, :, d, :]
    Curl = sparse_interleave(Tc, basis.dim_w)
    # partition of unity: row sums of the weight matrix reduce to w_q detJ
    # projected on the nodal basis (spectral.py:225-227)
    weight = wH.sum(axis=1)
    if not batched:
        SrT, DivSrT, Curl, weight = SrT[0], DivSrT[0], Curl[0], weight[0]
    return ElementOperators(SrT=SrT, DivSrT=DivSrT, Curl=Curl, weight=weight)
