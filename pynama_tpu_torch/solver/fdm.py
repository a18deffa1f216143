"""Fast-diagonalization (FDM) preconditioner for the penalized KLE operator.

Port of pynama_tpu/solver/fdm.py. The element KLE operator is
K = L⊗I_dim + α_d·(div penalty) + α_w·(curl penalty) (`elements/kle.py`):
its unpenalized part is the componentwise scalar weak Laplacian S. Every
velocity mode splits into a longitudinal part (div carries the full
gradient energy) and a transverse part (curl does), so the S-preconditioned
spectrum of K collapses into clusters near {1, 1+α_w, 1+α_d}, which CG
resolves in a few iterations each.

S is exactly invertible on a tensor-product box mesh by global fast
diagonalization (Lynch-Rice-Thomas; Deville-Fischer-Mund §4.5): with
per-axis assembled 1D stiffness A_d and mass B_d (same full-quadrature
family as the element K),

    S = A_0⊗B_1⊗B_2 + B_0⊗A_1⊗B_2 + B_0⊗B_1⊗A_2,

and with the generalized eigenbasis A_d Q_d = B_d Q_d Λ_d (Q_dᵀB_dQ_d = I)

    S⁻¹ = (Q_0⊗Q_1⊗Q_2) · diag(λ_i+λ_j+λ_k)⁻¹ · (Q_0ᵀ⊗Q_1ᵀ⊗Q_2ᵀ).

Dirichlet condensation stays exact whenever the per-component free mask is
a tensor product of per-axis 1D masks (every whole-wall configuration);
otherwise the largest contained tensor mask is used and the few leftover
free dofs get Jacobi.

Setup (`build_fdm`) is host numpy float64, as in the reference. The apply
(`fdm_apply`) has two routes:

- on a CUDA tensor with the box layout (`nelem`, `ngl` given), three
  launches of the hand-written kernels of `csrc/fdm_apply.cu` (built into
  the kernels' library by `ops/_build.py`): a forward plane pass (Q2ᵀ,
  Q1ᵀ of each axis-0 plane, read straight from the element-local vector),
  a pencil pass (Q0ᵀ, the per-mode (c, c) block, Q0 along axis 0, in
  place) and a backward plane pass (Q1, Q2, the Jacobi leftover term,
  written to every slot of each node), through one scratch grid; a shape
  they do not take raises, there is no fallback;
- otherwise the plain PyTorch version `fdm_apply_ref`: 2·dim batched
  matmuls (full float32 under the precision pins of `config.py`, never
  TF32), the per-mode (c, c) blocks as a broadcast multiply and sum, and
  the grid<->local reshapes and copies; the gather path (no `nelem`) on
  any device.

The slab form for sharded runs (`SlabFDM`, `shard_fdm`, `_contract_axis`,
`fdm_apply_slab`): on one rank's axis-0 slab the local axes 1..d-1
transform as before, the axis-0 analysis is an ownership-weighted partial
projection psum-reduced to the whole mode grid (one psum per
application), and the axis-0 synthesis gives the slab's own rows from the
replicated modes with no communication.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import weakref

import numpy as np
import torch

from pynama_tpu_torch.basis.lagrange import lagrange_basis
from pynama_tpu_torch.basis.quadrature import gauss_points, lobatto_points

logger = logging.getLogger("pynama_tpu_torch.fdm")


@dataclasses.dataclass(frozen=True)
class FDMOps:
    """Everything one masked-system FDM application needs."""
    #: per-axis stacked eigenbases, (ncomp, n1d_d, n1d_d); columns beyond
    #: the free-subspace dimension are zero
    Qs: tuple
    #: per-mode (ncomp, ncomp) inverse blocks of the exact mode-block-
    #: diagonal of the transformed operator (the per-component eigenvalue
    #: sums plus the cross-component penalty coupling), (ncomp, ncomp) + npts
    binv: torch.Tensor
    #: representative element slot of each global node, (n_nodes,) into
    #: E*nn; host numpy, read by the gather path only
    rep_rows: np.ndarray
    #: (E, nn) global node id per element slot (the gather path's scatter-
    #: back); host numpy
    cell_nodes: np.ndarray
    #: Jacobi coefficients (leftover_mask / K_diag) for the few free dofs
    #: outside the largest contained tensor mask, (n_nodes, c)
    jleft: torch.Tensor
    npts: tuple
    ncomp: int


def _assemble_1d(ngl: int, ne: int, mat_e: np.ndarray) -> np.ndarray:
    n1d = ne * (ngl - 1) + 1
    M = np.zeros((n1d, n1d))
    for e in range(ne):
        s = e * (ngl - 1)
        M[s:s + ngl, s:s + ngl] += mat_e
    return M


def _axis_matrices_1d(ngl: int, length: float, ne: int):
    """Assembled global 1D matrices for one mesh axis: (A, B, Ar, Br) =
    full-quadrature stiffness/mass (same family as the element K: Gauss if
    ngl<=3 else GLL, `basis/tables.py make_tensor_basis`) and
    reduced-quadrature (Gauss(ngl-1)) stiffness/mass, the 1D factors of the
    div/curl penalty blocks."""
    nodes1d, _ = lobatto_points(ngl)
    if ngl <= 3:
        q1, w1 = gauss_points(ngl)
    else:
        q1, w1 = lobatto_points(ngl)
    he = length / ne

    def pair(q, w):
        h, dh = lagrange_basis(nodes1d, q)       # (nq, ngl)
        A_e = (2.0 / he) * (dh.T @ (w[:, None] * dh))
        B_e = (he / 2.0) * (h.T @ (w[:, None] * h))
        return _assemble_1d(ngl, ne, A_e), _assemble_1d(ngl, ne, B_e)

    A, B = pair(q1, w1)
    qr, wr = gauss_points(ngl - 1)
    Ar, Br = pair(qr, wr)
    # mixed reduced-quadrature factor D̃ᵀW H̃ (the 1D piece of the CROSS-
    # component penalty blocks): physical scales cancel, (2/he)(he/2) = 1
    h, dh = lagrange_basis(nodes1d, qr)
    C_e = dh.T @ (wr[:, None] * h)
    Cr = _assemble_1d(ngl, ne, C_e)
    return A, B, Ar, Br, Cr


def _gen_eigh(A: np.ndarray, B: np.ndarray):
    """Generalized symmetric eig A q = λ B q with qᵀBq = I (numpy-only)."""
    L = np.linalg.cholesky(B)
    Linv = np.linalg.inv(L)
    lam, Y = np.linalg.eigh(Linv @ A @ Linv.T)
    return lam, Linv.T @ Y


def _axis_free_masks(mask_c: np.ndarray, npts: tuple):
    """Largest per-axis-factorable (tensor-product) free mask CONTAINED in
    one component's node mask, plus the leftover free dofs it misses.

    Starting from the covering ("any free in plane") factors, refine each
    axis to "free everywhere the other factors expect free" until a
    fixpoint. Containment matters: a too-large tensor mask frees whole wall
    lines (the FS-stage corner rule frees corner dofs only), turning the 1D
    eigenproblem Neumann and poisoning the denominators with near-zero
    modes. The leftover dofs (isolated corners) get Jacobi instead."""
    m = mask_c.reshape(npts)
    dim = len(npts)
    factors = [np.moveaxis(m, d, 0).reshape(npts[d], -1).any(axis=1)
               for d in range(dim)]
    for _ in range(dim + 1):
        changed = False
        for d in range(dim):
            others = [factors[e] for e in range(dim) if e != d]
            sel = functools.reduce(np.multiply.outer, others) \
                if others else np.ones((), bool)
            md = np.moveaxis(m, d, 0).reshape(npts[d], -1)
            new = (md | ~sel.reshape(-1)[None, :]).all(axis=1) & factors[d]
            changed |= bool((new != factors[d]).any())
            factors[d] = new
        if not changed:
            break
    outer = functools.reduce(np.multiply.outer, factors)
    leftover = m & ~outer
    return factors, leftover.reshape(-1)


def build_fdm(mesh, free_mask_np: np.ndarray, *, device, dtype,
              diag_global: np.ndarray | None = None) -> FDMOps | None:
    """FDM data for one masked system; None when the mesh has no tensor
    structure. free_mask_np: (n_nodes, dim) bool/float free-dof mask.

    The denominator is the EXACT diagonal of the eigenbasis-transformed
    operator QᵀKQ ("Jacobi in the FDM eigenbasis"): the stiffness part is
    Λ_0⊕Λ_1⊕Λ_2 by construction, and each penalty diagonal block is a
    Kronecker product of reduced-quadrature 1D matrices, so its transformed
    diagonal is the Kronecker product of per-axis diagonals
    diag(QᵀÃᵣQ)/diag(QᵀB̃ᵣQ). Without the penalty terms the FS-stage mask
    (tangential wall dofs free) leaves S with near-null wall-constant modes
    that K penalizes heavily (1325 CG iterations against Jacobi's 521 in
    the JAX package's measurement, docs/DESIGN.md §4); with them the same
    solve drops to a small fraction.

    The arrays go to `device` in `dtype`; setup stays numpy float64."""
    if not getattr(mesh, "is_box", False):
        return None
    from pynama_tpu_torch.elements.kle import ALPHA_D as ad, ALPHA_W as aw
    dim, ngl = mesh.dim, mesh.ngl
    npts = tuple(mesh.npts)
    free = np.asarray(free_mask_np).astype(bool).reshape(mesh.n_nodes, dim)

    AB = [_axis_matrices_1d(ngl, mesh.upper[d] - mesh.lower[d],
                            mesh.nelem[d]) for d in range(dim)]

    Qs = [np.zeros((dim, npts[d], npts[d])) for d in range(dim)]
    lams = [np.ones((dim, npts[d])) for d in range(dim)]   # stiffness eigs
    gds = [np.zeros((dim, npts[d])) for d in range(dim)]   # diag QᵀÃᵣQ
    mrs = [np.zeros((dim, npts[d])) for d in range(dim)]   # diag QᵀB̃ᵣQ
    jleft = np.zeros((mesh.n_nodes, dim))
    for c in range(dim):
        factors, leftover = _axis_free_masks(free[:, c], npts)
        if leftover.any():
            logger.info("FDM: component %d free mask is not a tensor "
                        "product; %d leftover dofs get Jacobi",
                        c, int(leftover.sum()))
            if diag_global is None:
                return None
            jleft[:, c] = leftover / np.asarray(diag_global)[:, c]
        for d in range(dim):
            f = np.where(factors[d])[0]
            if f.size == 0:
                return None     # degenerate: nothing free along an axis
            A, B, Ar, Br, _Cr = AB[d]
            lam, Q = _gen_eigh(A[np.ix_(f, f)], B[np.ix_(f, f)])
            lam = np.maximum(lam, 0.0)
            Qs[d][c][np.ix_(f, np.arange(f.size))] = Q
            lams[d][c, :f.size] = lam
            lams[d][c, f.size:] = 1.0   # padded slots (zero Q columns)
            gds[d][c, :f.size] = np.einsum(
                "if,ij,jf->f", Q, Ar[np.ix_(f, f)], Q)
            mrs[d][c, :f.size] = np.einsum(
                "if,ij,jf->f", Q, Br[np.ix_(f, f)], Q)

    # denom[c, modes] = sum_d lam + ad*div-diag + aw*curl-diag
    grids = np.meshgrid(*[np.arange(n) for n in npts], indexing="ij")
    dsum = np.zeros((dim,) + npts)
    for c in range(dim):
        lam_sum = np.zeros(npts)
        for d in range(dim):
            lam_sum = lam_sum + lams[d][c][grids[d]]

        def pen_term(deriv_axis):
            # Ãᵣ along deriv_axis, B̃ᵣ along the others
            acc = np.ones(npts)
            for e in range(dim):
                v = gds[e][c] if e == deriv_axis else mrs[e][c]
                acc = acc * v[grids[e]]
            return acc

        pen = ad * pen_term(c)                     # div diag block (c,c)
        for d in range(dim):
            if d != c:
                pen = pen + aw * pen_term(d)       # curl diag block (c,c)
        dsum[c] = np.maximum(lam_sum + pen,
                             1e-12 * max(float(lam_sum.max()), 1.0))

    # exact per-mode (dim x dim) block diagonal of the transformed operator:
    # since diag(A (x) B) = diag(A) (x) diag(B), the mode-diagonal of every
    # cross-component penalty block ⊗_e Q_cᵀ X_e Q_c' is the product of
    # per-axis diagonals diag(Q_c,eᵀ X_e Q_c',e). A scalar 1/dsum drops
    # these cross entries — exactly the mode-off-diagonal coupling that made
    # the FS stage need 3x the main stage's iterations (docs/DESIGN.md §4).
    # The block diagonal of an SPD congruence is SPD; eigenvalue clipping
    # below guards the padded/rounded modes.
    def cross_diag(c, c2, d, X):
        return np.einsum("im,ij,jm->m", Qs[d][c], X, Qs[d][c2])

    Bmat = np.zeros((dim, dim) + npts)
    for c in range(dim):
        Bmat[c, c] = dsum[c]
    for c in range(dim):
        for c2 in range(c + 1, dim):
            div_f = np.ones(npts)
            curl_f = np.ones(npts)
            for e in range(dim):
                _, _, _, Br, Cr = AB[e]
                Xd = Cr if e == c else (Cr.T if e == c2 else Br)
                Xw = Cr if e == c2 else (Cr.T if e == c else Br)
                div_f = div_f * cross_diag(c, c2, e, Xd)[grids[e]]
                curl_f = curl_f * cross_diag(c, c2, e, Xw)[grids[e]]
            off = ad * div_f - aw * curl_f
            Bmat[c, c2] = off
            Bmat[c2, c] = off
    Bb = np.moveaxis(Bmat.reshape(dim, dim, -1), -1, 0)  # (n, c, c)
    Bb = 0.5 * (Bb + np.swapaxes(Bb, 1, 2))
    lam_b, V = np.linalg.eigh(Bb)
    floor = 1e-10 * np.maximum(lam_b.max(axis=1, keepdims=True), 1.0)
    lam_b = np.maximum(lam_b, floor)
    Binv = np.einsum("nck,nk,ndk->ncd", V, 1.0 / lam_b, V)
    binv = np.moveaxis(Binv, 0, -1).reshape((dim, dim) + npts)

    # contiguous, as the kernels of fdm_apply read them
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    return FDMOps(
        Qs=tuple(f(q) for q in Qs), binv=f(binv),
        rep_rows=np.asarray(mesh.incidence)[:, 0].astype(np.int64),
        cell_nodes=np.asarray(mesh.cell_nodes, dtype=np.int64),
        jleft=f(jleft), npts=npts, ncomp=dim)


# --------------------------------------------------------------------- apply
def _merge_axis(g: torch.Tensor, axis: int, ne: int, N: int) -> torch.Tensor:
    """Collapse an (..., ne, N, ...) overlapping-window pair into the global
    (..., ne*(N-1)+1, ...) axis by picking (consistent data: duplicated
    interface slots are equal). Slices and one concatenation, no gather."""
    lead, trail = g.shape[:axis], g.shape[axis + 2:]
    sl = [slice(None)] * g.ndim
    sl[axis + 1] = slice(0, N - 1)
    body = g[tuple(sl)].reshape(lead + (ne * (N - 1),) + trail)
    sl[axis] = slice(ne - 1, ne)
    sl[axis + 1] = slice(N - 1, N)
    last = g[tuple(sl)].reshape(lead + (1,) + trail)
    return torch.cat([body, last], dim=axis)


def _split_axis(g: torch.Tensor, axis: int, ne: int, N: int) -> torch.Tensor:
    """Inverse of _merge_axis: (..., np_ax, ...) -> (..., ne, N, ...)
    overlapping length-N windows with stride N-1 (strided slices)."""
    lead, trail = g.shape[:axis], g.shape[axis + 1:]
    sl = [slice(None)] * g.ndim
    sl[axis] = slice(0, ne * (N - 1))
    body = g[tuple(sl)].reshape(lead + (ne, N - 1) + trail)
    sl[axis] = slice(N - 1, None, N - 1)
    last = g[tuple(sl)].reshape(lead + (ne, 1) + trail)
    return torch.cat([body, last], dim=axis + 1)


def _local_to_grid(r_loc: torch.Tensor, nelem: tuple, N: int,
                   c: int) -> torch.Tensor:
    """(E, nn*c) consistent canonical local vector -> global grid
    (np0[, np1, np2], c) by slices and reshapes (no gather)."""
    dim = len(nelem)
    g = r_loc.reshape(tuple(nelem) + (N,) * dim + (c,))
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    g = g.permute(perm + [2 * dim])            # (e0, N, e1, N[, e2, N], c)
    for d in range(dim):
        # merging pair d shifts later (ne, N) pairs left; the d-th
        # remaining pair always sits at axis position d
        g = _merge_axis(g, d, nelem[d], N)
    return g


def _grid_to_local(z: torch.Tensor, nelem: tuple, N: int,
                   c: int) -> torch.Tensor:
    """Global grid (np0[, np1, np2], c) -> (E, nn*c) canonical local."""
    dim = len(nelem)
    for d in range(dim - 1, -1, -1):
        z = _split_axis(z, d, nelem[d], N)
    perm = tuple(2 * d for d in range(dim)) \
        + tuple(2 * d + 1 for d in range(dim)) + (2 * dim,)
    z = z.permute(perm)
    E = int(np.prod(nelem))
    return z.reshape(E, N**dim * c)


def _transform_chain(Qs, z: torch.Tensor, transpose_q: bool) -> torch.Tensor:
    """Apply the per-axis transforms to z (c, np0[, np1, np2]).

    Each step is a batched matmul contracting the axis at position 1 (a
    large trailing flat axis), then that axis rolls to the back. After
    `dim` rolls the layout is (c, np0[, np1, np2]) again with every axis
    transformed."""
    dim = z.ndim - 1
    for d in range(dim):
        Q = Qs[d]                                   # (c, n1d, n1d)
        Qm = Q.transpose(1, 2) if transpose_q else Q
        sh = z.shape
        z = torch.matmul(Qm, z.reshape(sh[0], sh[1], -1)).reshape(sh)
        if dim > 1:
            z = torch.movedim(z, 1, -1)             # roll: next axis to pos 1
    return z


def fdm_apply_ref(f: FDMOps, r_loc: torch.Tensor,
                  nelem: tuple | None = None,
                  ngl: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of `fdm_apply` (its route on the CPU and
    on the gather path): z = S⁻¹ r on a consistent element-local vector
    (E, nn*ncomp); the result is consistent (global values duplicated into
    every slot).

    With (nelem, ngl) given the grid<->local conversions are strided
    slices (the engine's path); otherwise they are index gathers through
    `rep_rows` and `cell_nodes`, copied to r_loc's device on each call."""
    E, nnc = r_loc.shape
    c = f.ncomp
    if nelem is not None:
        z = _local_to_grid(r_loc, nelem, ngl, c)
    else:
        rows = torch.as_tensor(f.rep_rows, device=r_loc.device)
        g = r_loc.reshape(E * (nnc // c), c)[rows]      # (n_nodes, c)
        z = g.reshape(f.npts + (c,))
    z = torch.movedim(z, -1, 0)                     # (c, np0[, np1, np2])
    g0 = z
    csh = (c,) + f.npts
    z = _transform_chain(f.Qs, z, transpose_q=True)     # analysis (Qᵀ)
    # per-mode (c, c) blocks as a broadcast multiply and sum: einsum lowers
    # this to a batched cuBLAS gemv (chip_smoke.py's fdm phase times both)
    z = (f.binv * z.unsqueeze(0)).sum(dim=1)
    z = _transform_chain(f.Qs, z, transpose_q=False)    # synthesis (Q)
    z = z + f.jleft.T.reshape(csh) * g0
    z = torch.movedim(z, 0, -1)                     # back to (np..., c)
    if nelem is not None:
        return _grid_to_local(z, nelem, ngl, c)
    nodes = torch.as_tensor(f.cell_nodes, device=r_loc.device)
    out = z.reshape(-1, c)[nodes]                   # (E, nn, c)
    return out.reshape(E, nnc)


# ------------------------------------------------------------- the kernels
class _Args(ctypes.Structure):
    """csrc/fdm_apply.cu's Args, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "r", "out", "g", "q0", "q1", "q2", "binv", "jleft", "stream")] + [
        ("f64", ctypes.c_int), ("c", ctypes.c_int),
        ("np", ctypes.c_int * 3), ("ne", ctypes.c_int * 3),
        ("nl", ctypes.c_int * 3), ("pad", ctypes.c_int)]


#: kernel_plan's keys, in pn_fdm_plan's order
PLAN_KEYS = ("wa", "ka", "pb", "kb", "ec", "kc", "smem_a", "smem_b",
             "smem_c")


def kernel_plan(np3: tuple, ne3: tuple, nl3: tuple, c: int,
                esize: int) -> dict:
    """The tiles csrc/fdm_apply.cu's make_plan picks for a box of ne3
    elements of nl3 nodes per axis, np3 = (np0, np1, np2) grid nodes (axis
    1 one node wide in 2D), c components of esize bytes (needs nvcc;
    launches nothing): pass A's axis-2 modes and k-chunk a CTA (wa, ka),
    pass B's pencils and k-chunk (pb, kb), pass C's elements along axis 2
    and k-chunk (ec, kc), and each pass's shared memory in bytes. Raise
    where the kernels do not take the box."""
    from pynama_tpu_torch.ops._build import load_library
    a = _Args(f64=int(esize == 8), c=c)
    a.np[:], a.ne[:], a.nl[:] = np3, ne3, nl3
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if load_library().pn_fdm_plan(ctypes.addressof(a), out) != 0:
        raise ValueError(f"fdm_apply's kernels: no plan for the box {np3} "
                         f"of {c} components of {esize} bytes")
    return dict(zip(PLAN_KEYS, out))


def box3(f: FDMOps, nelem: tuple, ngl: int):
    """The kernels' 3D box of f's grid: (np, ne, nl) per axis, axis 1 one
    node wide in 2D; raise unless nelem and ngl give f's npts."""
    nelem = tuple(int(n) for n in nelem)
    if len(nelem) != len(f.npts) or f.npts != tuple(
            n * (ngl - 1) + 1 for n in nelem):
        raise ValueError(f"fdm_apply: nelem {nelem}, ngl {ngl} do not give "
                         f"the FDMOps' npts {f.npts}")
    if len(nelem) == 3:
        return f.npts, nelem, (ngl,) * 3
    return ((f.npts[0], 1, f.npts[1]), (nelem[0], 1, nelem[1]),
            (ngl, 1, ngl))


def check_input(f: FDMOps, r_loc: torch.Tensor, nelem: tuple,
                ngl: int) -> None:
    """Raise unless r_loc is a contiguous (E, ngl^dim·c) tensor of f's
    dtype on f's device, for the box (nelem, ngl) of f's grid."""
    if not isinstance(r_loc, torch.Tensor):
        raise TypeError("fdm_apply takes a torch tensor")
    if r_loc.dtype != f.binv.dtype:
        raise TypeError(f"fdm_apply: r is {r_loc.dtype}, the FDMOps "
                        f"{f.binv.dtype}")
    if r_loc.device != f.binv.device:
        raise ValueError(f"fdm_apply: r on {r_loc.device}, the FDMOps on "
                         f"{f.binv.device}")
    box3(f, nelem, ngl)
    shape = (int(np.prod(nelem)), ngl ** len(nelem) * f.ncomp)
    if tuple(r_loc.shape) != shape or not r_loc.is_contiguous():
        raise ValueError(f"fdm_apply: r must be a contiguous {shape} "
                         f"tensor, got {tuple(r_loc.shape)}"
                         f"{'' if r_loc.is_contiguous() else ' (strided)'}")


#: the kernels' argument block of each FDMOps that has run on a card, by
#: id: ((nelem, ngl) it was bound for, the block, r's shape, the scratch
#: grid's length); bound at its first CUDA call and dropped when the
#: FDMOps is collected
_BLOCKS = {}


def _bind(f: FDMOps, nelem: tuple, ngl: int):
    """The _BLOCKS entry of f's apply on the box (nelem, ngl)."""
    from pynama_tpu_torch.ops._build import ArgBlock
    dt = f.binv.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fdm_apply's kernels take float32 or float64, not "
                        f"{dt}")
    if not 2 <= f.ncomp <= 3:
        raise ValueError(f"fdm_apply's kernels take 2 or 3 components, not "
                         f"{f.ncomp}")
    np3, ne3, nl3 = box3(f, nelem, ngl)
    for name, a in [("binv", f.binv), ("jleft", f.jleft)] + [
            (f"Qs[{d}]", q) for d, q in enumerate(f.Qs)]:
        if a.dtype != dt or a.device != f.binv.device \
                or not a.is_contiguous():
            raise ValueError(f"FDMOps.{name}: a contiguous {dt} tensor on "
                             f"{f.binv.device}")
    # in 2D axis 1 is one node wide, its eigenbasis [1]
    q0, q1, q2 = (f.Qs[0], f.Qs[1], f.Qs[2]) if len(f.Qs) == 3 \
        else (f.Qs[0], torch.ones((f.ncomp, 1, 1), dtype=dt,
                                  device=f.binv.device), f.Qs[1])
    kernel_plan(np3, ne3, nl3, f.ncomp, f.binv.element_size())  # raises
    a = _Args(q0=q0.data_ptr(), q1=q1.data_ptr(), q2=q2.data_ptr(),
              binv=f.binv.data_ptr(),
              jleft=f.jleft.data_ptr() if bool(f.jleft.ne(0).any())
              else None,
              f64=int(dt == torch.float64), c=f.ncomp)
    a.np[:], a.ne[:], a.nl[:] = np3, ne3, nl3
    block = ArgBlock(a, f.binv.device, "pn_fdm_apply")
    block.q1 = q1                   # the block holds its address
    shape = torch.Size((int(np.prod(nelem)), ngl ** len(nelem) * f.ncomp))
    entry = _BLOCKS[id(f)] = ((tuple(nelem), ngl), block, shape,
                              f.ncomp * int(np.prod(f.npts)))
    weakref.finalize(f, _BLOCKS.pop, id(f), None)
    return entry


def fdm_apply(f: FDMOps, r_loc: torch.Tensor, nelem: tuple | None = None,
              ngl: int | None = None) -> torch.Tensor:
    """z = S⁻¹ r on a consistent element-local vector (E, nn*ncomp); the
    result is consistent (global values duplicated into every slot).

    On a CUDA tensor with (nelem, ngl) given: three launches of
    csrc/fdm_apply.cu on the current stream, through a scratch grid taken
    from the caching allocator per call; r_loc must be a contiguous tensor
    of f's dtype and device. Otherwise `fdm_apply_ref`."""
    if nelem is None or r_loc.device.type != "cuda":
        return fdm_apply_ref(f, r_loc, nelem, ngl)
    entry = _BLOCKS.get(id(f))
    if entry is None or entry[0] != (tuple(nelem), ngl):
        check_input(f, r_loc, nelem, ngl)
        entry = _bind(f, nelem, ngl)
    _, block, shape, ngrid = entry
    if r_loc.shape != shape or r_loc.dtype != f.binv.dtype \
            or r_loc.device != f.binv.device or not r_loc.is_contiguous():
        check_input(f, r_loc, nelem, ngl)           # raises: the reason
    out = torch.empty_like(r_loc)
    g = torch.empty(ngrid, dtype=r_loc.dtype, device=r_loc.device)
    a = block.args
    a.r, a.out, a.g = r_loc.data_ptr(), out.data_ptr(), g.data_ptr()
    # this call's stream: a CUDA graph capture runs on a stream of its own
    a.stream = torch.cuda.current_stream(r_loc.device).cuda_stream
    block.launch("pn_fdm_apply")
    fdm_apply.launches += 3
    return out


#: kernel launches of this process (CPU calls do not count)
fdm_apply.launches = 0


# ------------------------------------------------------------- slab form
@dataclasses.dataclass(frozen=True)
class SlabFDM:
    """One rank's slab of an FDMOps (axis-0 slabs, as
    `parallel/sharded_engine.py` splits the mesh).

    The global transform chain factorizes per rank: the local axes (1..d-1)
    are untouched by the split, and the axis-0 analysis becomes an
    ownership-weighted partial projection `Q0_ownᵀ · z_slab`, psum-reduced
    to the full mode grid, while the axis-0 synthesis needs no
    communication (each rank computes its own slab rows `Q0_syn · ẑ` from
    the replicated mode tensor, so the duplicated interface plane comes
    out bitwise the same on both of its ranks)."""
    #: (c, k+1, n0) ownership rows of Q0 (the interface plane shared with
    #: the next rank zeroed: that rank owns it)
    Q0_own: torch.Tensor
    #: (c, k+1, n0) slab rows of Q0 (both interface planes kept)
    Q0_syn: torch.Tensor
    #: local-axis eigenbases, each (c, n_d, n_d)
    Qs_rest: tuple
    #: the replicated per-mode inverse blocks, (c, c, n0[, n1, n2])
    binv: torch.Tensor
    #: the slab's rows of the Jacobi-leftover coefficients, (slab_nodes, c)
    jleft: torch.Tensor
    ncomp: int


def shard_fdm(f: FDMOps, ndev: int, rank: int) -> SlabFDM:
    """Rank `rank`'s SlabFDM of `f` split into `ndev` axis-0 slabs, on f's
    device."""
    npts = f.npts
    c = f.ncomp
    n0 = npts[0]
    if (n0 - 1) % ndev != 0:
        raise ValueError(f"axis-0 planes {n0 - 1} not divisible by {ndev}")
    k = (n0 - 1) // ndev
    rows = slice(rank * k, rank * k + k + 1)
    Q0 = f.Qs[0]                                    # (c, n0, n0)
    syn = Q0[:, rows, :].clone()
    own = syn.clone()
    if rank != ndev - 1:
        own[:, -1, :] = 0.0                         # the next rank owns it
    jleft = f.jleft.reshape(npts + (c,))[rows].reshape(-1, c)
    return SlabFDM(Q0_own=own, Q0_syn=syn, Qs_rest=tuple(f.Qs[1:]),
                   binv=f.binv, jleft=jleft.contiguous(), ncomp=c)


def slab_fdm_arrays(s: SlabFDM) -> dict:
    """A SlabFDM's tensors as host numpy arrays (`Qs_rest` as Qs_rest.0,
    Qs_rest.1, ...), for `slab_fdm_from_arrays` on another process."""
    out = {k: getattr(s, k).cpu().numpy()
           for k in ("Q0_own", "Q0_syn", "binv", "jleft")}
    for i, q in enumerate(s.Qs_rest):
        out[f"Qs_rest.{i}"] = q.cpu().numpy()
    out["ncomp"] = s.ncomp
    return out


def slab_fdm_from_arrays(a: dict, *, device, dtype) -> SlabFDM:
    """The SlabFDM `slab_fdm_arrays` took apart, on `device` in `dtype`."""
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    n_rest = sum(1 for k in a if k.startswith("Qs_rest."))
    return SlabFDM(Q0_own=f(a["Q0_own"]), Q0_syn=f(a["Q0_syn"]),
                   Qs_rest=tuple(f(a[f"Qs_rest.{i}"])
                                 for i in range(n_rest)),
                   binv=f(a["binv"]), jleft=f(a["jleft"]),
                   ncomp=int(a["ncomp"]))


def _contract_axis(Q: torch.Tensor, z: torch.Tensor, pos: int,
                   transpose_q: bool) -> torch.Tensor:
    """Contract z's axis `pos` with Q (c, n, n); z leads with the component
    axis."""
    z = torch.movedim(z, pos, 1)
    Qm = Q.transpose(1, 2) if transpose_q else Q
    sh = z.shape
    z = torch.matmul(Qm, z.reshape(sh[0], sh[1], -1)).reshape(sh)
    return torch.movedim(z, 1, pos)


def fdm_apply_slab(f: SlabFDM, r_loc: torch.Tensor, nelem: tuple, ngl: int,
                   comm) -> torch.Tensor:
    """Sharded z = S⁻¹ r on one rank's consistent slab-local vector
    (E_loc, nn*ncomp); `nelem` is the slab's. Exactly one psum (of the mode
    grid) per application."""
    c = f.ncomp
    z = _local_to_grid(r_loc, nelem, ngl, c)        # (k+1, n1[, n2], c)
    z = torch.movedim(z, -1, 0)                     # (c, k+1, ...)
    g0 = z
    # analysis on the unsplit local axes first (slab-sized work)
    for i, Q in enumerate(f.Qs_rest):
        z = _contract_axis(Q, z, i + 2, transpose_q=True)
    # axis-0 ownership partial projection, reduced to the full mode grid
    sh = z.shape
    zh = torch.matmul(f.Q0_own.transpose(1, 2), z.reshape(c, sh[1], -1))
    zh = comm.psum(zh)                              # (c, n0, rest)
    zh = zh.reshape(f.binv.shape[1:])
    zh = (f.binv * zh.unsqueeze(0)).sum(dim=1)
    # synthesis: the slab's rows from the replicated modes, local axes
    z = torch.matmul(f.Q0_syn, zh.reshape(c, zh.shape[1], -1)).reshape(sh)
    for i, Q in enumerate(f.Qs_rest):
        z = _contract_axis(Q, z, i + 2, transpose_q=False)
    z = z + f.jleft.T.reshape(g0.shape) * g0
    z = torch.movedim(z, 0, -1)
    return _grid_to_local(z, nelem, ngl, c)
