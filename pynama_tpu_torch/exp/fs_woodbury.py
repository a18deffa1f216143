"""Woodbury in quadrature space for the FS-stage floor, on the device (port
of the JAX package's exp/fs_woodbury.py).

The penalized operator is K = S + B^T B with S the unpenalized separable
vector Laplacian (FDM-exactly invertible on the FS tensor mask) and
B = [sqrt(a_d w_q) D; sqrt(a_w w_q) C] the REDUCED-quadrature div/curl
evaluation maps. Woodbury:

    K^-1 = S^-1 - S^-1 B^T G^-1 B S^-1,   G = I_m + B S^-1 B^T.

The nonzero spectrum of B S^-1 B^T equals that of S^-1 B^T B, so plain CG
on G converges exactly like S^-1-preconditioned CG on K. The question:
does a DIAGONAL scaling in QUADRATURE space cluster G where no
velocity-space diagonal could cluster K? It measures the spectra of G and
diag(G)^-1 G and ACTUAL preconditioned-CG iteration counts (not kappa
bounds) at rtol 1e-6: K/Jacobi, K/S^-1, G/I, G/diag, and G under exact
inverses of its per-quadrature-point (1 + dim_w) blocks and of its
per-element blocks.

S and B are assembled in host numpy (the setup rule: `elements/kle.py`'s
`compute_kle_matrices` with the penalties off, and `_geometry`,
`curl_tensor`, `ALPHA_D`, `ALPHA_W` for B) and go to the device; the
inverse, G, its eigenvalues and the CG runs are there (float64 by
default). `pcg_dense` keeps `pcg_np`'s semantics: the residual norm is
checked (one host read) before each iteration. The right-hand sides come
from numpy's default_rng(0) in the JAX script's order.

    python -m pynama_tpu_torch.exp.fs_woodbury [ne ...] [--device cuda]
        [--dtype float64]

Sizes default to 3 4. Each size prints the JAX script's lines, then one
JSON line with every number, the wall seconds and the device's peak
memory.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from pynama_tpu_torch.elements.kle import (ALPHA_D, ALPHA_W, _geometry,
                                           compute_kle_matrices,
                                           curl_tensor)
from pynama_tpu_torch.exp import analysis_main
from pynama_tpu_torch.exp.fs_spectrum import (assemble_dense,
                                              assemble_global_K,
                                              element_dofs, problem)


def assemble_S(p) -> np.ndarray:
    """Global unpenalized vector Laplacian (alphas = 0), host numpy."""
    corners = p.mesh.cell_corners[0] if p.mesh.is_uniform \
        else p.mesh.cell_corners
    em = compute_kle_matrices(p.basis, corners, alpha_w=0.0, alpha_d=0.0)
    return assemble_dense(p.mesh, np.asarray(em.K, dtype=np.float64))


def build_B(p) -> np.ndarray:
    """Global (m, n) penalty factor, host numpy: rows = sqrt(a w_q detJ) x
    reduced-quadrature div/curl evaluations (the penalty blocks of
    elements/kle.py's compute_kle_matrices)."""
    mesh, basis = p.mesh, p.basis
    dim = mesh.dim
    Tc = curl_tensor(dim)
    dim_w = Tc.shape[0]
    corners = np.asarray(mesh.cell_corners, dtype=np.float64)
    if corners.ndim == 2:
        corners = np.broadcast_to(corners[None], (mesh.n_cells,) +
                                  corners.shape)
    Hxy_r, wdet_r = _geometry(basis.reduced, corners)   # (E,nq,dim,nn),(E,nq)
    E, nqr, _, nn = Hxy_r.shape
    Zi = Hxy_r.transpose(0, 1, 3, 2).reshape(E, nqr, nn * dim)
    Bc = np.einsum('wcd,eqda->eqwac', Tc, Hxy_r,
                   optimize=True).reshape(E, nqr, dim_w, nn * dim)
    sw = np.sqrt(wdet_r)
    rows_d = np.sqrt(ALPHA_D) * sw[:, :, None] * Zi         # (E,nq,nnd)
    rows_c = np.sqrt(ALPHA_W) * sw[:, :, None, None] * Bc   # (E,nq,w,nnd)
    n = mesh.n_nodes * dim
    dof = element_dofs(mesh)
    m_per = nqr * (1 + dim_w)
    B = np.zeros((E * m_per, n))
    for e in range(E):
        re = np.concatenate([rows_d[e], rows_c[e].reshape(nqr * dim_w, -1)])
        B[e * m_per:(e + 1) * m_per, dof[e]] = re
    return B


def pcg_dense(A, b: torch.Tensor, Minv=None, rtol=1e-6, maxiter=4000):
    """Preconditioned CG on device tensors with `pcg_np`'s semantics: A a
    matrix or a function, Minv a function or None; the residual norm is
    checked before each iteration. Returns (x, iterations)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = Minv(r) if Minv else r.clone()
    p = z.clone()
    gamma = r @ z
    bnorm = float(torch.linalg.norm(b))
    for k in range(maxiter):
        if float(torch.linalg.norm(r)) <= rtol * bnorm:
            return x, k
        Ap = A @ p if isinstance(A, torch.Tensor) else A(p)
        alpha = gamma / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = Minv(r) if Minv else r.clone()
        g2 = r @ z
        p = z + (g2 / gamma) * p
        gamma = g2
    return x, maxiter


def block_prec(G: torch.Tensor, bs: int, perm=None):
    """Exact inverse of G's (bs x bs) diagonal blocks (optionally after a
    row permutation grouping related rows together), as a function."""
    if perm is not None:
        perm = torch.as_tensor(perm, device=G.device)
    Gp = G if perm is None else G[perm][:, perm]
    m = Gp.shape[0]
    blocks = Gp.reshape(m // bs, bs, m // bs, bs)
    diagb = torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)
    binv = torch.linalg.inv(diagb)

    def M(r):
        rp = r if perm is None else r[perm]
        z = torch.einsum('bij,bj->bi', binv, rp.reshape(-1, bs)).reshape(-1)
        if perm is None:
            return z
        out = torch.empty_like(z)
        out[perm] = z
        return out
    return M


def analyze(ne, ngl=4, *, device, dtype=torch.float64) -> dict:
    """The JAX script's `analyze` at ne^3 ngl: prints its lines, returns
    every number (the K = S + B^T B check, G's and diag(G)^-1 G's spectra
    and quantiles, the CG iteration counts)."""
    p = problem(ne, ngl, device, dtype)
    mesh = p.mesh
    print(f"\n=== {ne}^3 ngl={ngl} ===")
    fmask = np.asarray(p.bc.free_fs, dtype=bool).reshape(-1)
    idx = np.where(fmask)[0]
    dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Kf = dev(assemble_global_K(p)[np.ix_(idx, idx)])
    Sf = dev(assemble_S(p)[np.ix_(idx, idx)])
    Bf = dev(build_B(p)[:, idx])
    err = float((Kf - (Sf + Bf.T @ Bf)).abs().max() / Kf.abs().max())
    print(f"K = S + B^T B check: rel err {err:.2e}   "
          f"m = {Bf.shape[0]}, n_free = {Kf.shape[0]}")

    Sinv = torch.linalg.inv(Sf)
    del Sf
    G = torch.eye(Bf.shape[0], dtype=dtype, device=device) \
        + Bf @ Sinv @ Bf.T
    lam = torch.linalg.eigvalsh(G).cpu().numpy()
    print(f"G spectrum: min {lam[0]:.3e} max {lam[-1]:.3e} "
          f"kappa {lam[-1]/lam[0]:.1f}")
    dg = torch.diagonal(G).clone()
    s = 1 / dg.sqrt()
    lam2 = torch.linalg.eigvalsh(s[:, None] * G * s[None, :]).cpu().numpy()
    print(f"diag-scaled G: min {lam2[0]:.3e} max {lam2[-1]:.3e} "
          f"kappa {lam2[-1]/lam2[0]:.1f}")
    q = np.quantile(lam2, [0, .01, .1, .25, .5, .75, .9, .99, 1])
    print("  quantiles:", " ".join(f"{x:.3g}" for x in q))

    rng = np.random.default_rng(0)
    b = dev(rng.standard_normal(Kf.shape[0]))
    dK = torch.diagonal(Kf).clone()
    _, itj = pcg_dense(Kf, b, Minv=lambda r: r / dK)
    _, its = pcg_dense(Kf, b, Minv=lambda r: Sinv @ r)
    bq = dev(rng.standard_normal(G.shape[0]))
    _, itg = pcg_dense(G, bq)
    _, itgd = pcg_dense(G, bq, Minv=lambda r: r / dg)
    print(f"actual CG iters (rtol 1e-6): K/jacobi {itj}, K/Sinv {its}, "
          f"G/I {itg}, G/diag {itgd}")

    # block-diagonal G preconditioners: the quadrature rows come in groups
    # (per qp: 1 div + dim_w curl channels; per element: nqr*(1+dim_w))
    dim_w = curl_tensor(mesh.dim).shape[0]
    nqr = Bf.shape[0] // mesh.n_cells // (1 + dim_w)
    m_per = nqr * (1 + dim_w)
    # per-qp blocks: rows of one qp are (div q) and (curl q, w=0..dim_w-1),
    # i.e. strided by nqr inside the element's row block
    e_ids = np.repeat(np.arange(mesh.n_cells), m_per)
    q_ids = np.tile(np.concatenate([np.arange(nqr)] * (1 + dim_w)),
                    mesh.n_cells)
    perm_qp = np.lexsort((np.arange(Bf.shape[0]), q_ids, e_ids))
    _, itq = pcg_dense(G, bq, Minv=block_prec(G, 1 + dim_w, perm_qp))
    _, ite = pcg_dense(G, bq, Minv=block_prec(G, m_per))
    print(f"G/qp-block({1+dim_w}) {itq}, G/elem-block({m_per}) {ite}")
    return {"ne": ne, "ngl": ngl, "k_check": err, "m": int(Bf.shape[0]),
            "n_free": int(Kf.shape[0]),
            "G": {"min": float(lam[0]), "max": float(lam[-1]),
                  "kappa": float(lam[-1] / lam[0])},
            "G_diag": {"min": float(lam2[0]), "max": float(lam2[-1]),
                       "kappa": float(lam2[-1] / lam2[0])},
            "quantiles": [float(x) for x in q],
            "iters": {"K/jacobi": itj, "K/Sinv": its, "G/I": itg,
                      "G/diag": itgd, f"G/qp-block({1 + dim_w})": itq,
                      f"G/elem-block({m_per})": ite}}


def main(argv=None) -> list:
    return analysis_main(argv, "pynama_tpu_torch.exp.fs_woodbury", __doc__,
                         analyze, [3, 4])


if __name__ == "__main__":
    main(sys.argv[1:])
