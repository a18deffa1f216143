"""Dense validation of wall-block corrections for the FS-stage floor, on the
device (port of the JAX package's exp/fs_walls.py).

fs_spectrum showed the FS low modes scale with the wall surface,
consistent with near-zero-energy tangential slip patterns living on the
no-slip walls. This tests whether an additive wall-block solve,
M^-1 = (Jacobi or FDM)^-1 + R_w^T (K_ww)^-1 R_w with K_ww the assembled
operator restricted to wall free dofs, collapses the preconditioned FS
spectrum. If yes, the production form is a per-face 2D fast
diagonalization (K_ww inherits the tensor structure on a box face).

Variants:
  jac              Jacobi alone (baseline)
  fdm              FDM alone (baseline)
  jac+ww           Jacobi + exact wall-block inverse
  fdm+ww           FDM + exact wall-block inverse
  fdm+ww1          wall block widened by one element layer
  fdm+schur        FDM + exact wall SCHUR complement inverse (the ideal)
  jac+schur        Jacobi + the same
  {fdm,jac}+6sl(tT)   + exact inverses of one slab PER FACE (wall plane
                   and T interior planes, overlapping at edges, additive)
  {fdm,jac}+6slF(tT)  + the FDM approximation of each slab block
with T = ngl-1 and 2(ngl-1). A slab whose mask has no tensor structure has
no FDM block and is skipped, as in the JAX script.

The matrices are assembled in host numpy and go to the device; inverses,
solves and eigendecompositions run there (float64 by default). Every
preconditioned operator is symmetrized before its eigenvalues are taken
(`fs_spectrum.preconditioned_eigvals`).

    python -m pynama_tpu_torch.exp.fs_walls [ne ...] [--device cuda]
        [--dtype float64]

Sizes default to 3 4. Each size prints the JAX script's lines, then one
JSON line with every variant's numbers, the wall seconds and the device's
peak memory.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from pynama_tpu_torch.exp import analysis_main
from pynama_tpu_torch.exp.fs_spectrum import (assemble_global_K,
                                              fdm_minv_dense,
                                              preconditioned_eigvals,
                                              problem, sqrt_spd)


def pred_iters(kap):
    return 0.5 * np.sqrt(kap) * np.log(2 / 1e-6)


def spectrum_of(Minv: torch.Tensor, A: torch.Tensor) -> np.ndarray:
    """Eigenvalues of Minv^(1/2) A Minv^(1/2) (Minv symmetrized), host."""
    return preconditioned_eigvals(sqrt_spd(Minv), A)


def summary(lam) -> dict:
    kap = lam[-1] / lam[0]
    return {"min": float(lam[0]), "max": float(lam[-1]),
            "kappa": float(kap), "iters": float(pred_iters(kap))}


def report(tag, lam) -> dict:
    rec = summary(lam)
    print(f"  {tag:12s}: min {lam[0]:.3e} max {lam[-1]:.3e} "
          f"kappa {rec['kappa']:8.1f}  it~{rec['iters']:5.0f}")
    return rec


def wall_dof_sets(p, idx):
    """Boolean masks (over the free-dof index list idx) of wall-plane dofs
    and wall-plane+1-layer dofs."""
    mesh = p.mesh
    dim = mesh.dim
    npts = tuple(mesh.npts)
    masks = {}
    for thick, name in ((0, "ww"), (mesh.ngl - 1, "ww1")):
        g = np.zeros(npts, dtype=bool)
        for d in range(dim):
            sl = [slice(None)] * dim
            sl[d] = slice(0, thick + 1)
            g[tuple(sl)] = True
            sl[d] = slice(npts[d] - thick - 1, None)
            g[tuple(sl)] = True
        masks[name] = np.repeat(g.reshape(-1), dim)[idx]
    return masks


def _block(A: torch.Tensor, rows: np.ndarray, cols: np.ndarray):
    r = torch.as_tensor(rows, device=A.device)
    c = torch.as_tensor(cols, device=A.device)
    return A[r][:, c]


def _embed(A: torch.Tensor, rows: np.ndarray, B: torch.Tensor):
    """A zero matrix like A with B in its (rows, rows) block."""
    out = torch.zeros_like(A)
    r = torch.as_tensor(rows, device=A.device)
    out[r[:, None], r[None, :]] = B
    return out


def analyze(ne, ngl=4, *, device, dtype=torch.float64) -> dict:
    """The JAX script's `analyze` at ne^3 ngl: prints its lines, returns
    {"free", "wall", "wall1", "variants": {tag: {min, max, kappa,
    iters}}}."""
    p = problem(ne, ngl, device, dtype)
    mesh = p.mesh
    print(f"\n=== {ne}^3 ngl={ngl}: {mesh.n_nodes * mesh.dim} dofs ===")
    K = assemble_global_K(p)
    fmask = np.asarray(p.bc.free_fs, dtype=bool).reshape(-1)
    idx = np.where(fmask)[0]
    A = torch.as_tensor(K[np.ix_(idx, idx)], dtype=dtype, device=device)
    del K
    nf = idx.size
    Dinv = torch.diag(1.0 / torch.diagonal(A))
    masks = wall_dof_sets(p, idx)
    print(f"free dofs {nf}; wall dofs {int(masks['ww'].sum())} "
          f"({masks['ww'].mean()*100:.0f}%), +1 layer "
          f"{int(masks['ww1'].sum())} ({masks['ww1'].mean()*100:.0f}%)")
    out = {"ne": ne, "ngl": ngl, "free": int(nf),
           "wall": int(masks["ww"].sum()), "wall1": int(masks["ww1"].sum()),
           "variants": {}}

    def rep(tag, Minv):
        out["variants"][tag] = report(tag, spectrum_of(Minv, A))

    ix = torch.as_tensor(idx, device=device)
    Mf = fdm_minv_dense(p, np.asarray(p.bc.free_fs, dtype=np.float64))
    Mf = Mf[ix][:, ix]

    rep("jac", Dinv)
    rep("fdm", Mf)

    def wall_inv(mask):
        w = np.where(mask)[0]
        return _embed(A, w, torch.linalg.inv(_block(A, w, w)))

    Www = wall_inv(masks["ww"])
    rep("jac+ww", Dinv + Www)
    rep("fdm+ww", Mf + Www)
    del Www
    rep("fdm+ww1", Mf + wall_inv(masks["ww1"]))

    # the ideal: exact wall Schur complement S = Kww - Kwi Kii^-1 Kiw
    w = np.where(masks["ww"])[0]
    i = np.where(~masks["ww"])[0]
    Kiw = _block(A, i, w)
    S = _block(A, w, w) - Kiw.T @ torch.linalg.solve(_block(A, i, i), Kiw)
    Sinv = _embed(A, w, torch.linalg.inv(S))
    del S, Kiw
    rep("fdm+schur", Mf + Sinv)
    rep("jac+schur", Dinv + Sinv)
    del Sinv

    # production-shaped variants: one slab PER FACE (overlapping at
    # edges/corners, additive), each wall plane + `thick` interior planes
    dim = mesh.dim
    npts = tuple(mesh.npts)
    free_fs = np.asarray(p.bc.free_fs, dtype=bool).reshape(-1)
    for thick in (ngl - 1, 2 * (ngl - 1)):
        corr_exact = torch.zeros_like(A)
        corr_fdm = torch.zeros_like(A)
        for dax in range(dim):
            for side in (0, 1):
                g = np.zeros(npts, dtype=bool)
                sl = [slice(None)] * dim
                sl[dax] = slice(0, thick + 1) if side == 0 \
                    else slice(npts[dax] - thick - 1, None)
                g[tuple(sl)] = True
                slab = np.repeat(g.reshape(-1), dim)
                wf = np.where(slab[idx])[0]
                corr_exact += _embed(A, wf, torch.linalg.inv(
                    _block(A, wf, wf)))
                # FDM approximation of the same slab block
                mask_slab = (free_fs & slab).astype(np.float64)
                Mi_slab = fdm_minv_dense(p, mask_slab)
                if Mi_slab is not None:
                    corr_fdm += Mi_slab[ix][:, ix]
                    del Mi_slab
        rep(f"fdm+6sl(t{thick})", Mf + corr_exact)
        rep(f"jac+6sl(t{thick})", Dinv + corr_exact)
        rep(f"fdm+6slF(t{thick})", Mf + corr_fdm)
        rep(f"jac+6slF(t{thick})", Dinv + corr_fdm)
        del corr_exact, corr_fdm
    return out


def main(argv=None) -> list:
    return analysis_main(argv, "pynama_tpu_torch.exp.fs_walls", __doc__,
                         analyze, [3, 4])


if __name__ == "__main__":
    main(sys.argv[1:])
