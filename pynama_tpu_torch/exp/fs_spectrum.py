"""Spectrum-level analysis of the FS-stage solve floor, on the device (port
of the JAX package's exp/fs_spectrum.py).

The warm two-stage KLE solve is almost all FS stage, and the JAX package's
round-5 analysis (docs/DESIGN.md, "the FS-stage solve floor") found it
conditioning-bound. This asks what the preconditioned FS spectrum looks
like:

  * a SMALL cluster of low outliers (deflation or recycling would remove
    it) or a CONTINUUM (nothing subspace-sized helps)?
  * how does the low-mode count scale with the mesh (constant -> deflate;
    ~surface or ~volume -> structural)?

Method: assemble the Dirichlet-condensed FS and main-stage operators
densely (small 3D no-slip cavity meshes; host numpy, the setup rule),
move them to the device and eigendecompose them there under Jacobi and
under FDM preconditioning (`torch.linalg.eigvalsh` / `eigh`: cuSOLVER on
a card, float64 by default), and table the effective condition number
after dropping the k lowest modes with the matching predicted CG count
  iters(k) ~ 0.5 * sqrt(kappa_k) * ln(2/rtol),  rtol = 1e-6.

The dense FDM inverse applies the port's `solver/fdm.py::fdm_apply_ref`
(the plain version, which vmaps; the kernels take one vector a launch) to
identity columns, `batch` at a time through `torch.func.vmap`. The FDM-
preconditioned operator Sq^T A Sq is symmetrized (0.5 (P + P^T)) before
its eigenvalues are taken, as the inverse Mi is: the two products leave it
symmetric only to round-off, and eigvalsh reads one triangle.

    python -m pynama_tpu_torch.exp.fs_spectrum [ne ...] [--ngl 4]
        [--device cuda] [--dtype float64]

Sizes default to 3 4 5. Each size prints the JAX script's lines, then one
JSON line with every number, the wall seconds and the device's peak
memory. `analyze` returns the same numbers.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from pynama_tpu_torch.cases import Problem
from pynama_tpu_torch.exp import analysis_main
from pynama_tpu_torch.ops import local as L
from pynama_tpu_torch.solver.fdm import build_fdm, fdm_apply_ref

#: the k-drop table's k values and the census fractions of the median
KS = (0, 4, 8, 16, 32, 64, 128, 256, 512)
LOW_FRACS = (0.01, 0.05, 0.1, 0.25)
HIGH_FRACS = (4.0, 10.0)


def cavity_cfg(ne, ngl):
    zero = [0, 0, 0]
    return {
        "name": "spec", "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": [ne] * 3, "lower": zero, "upper": [1] * 3}},
        "boundary-conditions": {"no-slip": {
            "up": [2, 0, 0], "down": zero, "left": zero, "right": zero,
            "back": zero, "front": zero}},
        "initial-conditions": {"vorticity": zero},
    }


def problem(ne: int, ngl: int, device, dtype) -> Problem:
    """The analyses' cavity, set up without the engine."""
    p = Problem(cavity_cfg(ne, ngl), device=device, dtype=dtype,
                solver="cg", engine=False)
    p.setUp()
    return p


def element_dofs(mesh) -> np.ndarray:
    """(E, nn*dim) interleaved global dof ids of each element's slots."""
    dim = mesh.dim
    cell_nodes = np.asarray(mesh.cell_nodes)
    nn = cell_nodes.shape[1]
    return (cell_nodes[:, :, None] * dim
            + np.arange(dim)[None, None, :]).reshape(-1, nn * dim)


def assemble_dense(mesh, Ke: np.ndarray) -> np.ndarray:
    """Dense assembled (n_dofs, n_dofs) matrix of one shared element matrix
    (or one per element, (E, nnd, nnd)), host numpy, in element order."""
    dof = element_dofs(mesh)
    n = mesh.n_nodes * mesh.dim
    M = np.zeros((n, n))
    for e in range(dof.shape[0]):
        M[np.ix_(dof[e], dof[e])] += Ke if Ke.ndim == 2 else Ke[e]
    return M


def assemble_global_K(p) -> np.ndarray:
    """Dense assembled K (n_dofs x n_dofs) from the shared element matrix."""
    return assemble_dense(p.mesh, np.asarray(p._em.K, dtype=np.float64))


def fdm_minv_dense(p, free, batch: int = 256):
    """Dense FDM preconditioner inverse on global dofs, (n, n) on p's
    device in p's dtype, via fdm_apply_ref on identity columns; None when
    the mask has no tensor structure."""
    mesh = p.mesh
    dim = mesh.dim
    # assembled diagonal for the jleft fallback
    Ke = np.asarray(p._em.K, dtype=np.float64)
    de = np.tile(np.diagonal(Ke)[None, :], (mesh.n_cells, 1))
    dg = L.to_global(mesh, L.dss_np(mesh, de.reshape(mesh.n_cells, -1),
                                    dim), dim)
    f = build_fdm(mesh, np.asarray(free).reshape(mesh.n_nodes, dim),
                  device=p.device, dtype=p.dtype, diag_global=dg)
    if f is None:
        return None
    n = mesh.n_nodes * dim
    E, nn = np.asarray(mesh.cell_nodes).shape
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=p.device)
    cell_nodes = idx(mesh.cell_nodes)
    rep = idx(np.asarray(mesh.incidence)[:, 0])   # a slot of every node
    nelem, ngl = tuple(mesh.nelem), mesh.ngl
    apply_v = torch.func.vmap(
        lambda r: fdm_apply_ref(f, r, nelem=nelem, ngl=ngl))
    out = torch.empty((n, n), dtype=p.dtype, device=p.device)
    for s in range(0, n, batch):
        b = min(batch, n - s)
        X = torch.zeros((b, n), dtype=p.dtype, device=p.device)
        X[torch.arange(b), s + torch.arange(b)] = 1.0
        Xl = X.reshape(b, mesh.n_nodes, dim)[:, cell_nodes]
        Z = apply_v(Xl.reshape(b, E, nn * dim))
        out[:, s:s + b] = Z.reshape(b, E * nn, dim)[:, rep].reshape(b, n).T
    return out


def effective_kappas(lam, ks=KS):
    lam = np.sort(np.asarray(lam))
    out = {}
    for k in ks:
        if k >= lam.size:
            break
        kap = lam[-1] / lam[k]
        iters = 0.5 * np.sqrt(kap) * np.log(2 / 1e-6)
        out[k] = (float(kap), float(iters))
    return out


def sqrt_spd(Mi: torch.Tensor) -> torch.Tensor:
    """Mi^(1/2) of a dense preconditioner inverse's free block, Mi
    symmetrized first, its eigenvalues floored at 1e-300."""
    lamM, V = torch.linalg.eigh(0.5 * (Mi + Mi.T))
    lamM = lamM.clamp_min(1e-300)
    return V * lamM.sqrt()[None, :]


def preconditioned_eigvals(Sq: torch.Tensor, A: torch.Tensor) -> np.ndarray:
    """Eigenvalues of Sq^T A Sq, symmetrized, ascending, on the host."""
    P = Sq.T @ A @ Sq
    P = 0.5 * (P + P.T)
    return torch.linalg.eigvalsh(P).cpu().numpy()


def localization(p, idx, A, Sq, nlow=128):
    """Where do the low modes of the preconditioned FS operator live?
    Reports the mass fraction of each of the nlow lowest eigenvectors
    within 1 element layer of a wall (if ~1, deflation vectors can be
    stored wall-sparse at ~surface/volume cost). Returns (lam, W, frac):
    the eigenvalues, the nlow lowest modes in dof space and their wall
    fractions (host numpy)."""
    mesh = p.mesh
    dim = mesh.dim
    P = Sq.T @ A @ Sq
    lam, V = torch.linalg.eigh(0.5 * (P + P.T))
    del P
    W = Sq @ V[:, :nlow]                      # back to dof space
    # wall-adjacent node set: within ngl-1 grid planes of any wall
    npts = tuple(mesh.npts)
    g = np.zeros(npts, dtype=bool)
    thick = mesh.ngl - 1                      # one element layer
    for d in range(dim):
        sl = [slice(None)] * dim
        sl[d] = slice(0, thick + 1)
        g[tuple(sl)] = True
        sl[d] = slice(-(thick + 1), None)
        g[tuple(sl)] = True
    wall_dof = np.repeat(g.reshape(-1), dim)[idx]
    wd = torch.as_tensor(wall_dof, device=W.device)
    frac = ((W[wd] ** 2).sum(0) / (W ** 2).sum(0)).cpu().numpy()
    print(f"  low-mode wall-layer mass (1 elem layer, "
          f"{wall_dof.mean()*100:.0f}% of dofs): "
          f"median {np.median(frac):.2f}, min {frac.min():.2f}, "
          f"frac>0.9: {(frac > 0.9).mean():.2f}")
    return lam.cpu().numpy(), W, frac


def spectrum_record(lam) -> dict:
    """min, max, kappa, the k-drop table {k: (kappa_k, iters_k)}, the low-
    and high-mode census {fraction of the median: count} of ascending
    eigenvalues, and the census margin: the smallest relative distance of
    an eigenvalue to a census threshold (a count can differ between two
    runs only if their eigenvalues differ by more than it)."""
    lam = np.asarray(lam)
    med = np.median(lam)
    thresholds = [f * med for f in LOW_FRACS + HIGH_FRACS]
    return {"min": float(lam[0]), "max": float(lam[-1]),
            "kappa": float(lam[-1] / lam[0]), "kdrop": effective_kappas(lam),
            "low": {f: int((lam < f * med).sum()) for f in LOW_FRACS},
            "high": {f: int((lam > f * med).sum()) for f in HIGH_FRACS},
            "margin": float(min(np.abs(lam / th - 1).min()
                                for th in thresholds))}


def _spectrum(name: str, lam: np.ndarray, nf: int, high: bool) -> dict:
    """Print one preconditioner's k-drop table and census (the JAX script's
    lines) and return its spectrum_record."""
    rec = spectrum_record(lam)
    print(f"  {name:7s} k-drop: " + "  ".join(
        f"k={k}:κ={v[0]:.0f},it≈{v[1]:.0f}" for k, v in rec["kdrop"].items()))
    for frac, cnt in rec["low"].items():
        print(f"  {name} modes < {frac}*median: {cnt} "
              f"({cnt/nf*100:.2f}% of free)")
    if high:
        # high-outlier census (CG suffers from both ends)
        for frac, cnt in rec["high"].items():
            print(f"  {name} modes > {frac}*median: {cnt}")
    return rec


def record_gap(a, b, path="") -> tuple:
    """(largest relative gap between the floats of two records, paths where
    their counts or keys differ); "margin" entries are not compared."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return 0.0, [f"{path}: keys {sorted(a)} vs {sorted(b)}"]
        gap, bad = 0.0, []
        for k in a:
            if k != "margin":
                g, m = record_gap(a[k], b[k], f"{path}/{k}")
                gap, bad = max(gap, g), bad + m
        return gap, bad
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return 0.0, [f"{path}: length {len(a)} vs {len(b)}"]
        gap, bad = 0.0, []
        for i, (x, y) in enumerate(zip(a, b)):
            g, m = record_gap(x, y, f"{path}/{i}")
            gap, bad = max(gap, g), bad + m
        return gap, bad
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) / max(abs(b), 1e-300), []
    return 0.0, ([] if a == b else [f"{path}: {a} vs {b}"])


def analyze(ne, ngl, do_fdm=True, *, device, dtype=torch.float64) -> dict:
    """The JAX script's `analyze` at ne^3 ngl: prints its lines, returns
    {"n_nodes", "n_dofs", "FS": {...}, "MAIN": {...}}, per stage "free"
    and "jacobi" / "fdm" with min, max, kappa, the k-drop table
    {k: (kappa_k, iters_k)} and the census {fraction: count} ("fdm" is
    None where the mask has no tensor structure)."""
    p = problem(ne, ngl, device, dtype)
    mesh, dim = p.mesh, p.mesh.dim
    n = mesh.n_nodes * dim
    print(f"\n=== {ne}^3 ngl={ngl}: {mesh.n_nodes} nodes, {n} dofs ===")
    K = assemble_global_K(p)
    out = {"ne": ne, "ngl": ngl, "n_nodes": mesh.n_nodes, "n_dofs": n}
    for tag, free in (("FS", p.bc.free_fs), ("MAIN", p.bc.free_main)):
        fmask = np.asarray(free, dtype=bool).reshape(-1)
        idx = np.where(fmask)[0]
        A = torch.as_tensor(K[np.ix_(idx, idx)], dtype=dtype, device=device)
        nf = idx.size
        # Jacobi
        S = 1.0 / torch.diagonal(A).sqrt()
        lam_j = torch.linalg.eigvalsh(S[:, None] * A * S[None, :]) \
            .cpu().numpy()
        print(f"[{tag}] free dofs {nf}; Jacobi spectrum: "
              f"min {lam_j[0]:.3e} max {lam_j[-1]:.3e} "
              f"kappa {lam_j[-1]/lam_j[0]:.1f}")
        rec = {"free": nf, "jacobi": _spectrum("jacobi", lam_j, nf, False),
               "fdm": None}
        out[tag] = rec
        if not do_fdm:
            continue
        Minv = fdm_minv_dense(p, np.asarray(free, dtype=np.float64))
        if Minv is None:
            print("  (no FDM: no tensor structure)")
            continue
        ix = torch.as_tensor(idx, device=device)
        Sq = sqrt_spd(Minv[ix][:, ix])
        del Minv
        lam_f = preconditioned_eigvals(Sq, A)
        del Sq, A
        print(f"  FDM spectrum: min {lam_f[0]:.3e} max {lam_f[-1]:.3e}"
              f" kappa {lam_f[-1]/lam_f[0]:.1f}")
        rec["fdm"] = _spectrum("fdm", lam_f, nf, True)
    return out


def main(argv=None) -> list:
    return analysis_main(argv, "pynama_tpu_torch.exp.fs_spectrum", __doc__,
                         analyze, [3, 4, 5], ngl_option=True)


if __name__ == "__main__":
    main(sys.argv[1:])
