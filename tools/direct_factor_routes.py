"""Setup seconds of the direct solver's two factorization routes.

    python tools/direct_factor_routes.py [--nelem N] [--device cuda]

Builds the free-slip-stage masked KLE matrix of the cavity-2d case file
(N^2 elements, default 50: 20,402 velocity dofs, ngl=3) as the port's
`solver/kle.py::build_system` does (numpy float64 dense assembly on the
host), then factors it by the JAX package's route, `scipy.linalg.cholesky`
on the host, and by the port's, `torch.linalg.cholesky` in float64 on the
device (host-to-device copy and the cast of the factor to float32
included), and checks the two factors agree; then times one solve with the
float32 factor by `torch.cholesky_solve` and by two
`torch.linalg.solve_triangular` calls. Prints one JSON line with the
seconds of each step and the host's CPU count. Needs the device it is
given; `--device cpu` times torch's LAPACK route instead.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.linalg
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pynama_tpu_torch.basis import make_tensor_basis  # noqa: E402
from pynama_tpu_torch.bc import BoundaryConditions  # noqa: E402
from pynama_tpu_torch.elements import compute_kle_matrices  # noqa: E402
from pynama_tpu_torch.mesh import BoxMesh  # noqa: E402
from pynama_tpu_torch.ops.apply import assemble_dense  # noqa: E402


def _solves(L, dev, reps=5):
    """One solve with the factor L (float32): torch.cholesky_solve against
    two torch.linalg.solve_triangular calls, median seconds of `reps` and
    the device memory each allocates beyond its inputs, and their
    agreement."""
    b = torch.ones((L.shape[0], 1), dtype=L.dtype, device=dev)
    routes = {
        "cholesky_solve": lambda: torch.cholesky_solve(b, L),
        "solve_triangular_x2": lambda: torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, b, upper=False),
            upper=True)}
    out, xs = {}, {}
    for name, fn in routes.items():
        xs[name] = fn()
        times = []
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"median_s": float(np.median(times))}
        if dev.type == "cuda":
            out[name]["extra_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                        - base)
    a, c = xs.values()
    out["rel_diff"] = float((a - c).abs().max() / c.abs().max())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nelem", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    mesh = BoxMesh.create(3, (args.nelem, args.nelem), [0, 0], [1, 1])
    bc = BoundaryConditions(mesh, {"no-slip": {
        "up": [2, 0], "down": [0, 0], "left": [0, 0], "right": [0, 0]}})
    K = compute_kle_matrices(make_tensor_basis(3, 2),
                             mesh.cell_corners[0]).K
    out = {"n": mesh.n_nodes * 2, "cpus": os.cpu_count(),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu"}
    t0 = time.perf_counter()
    A = assemble_dense(np.asarray(K), mesh.cell_nodes, 2, 2, mesh.n_nodes)
    c = ~bc.free_fs.ravel().astype(bool)
    A[c, :] = 0.0
    A[:, c] = 0.0
    A[c, c] = 1.0
    out["assemble_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    L_host = scipy.linalg.cholesky(A, lower=True)
    out["scipy_host_factor_s"] = time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_dev = torch.as_tensor(A, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["copy_to_device_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    L = torch.linalg.cholesky(A_dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["torch_factor_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    L32 = L.to(torch.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["cast_s"] = time.perf_counter() - t1
    out["torch_route_s"] = time.perf_counter() - t0
    diff = np.abs(L.cpu().numpy() - L_host).max() / np.abs(L_host).max()
    out["factor_rel_diff"] = float(diff)
    out["factor_f32_bytes"] = L32.numel() * 4
    del L, A_dev
    out["solve"] = _solves(L32, dev)
    print(json.dumps(out))
    if diff > 1e-10:
        sys.exit(f"factors differ by {diff:.3e}")


if __name__ == "__main__":
    main()
