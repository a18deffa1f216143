"""Operations and bytes of the solver's device work, and the least time the
card could take for it (the roofline bound).

The arithmetic of the measured package's chip_smoke.py `_bound` /
`_gemm_bound`, copied here so that the yardstick does not move with the
program: the bound is the larger of operations over the peak rate and
bytes over the memory rate, each input byte read once and each output byte
written once.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM3 3.35
TB/s; 67 TFLOP/s FP32 outside the tensor cores (FFMA) and FP64 on the
tensor cores (DMMA).
"""
from __future__ import annotations

import math

HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEM_BYTES = {"float32": 4, "float64": 8}


def bound_s(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(seconds, what sets them): operations or bytes."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def apply_cost(nelem, ngl: int, cin: int, cout: int,
               dtype: str) -> tuple[float, float]:
    """(flops, bytes) of one box-mesh operator application y = DSS(t @
    matT): t (E, nn*cin), matT (nn*cin, nn*cout), y (E, nn*cout), and the
    two axis-0 boundary planes of y the kernel writes beside it."""
    E = math.prod(nelem)
    nn = ngl ** len(nelem)
    K, N = nn * cin, nn * cout
    eb = ITEM_BYTES[dtype]
    planes = 2 * (E // nelem[0]) * (N // ngl)
    return 2.0 * E * K * N, float((E * K + K * N + E * N + planes) * eb)


def apply_bound_s(nelem, ngl, cin, cout, dtype) -> float:
    return bound_s(*apply_cost(nelem, ngl, cin, cout, dtype), dtype)[0]


def rhs_applications(dim: int, two_stage: bool) -> list[tuple[int, int]]:
    """(cin, cout) of the operator applications one rhs makes outside the
    CG loops: per KLE stage Rw w->v, K of the wall values, the initial
    residual; curl between the stages; then srt, div_srt and curl."""
    dw, ds = (1, 3) if dim == 2 else (3, 6)
    stage = [(dw, dim), (dim, dim), (dim, dim)]
    apps = stage * (2 if two_stage else 1)
    if two_stage:
        apps.append((dim, dw))
    return apps + [(dim, ds), (ds, dim), (dim, dw)]


def fdm_apply_cost(npts, ncomp: int, dtype: str) -> tuple[float, float]:
    """(flops, bytes) of one fast-diagonalization apply on a grid of `npts`
    nodes per axis with `ncomp` components: per axis a dense transform
    in (analysis) and out (synthesis), the per-mode (c, c) block, and the
    diagonal leftover; reading r, the transforms, the blocks and the
    leftover once, writing z once."""
    n = math.prod(npts)
    c = ncomp
    flops = 2 * sum(2.0 * c * n * m for m in npts) + 2.0 * c * c * n \
        + 2.0 * c * n
    words = 2 * c * n + sum(c * m * m for m in npts) + c * c * n + c * n
    return flops, float(words * ITEM_BYTES[dtype])
