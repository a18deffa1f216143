"""The fused apply with a 3-pass split-bf16 tensor-core GEMM: K2, and a driver.

Counterpart of the JAX package's `exp/mm3x.py`. Its Pallas kernel becomes a
hand-written CUDA C++ kernel (`csrc/fused3x.cu`):

- ``fused3x_apply(t, matT, nelem, ngl, ncomp_out, block)`` (K2, replaces
  `_kernel3x`): ``DSS(mm3x(t, matT))``, float32 only (float64 raises
  TypeError: the TPU never ran it, and a bf16 split of f64 is not what the
  experiment measures). ``block`` must divide ne0 and is otherwise unused:
  on the TPU it only changed the order of the DSS additions.
- ``gemm3x(a, m)``: K2's GEMM alone, ``mm3x(a, m)`` for any (M, K) and
  (K, N), which `chip_smoke.py` times and sweeps.
- ``mm3x_ref(a, m)``, the twin of `_mm3x`: with ``x_hi = bf16_rn(x)`` and
  ``x_lo = bf16_rn(x - x_hi)``, ``(a_hi m_hi + a_hi m_lo) + a_lo m_hi``. The
  halves are cast back to float32 before the products (each bf16 x bf16
  product is exact in f32), as JAX's ``preferred_element_type=f32`` does; a
  torch bf16 matmul would round every sum to bf16.
- ``gemm3x_plan(M, K, N)``: what the CUDA GEMM decides on the host (tile
  width, padded extents, whether matT's halves stay in shared memory, ring
  stages, loader, grid), restated; ``gemm3x_library_plan`` asks the kernel
  library for the same. ``mm3x_chained(a, m)`` restates the kernel's
  summation order in numpy.

The CUDA GEMM (wgmma m64nNk16 bf16, A split in registers) first splits matT
into a scratch tensor in the tensor cores' layout, which the wrapper
allocates per call (``gemm3x_plan(...)["split_bytes"]``): K2 stays a pure
function of its arguments.

On a CUDA tensor ``fused3x_apply`` and ``gemm3x`` launch their kernels on
PyTorch's current stream or raise, and add one to their ``launches``; on a
CPU tensor they run ``fused3x_apply_ref`` and ``mm3x_ref``. There is no
fallback.

The driver checks K2 against fused_apply (full f32, the HIGHEST product of
the JAX package) and times fused_HI (fused_apply), fused_3x (K2) and mm_HI
(torch.matmul, TF32 off), interleaved, min over rounds:

    python -m pynama_tpu_torch.exp.mm3x [ne ngl] [--block B] [--nit N]
        [--rounds R] [--device cuda|cpu]

Defaults: 24^3 ngl=4, ncomp 3, block 1, 2000 applies per chain, 8 rounds,
device cuda.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from pynama_tpu_torch import exp as X
from pynama_tpu_torch.exp.fused_decomp import check_block
from pynama_tpu_torch.ops import fused as F
from pynama_tpu_torch.ops import local as L


def mm3x_ref(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(a_hi @ m_hi + a_hi @ m_lo) + a_lo @ m_hi, bf16 halves (round to
    nearest even), products and sums in a's dtype."""
    def split(x):
        hi = x.to(torch.bfloat16).to(x.dtype)
        return hi, (x - hi).to(torch.bfloat16).to(x.dtype)
    a_hi, a_lo = split(a)
    m_hi, m_lo = split(m)
    return (a_hi @ m_hi + a_hi @ m_lo) + a_lo @ m_hi


# ------------------------------------------------------ the GEMM's plan
# csrc/fused3x.cu's constants: rows of a CTA tile, k depth of a ring stage
# (and of an accumulation chain), ring stages with matT's halves resident
# and streamed, the shared memory a CTA may use
X_BM, X_BK = 64, 32
X_STAGES_RES, X_STAGES_STR = 7, 5
X_A_STAGE = X_BM * X_BK * 4
X_SMEM_MAX = 227 * 1024
PLAN_KEYS = ("tile_n", "kp", "np", "ncol", "resident", "stages",
             "loader_bytes", "smem_bytes", "grid_x")


def gemm3x_plan(M: int, K: int, N: int, aligned: bool = True,
                sms: int = 132) -> dict:
    """How the CUDA GEMM covers mm3x of (M, K) by (K, N):
    csrc/fused3x.cu's make_gemm3x_plan, restated. A CTA (two warpgroups side
    by side along N) computes 64 x ``tile_n`` tiles of one of the ``ncol``
    column tiles, walking row tiles ``grid_x`` apart. ``kp``, ``np``: K and N
    padded to whole stages and tiles, the extents of the split scratch
    (``split_bytes``). ``resident``: both halves of the CTA's kp x tile_n
    slab of matT stay in shared memory; else every one of the ``stages``
    ring stages carries its 32-deep slab. ``loader_bytes``: bytes per copy
    of t, 16 where t is 16-byte aligned (``aligned``) and K a multiple of 4,
    else 4. ``sms``: the card's SM count."""
    kp = -(-K // X_BK) * X_BK
    bn = 32 if N <= 32 else 192
    resident = 4 * kp * bn + X_STAGES_RES * X_A_STAGE <= X_SMEM_MAX
    np_ = -(-N // bn) * bn
    ncol = np_ // bn
    stages = X_STAGES_RES if resident else X_STAGES_STR
    # the slab(s) of matT's halves and the ring of t
    smem = ((4 * kp * bn if resident else stages * 4 * X_BK * bn)
            + stages * X_A_STAGE)
    tiles = -(-M // X_BM)
    return {"tile_n": bn, "kp": kp, "np": np_, "ncol": ncol,
            "resident": int(resident), "stages": stages,
            "loader_bytes": 16 if aligned and K % 4 == 0 else 4,
            "smem_bytes": smem, "grid_x": min(tiles, max(sms // ncol, 1)),
            "split_bytes": 4 * kp * np_}


def gemm3x_library_plan(t: torch.Tensor, N: int) -> dict:
    """The plan the kernel library takes for mm3x of this t (M, K) on its
    device with a (K, N) matT (needs nvcc; launches nothing), in
    gemm3x_plan's names."""
    from pynama_tpu_torch.ops._build import load_library
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(t.device):
        rc = load_library().pn_gemm3x_plan(t.data_ptr(), int(t.shape[0]),
                                           int(t.shape[1]), int(N), out)
    if rc != 0:
        raise RuntimeError(f"pn_gemm3x_plan: CUDA error {rc}")
    plan = dict(zip(PLAN_KEYS, out))
    plan["split_bytes"] = 4 * plan["kp"] * plan["np"]
    return plan


def mm3x_chained(a: np.ndarray, m: np.ndarray, chain: int = X_BK):
    """The CUDA GEMM's summation order in numpy: per ``chain``-deep k stage
    the three split products hi*hi + hi*lo + lo*hi go into one stage sum
    (here in float64 and rounded once, where the tensor cores round their
    own way), and the stage sums are added in float32 in ascending k."""
    def split(x):
        t = torch.as_tensor(x)
        hi = t.to(torch.bfloat16).to(torch.float32)
        return hi.numpy(), (t - hi).to(torch.bfloat16).to(
            torch.float32).numpy()
    a_hi, a_lo = (x.astype(np.float64) for x in split(a))
    m_hi, m_lo = (x.astype(np.float64) for x in split(m))
    acc = np.zeros((a.shape[0], m.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], chain):
        k = slice(k0, k0 + chain)
        part = a_hi[:, k] @ m_hi[k] + a_hi[:, k] @ m_lo[k] \
            + a_lo[:, k] @ m_hi[k]
        acc = acc + part.astype(np.float32)
    return acc


def gemm3x(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """K2's GEMM alone: mm3x(a, m) for float32 a (M, K) and m (K, N),
    contiguous. CPU tensors take mm3x_ref, CUDA tensors the kernel."""
    if not (isinstance(a, torch.Tensor) and isinstance(m, torch.Tensor)
            and a.dtype == m.dtype == torch.float32):
        raise TypeError("gemm3x takes float32 tensors")
    if (a.dim() != 2 or m.dim() != 2 or a.shape[1] != m.shape[0]
            or not a.is_contiguous() or not m.is_contiguous()
            or a.device != m.device or a.shape[0] >= 2 ** 31):
        raise ValueError(
            f"gemm3x takes contiguous (M, K) and (K, N) tensors on one "
            f"device; got {tuple(a.shape)}, {tuple(m.shape)}")
    F.check_device(a, "gemm3x")
    if a.device.type == "cpu":
        return mm3x_ref(a, m)
    from pynama_tpu_torch.ops._build import launch
    M, K = (int(n) for n in a.shape)
    N = int(m.shape[1])
    u = torch.empty((M, N), dtype=a.dtype, device=a.device)
    split = _split_scratch(a, N)
    launch("pn_gemm3x_f32", a.device, a.data_ptr(), m.data_ptr(),
           split.data_ptr(), split.numel(), u.data_ptr(), M, K, N)
    gemm3x.launches += 1
    return u


gemm3x.launches = 0


def _split_scratch(t: torch.Tensor, N: int) -> torch.Tensor:
    """The scratch for the split halves of a (K, N) matT (torch.empty
    returns 16-byte aligned memory)."""
    plan = gemm3x_plan(int(t.shape[0]), int(t.shape[1]), N)
    return torch.empty(plan["split_bytes"], dtype=torch.uint8,
                       device=t.device)


def _check(t, matT, nelem, ngl, ncomp_out, block) -> int:
    F.check_inputs(t, matT, nelem, ngl, ncomp_out, "fused3x_apply")
    if t.dtype != torch.float32:
        raise TypeError(f"fused3x_apply takes float32 only; got {t.dtype}")
    F.check_device(t, "fused3x_apply")
    return check_block(nelem[0], block, "nelem[0]")


def fused3x_apply_ref(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                      ngl: int, ncomp_out: int, block: int):
    """Plain PyTorch version of K2: dss_box(mm3x_ref(t, matT))."""
    nelem = tuple(int(n) for n in nelem)
    _check(t, matT, nelem, ngl, ncomp_out, block)
    return L.dss_box(mm3x_ref(t, matT), nelem, ngl, ncomp_out,
                     F._perms(ngl, len(nelem), ncomp_out, t.device))


def fused3x_apply(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                  ngl: int, ncomp_out: int, block: int):
    """K2; see the module docstring. CPU tensors take the plain version."""
    nelem = tuple(int(n) for n in nelem)
    ngl, ncomp_out = int(ngl), int(ncomp_out)
    _check(t, matT, nelem, ngl, ncomp_out, block)
    if t.device.type == "cpu":
        return fused3x_apply_ref(t, matT, nelem, ngl, ncomp_out, block)
    from pynama_tpu_torch.ops._build import launch
    dim, E, _, nnc_out, _ = F._shapes(nelem, ngl, ncomp_out)
    u = torch.empty((E, nnc_out), dtype=t.dtype, device=t.device)
    y = torch.empty_like(u)
    split = _split_scratch(t, nnc_out)
    ne = list(nelem) + [1] * (3 - dim)
    launch("pn_fused3x_f32", t.device, t.data_ptr(), matT.data_ptr(),
           split.data_ptr(), split.numel(), u.data_ptr(), y.data_ptr(), E,
           int(t.shape[1]), ngl, ncomp_out, dim, ne[0], ne[1], ne[2])
    fused3x_apply.launches += 1
    return y


fused3x_apply.launches = 0


def main(argv=None) -> dict:
    """Check K2 against fused_apply and time both against torch.matmul.
    Returns {"max_abs_diff", "scale", "max_rel", "times": {variant: s}}."""
    args = X.parse_args(argv, "pynama_tpu_torch.exp.mm3x",
                        "Check and time the split-bf16 fused apply.",
                        rounds=8)
    dev = X.device_of(args.device)
    ne, ngl, ncomp = args.ne, args.ngl, 3
    nelem = (ne, ne, ne)
    blk = check_block(ne, args.block, "ne")
    t0, matT = X.inputs(ne, ngl, ncomp, dev)
    print(f"device: {X.device_name(dev)}; {ne}^3 ngl={ngl} "
          f"({t0.shape[1]}->{matT.shape[1]}), block: {blk}", flush=True)

    # numerics: the 3-pass split against the full-f32 product
    y_ref = F.fused_apply(t0, matT, nelem, ngl, ncomp)[0]
    y_3x = fused3x_apply(t0, matT, nelem, ngl, ncomp, blk)
    diff = (y_3x - y_ref).abs()
    out = {"max_abs_diff": float(diff.max()),
           "scale": float(y_ref.abs().max()),
           "max_rel": float((diff / (y_ref.abs() + 1e-30)).max())}
    print(f"3x vs HIGHEST: max abs diff {out['max_abs_diff']:.3e} "
          f"(scale {out['scale']:.3e}), max rel {out['max_rel']:.3e}",
          flush=True)

    variants = {
        "fused_HI": lambda x, m: F.fused_apply(x, m, nelem, ngl, ncomp)[0],
        "fused_3x": lambda x, m: fused3x_apply(x, m, nelem, ngl, ncomp, blk),
        "mm_HI": lambda x, m: torch.matmul(x, m),
    }
    out["times"] = X.time_variants(variants, t0, matT, args.nit,
                                   args.rounds)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
