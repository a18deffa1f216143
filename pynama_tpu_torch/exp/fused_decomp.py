"""Decomposition of fused_apply's time on the card: K3 and K4, and a driver.

Counterpart of the JAX package's `exp/fused_decomp.py`. Its two Pallas
kernels become hand-written CUDA C++ kernels (`csrc/decomp.cu`, built from
K1's own GEMM and DSS in `csrc/fused_common.cuh`):

- ``plainmm_apply(t, matT, block)`` (K4, replaces `_plainmm_kernel`):
  ``t @ matT``, K1's GEMM alone (FFMA in float32, FP64 tensor cores in
  float64). ``block`` (rows per TPU grid step) must divide E and tiles
  nothing on Hopper; ``gemm_plan`` reports the loader and tile it takes.
- ``variant_apply(t, matT, nelem, ngl, ncomp_out, block, do_rolls=True)``
  (K3, replaces `_variant_kernel`): with ``do_rolls`` it is K1's y (GEMM +
  DSS, no ``bnd``); without, ``t @ matT`` plus the axis-0 adds at the
  interior block seams only (``block`` must divide ne0): both slots of each
  seam pair get ``u[lo] + u[hi]``, nothing else is assembled.

On a CUDA tensor each wrapper launches its kernel on PyTorch's current
stream or raises, and adds one to its ``launches``; on a CPU tensor it runs
its plain PyTorch version (``*_ref``). There is no fallback.

The driver times five variants in one chain loop, interleaved, min over
rounds, and prints the decomposition:

    fused      fused_apply (K1): GEMM + DSS + bnd
    nodss      variant_apply(do_rolls=False) (K3): GEMM + seam adds
    plainmm    plainmm_apply (K4): the GEMM alone
    torch_mm   torch.matmul (cuBLAS FP32 on the card; TF32 off)
    torch_full dss_box(torch.matmul): the unfused path

    fused - nodss      = the DSS pass (less the seam adds)
    nodss - plainmm    = the seam adds
    plainmm - torch_mm = the hand GEMM against cuBLAS

    python -m pynama_tpu_torch.exp.fused_decomp [ne ngl] [--block B]
        [--nit N] [--rounds R] [--device cuda|cpu]

Defaults: 24^3 ngl=4, ncomp 3, block 1 (what the TPU picked at that size),
2000 applies per chain, 10 rounds, device cuda.
"""
from __future__ import annotations

import sys

import torch

from pynama_tpu_torch import exp as X
from pynama_tpu_torch.ops import fused as F
from pynama_tpu_torch.ops import local as L

_PLAINMM = {torch.float32: "pn_plainmm_f32", torch.float64: "pn_plainmm_f64"}
_VARIANT = {torch.float32: "pn_variant_apply_f32",
            torch.float64: "pn_variant_apply_f64"}


def check_block(n: int, block, what: str) -> int:
    """`block` as an int; ValueError unless it divides n (`what` names n)."""
    blk = int(block)
    if blk < 1 or n % blk != 0:
        raise ValueError(f"block {block} does not divide {what}={n}")
    return blk


# -------------------------------------------------------------- K4 plainmm
def _check_mm(t, matT, block) -> int:
    if not isinstance(t, torch.Tensor) or not isinstance(matT, torch.Tensor):
        raise TypeError("plainmm_apply takes torch tensors")
    if t.device != matT.device:
        raise ValueError(f"t on {t.device}, matT on {matT.device}")
    if t.dtype not in _PLAINMM or matT.dtype != t.dtype:
        raise TypeError(f"plainmm_apply takes float32 or float64 tensors of "
                        f"one dtype; got {t.dtype} and {matT.dtype}")
    if t.dim() != 2 or matT.dim() != 2 or matT.shape[0] != t.shape[1]:
        raise ValueError(f"plainmm_apply: t {tuple(t.shape)} and matT "
                         f"{tuple(matT.shape)} do not multiply")
    if not (t.is_contiguous() and matT.is_contiguous()):
        raise ValueError("plainmm_apply takes contiguous tensors")
    F.check_device(t, "plainmm_apply")
    return check_block(int(t.shape[0]), block, "E")


def plainmm_apply_ref(t: torch.Tensor, matT: torch.Tensor, block: int):
    """Plain PyTorch version of K4: t @ matT."""
    _check_mm(t, matT, block)
    return L.emm(t, matT)


def plainmm_apply(t: torch.Tensor, matT: torch.Tensor, block: int):
    """t @ matT through K1's GEMM; CPU tensors take the plain version."""
    _check_mm(t, matT, block)
    if t.device.type == "cpu":
        return plainmm_apply_ref(t, matT, block)
    from pynama_tpu_torch.ops._build import launch
    M, K = (int(s) for s in t.shape)
    N = int(matT.shape[1])
    y = torch.empty((M, N), dtype=t.dtype, device=t.device)
    launch(_PLAINMM[t.dtype], t.device, t.data_ptr(), matT.data_ptr(),
           y.data_ptr(), M, K, N)
    plainmm_apply.launches += 1
    return y


plainmm_apply.launches = 0


def gemm_plan(t: torch.Tensor, matT: torch.Tensor, y: torch.Tensor) -> dict:
    """The loader and tile the GEMM of K1, K3 and K4 takes for y = t @ matT
    with these tensors: ``{"loader_bytes": 16 or the element size,
    "tile": [rows, columns]}``. Asks the kernel library (needs nvcc) and
    launches nothing."""
    import ctypes
    from pynama_tpu_torch.ops._build import load_library
    out = (ctypes.c_int * 3)()
    rc = load_library().pn_gemm_plan(
        t.data_ptr(), matT.data_ptr(), y.data_ptr(), int(t.shape[1]),
        int(matT.shape[1]), t.element_size(), out)
    if rc != 0:
        raise ValueError(f"no GEMM plan for {t.dtype}")
    return {"loader_bytes": out[0], "tile": [out[1], out[2]]}


# ------------------------------------------------------------- K3 variant
def _check_variant(t, matT, nelem, ngl, ncomp_out, block) -> int:
    F.check_inputs(t, matT, nelem, ngl, ncomp_out, "variant_apply")
    F.check_device(t, "variant_apply")
    return check_block(nelem[0], block, "nelem[0]")


def variant_apply_ref(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                      ngl: int, ncomp_out: int, block: int,
                      do_rolls: bool = True):
    """Plain PyTorch version of K3: dss_box(t @ matT) with do_rolls, else
    t @ matT with both slots of every interior block-seam pair set to the
    sum of the two raw values."""
    nelem = tuple(int(n) for n in nelem)
    blk = _check_variant(t, matT, nelem, ngl, ncomp_out, block)
    dim, E, R, nnc, plane = F._shapes(nelem, ngl, ncomp_out)
    u = L.emm(t, matT)
    if do_rolls:
        return L.dss_box(u, nelem, ngl, ncomp_out,
                         L.make_perms(ngl, dim, ncomp_out, t.device))
    ne0 = nelem[0]
    lo = slice(blk - 1, ne0 - 1, blk)     # rows s*blk - 1, s = 1..nblk-1
    hi = slice(blk, ne0, blk)             # rows s*blk
    u3 = u.view(ne0, R, nnc)
    y = u.clone()
    y3 = y.view(ne0, R, nnc)
    v = u3[lo, :, nnc - plane:] + u3[hi, :, :plane]
    y3[lo, :, nnc - plane:] = v
    y3[hi, :, :plane] = v
    return y


def variant_apply(t: torch.Tensor, matT: torch.Tensor, nelem: tuple,
                  ngl: int, ncomp_out: int, block: int,
                  do_rolls: bool = True):
    """K3; see the module docstring. CPU tensors take the plain version."""
    nelem = tuple(int(n) for n in nelem)
    ngl, ncomp_out = int(ngl), int(ncomp_out)
    blk = _check_variant(t, matT, nelem, ngl, ncomp_out, block)
    if t.device.type == "cpu":
        return variant_apply_ref(t, matT, nelem, ngl, ncomp_out, blk,
                                 do_rolls)
    from pynama_tpu_torch.ops._build import launch
    dim, E, _, nnc_out, _ = F._shapes(nelem, ngl, ncomp_out)
    y = torch.empty((E, nnc_out), dtype=t.dtype, device=t.device)
    # u: the GEMM's output before the DSS; without rolls the GEMM writes y
    u = torch.empty_like(y) if do_rolls else y
    ne = list(nelem) + [1] * (3 - dim)
    launch(_VARIANT[t.dtype], t.device, t.data_ptr(), matT.data_ptr(),
           u.data_ptr(), y.data_ptr(), E, int(t.shape[1]), ngl, ncomp_out,
           dim, ne[0], ne[1], ne[2], blk, int(bool(do_rolls)))
    variant_apply.launches += 1
    return y


variant_apply.launches = 0


# ----------------------------------------------------------------- driver
def main(argv=None) -> dict:
    """Run the decomposition; returns seconds per apply of each variant."""
    args = X.parse_args(argv, "pynama_tpu_torch.exp.fused_decomp",
                        "Split fused_apply's time on the card.", rounds=10)
    dev = X.device_of(args.device)
    ne, ngl, ncomp = args.ne, args.ngl, 3
    nelem = (ne, ne, ne)
    R = ne * ne
    blk = check_block(ne, args.block, "ne")
    t0, matT = X.inputs(ne, ngl, ncomp, dev)
    perms = L.make_perms(ngl, 3, ncomp, dev)
    print(f"device: {X.device_name(dev)}; {ne}^3 ngl={ngl} "
          f"({t0.shape[1]}->{matT.shape[1]}), block: {blk}", flush=True)

    variants = {
        "fused": lambda x, m: F.fused_apply(x, m, nelem, ngl, ncomp)[0],
        "nodss": lambda x, m: variant_apply(x, m, nelem, ngl, ncomp, blk,
                                            do_rolls=False),
        "plainmm": lambda x, m: plainmm_apply(x, m, blk * R),
        "torch_mm": lambda x, m: torch.matmul(x, m),
        "torch_full": lambda x, m: L.dss_box(torch.matmul(x, m), nelem, ngl,
                                             ncomp, perms),
    }
    best = X.time_variants(variants, t0, matT, args.nit, args.rounds)

    us = {k: v * 1e6 for k, v in best.items()}
    print("\n=== decomposition (min over rounds) ===")
    for k in variants:
        print(f"{k:10s}: {us[k]:7.1f} us")
    print(f"dss pass (fused-nodss)         : "
          f"{us['fused'] - us['nodss']:7.1f} us")
    print(f"seam adds (nodss-plainmm)      : "
          f"{us['nodss'] - us['plainmm']:7.1f} us")
    print(f"hand-vs-cublas mm (plainmm-mm) : "
          f"{us['plainmm'] - us['torch_mm']:7.1f} us")
    print(f"fused win vs torch (full-fused): "
          f"{us['torch_full'] - us['fused']:7.1f} us", flush=True)
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
