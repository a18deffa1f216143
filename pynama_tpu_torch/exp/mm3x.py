"""The fused apply with a 3-pass split-bf16 tensor-core GEMM: K2, and a driver.

Counterpart of the JAX package's `exp/mm3x.py`. Its Pallas kernel becomes a
hand-written CUDA C++ kernel (`csrc/fused3x.cu`):

- ``fused3x_apply(t, matT, nelem, ngl, ncomp_out, block)`` (K2, replaces
  `_kernel3x`): ``DSS(mm3x(t, matT))``, float32 only (float64 raises
  TypeError: the TPU never ran it, and a bf16 split of f64 is not what the
  experiment measures). ``block`` must divide ne0 and is otherwise unused:
  on the TPU it only changed the order of the DSS additions.
- ``mm3x_ref(a, m)``, the twin of `_mm3x`: with ``x_hi = bf16_rn(x)`` and
  ``x_lo = bf16_rn(x - x_hi)``, ``(a_hi m_hi + a_hi m_lo) + a_lo m_hi``. The
  halves are cast back to float32 before the products (each bf16 x bf16
  product is exact in f32), as JAX's ``preferred_element_type=f32`` does; a
  torch bf16 matmul would round every sum to bf16.

On a CUDA tensor ``fused3x_apply`` launches its kernel on PyTorch's current
stream or raises, and adds one to ``fused3x_apply.launches``; on a CPU
tensor it runs ``fused3x_apply_ref``. There is no fallback.

The driver checks K2 against fused_apply (full f32, the HIGHEST product of
the JAX package) and times fused_HI (fused_apply), fused_3x (K2) and mm_HI
(torch.matmul, TF32 off), interleaved, min over rounds:

    python -m pynama_tpu_torch.exp.mm3x [ne ngl] [--block B] [--nit N]
        [--rounds R] [--device cuda|cpu]

Defaults: 24^3 ngl=4, ncomp 3, block 1, 2000 applies per chain, 8 rounds,
device cuda.
"""
from __future__ import annotations

import sys

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
    ne = list(nelem) + [1] * (3 - dim)
    launch("pn_fused3x_f32", t.device, t.data_ptr(), matT.data_ptr(),
           u.data_ptr(), y.data_ptr(), E, int(t.shape[1]), ngl, ncomp_out,
           dim, ne[0], ne[1], ne[2])
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
