"""Global framework configuration and the float32 precision pins.

The KLE operator is stiff: lambda_min/||K|| = 6e-4 (DESIGN §3), so a
matmul that rounds its inputs to TF32 (10 mantissa bits) perturbs K by
~1e-3·||K|| and can make it indefinite — CG then diverges. Importing this
module therefore pins every float32 matmul and convolution PyTorch runs to
full float32, the counterpart of the JAX package's Precision.HIGHEST
(pynama_tpu/ops/local.py:38-42).

Setup-time element/basis math is always numpy float64; the runtime dtype
(default float32) is applied when arrays move to the device. The device is
never guessed: `Problem` and `build_engine` take it explicitly.
"""
from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    #: runtime dtype for fields and operators on the device
    dtype: torch.dtype = torch.float32
    #: linear solver: "cg" (matrix-free PCG), "gmres" (restarted GMRES),
    #: "direct" (dense Cholesky), or "auto" (direct at or below
    #: direct_max_dofs velocity dofs, cg above)
    solver: str = "auto"
    #: dense-direct threshold (number of velocity dofs)
    direct_max_dofs: int = 40_000
    #: CG relative/absolute tolerance and iteration cap
    cg_rtol: float = 1e-12
    cg_atol: float = 0.0
    cg_maxiter: int = 2000


_config = FrameworkConfig()


def device_of(name: str, flag: str = "--device") -> torch.device:
    """The torch device `name` names, given on the command line as `flag`;
    cuda without a card raises (the device is never guessed, and a run
    asked for on the card never carries on on the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{flag} {name}: torch.cuda.is_available() is False (the plain "
            f"versions run with {flag} cpu)")
    return dev


def get_config() -> FrameworkConfig:
    return _config


def set_config(**kwargs) -> FrameworkConfig:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config
