"""pynama_tpu_torch — the PyTorch/CUDA port of pynama_tpu.

The vorticity-velocity KLE solver on GLL spectral elements, run with
PyTorch on an NVIDIA GPU. Module paths and names follow the JAX package
(`pynama_tpu`), which stays the reference; inside, the idiom is PyTorch's:
plain functions on tensors, frozen dataclasses of tensors for operator
bundles, an explicit device and dtype.

The one operator-application kernel, `ops/fused.py::fused_apply`
(y = DSS(t @ matT) on a box mesh), is hand-written CUDA C++ for Hopper
(`csrc/fused_apply.cu`), compiled by nvcc at first use. So are the
measurement kernels of `exp/` that split its time (`csrc/decomp.cu`,
`csrc/fused3x.cu`, sharing `csrc/fused_common.cuh`). CPU tensors take each
kernel's plain PyTorch version.

This package never imports jax or pynama_tpu.
"""

__version__ = "0.1.0"

from pynama_tpu_torch.config import FrameworkConfig, get_config, set_config
