"""Source checks of the port's CUDA kernels (pynama_tpu_torch/csrc/), no nvcc
needed: no TF32 anywhere, inline PTX only in ptx.cuh, and the C entry points
match the ctypes signatures that ops/_build.py binds."""
import glob
import os
import re

import pytest
import torch

from pynama_tpu_torch.ops import _build

torch.set_num_threads(1)

SOURCES = sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))
                 + glob.glob(os.path.join(_build.CSRC, "*.cuh")))
NAMES = [os.path.basename(p) for p in SOURCES]
# TF32 would cut the f32 products to 10 mantissa bits (DESIGN §3)
TF32 = re.compile(r"\.tf32|cvt\.rna\.tf32|precision::tf32")


def _read(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


def _extern_c_functions(src):
    """Names of the functions defined inside the `extern "C" { ... }`
    blocks of a source."""
    names = []
    for m in re.finditer(r'extern "C" \{', src):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        block = src[m.end():i - 1]
        names += re.findall(r"(?m)^[A-Za-z_][\w \*]*?\b(\w+)\([^;{]*\)\s*\{",
                            block)
    return names


def test_sources_found():
    assert {"fused_common.cuh", "fused_apply.cu", "decomp.cu", "ptx.cuh",
            "fused3x.cu"} <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_no_tf32(name):
    assert not TF32.search(_read(name))


@pytest.mark.parametrize("name", NAMES)
def test_inline_ptx_only_in_ptx_header(name):
    has_asm = re.search(r"\basm\b", _read(name)) is not None
    assert has_asm == (name == "ptx.cuh")


@pytest.mark.parametrize("name", [n for n in NAMES if n.endswith(".cu")])
def test_entry_points_have_signatures(name):
    """Every extern "C" function is bound by load_library."""
    for fn in _extern_c_functions(_read(name)):
        assert fn in _build.SIGNATURES or fn == "pn_cuda_error_string", fn


@pytest.mark.parametrize("symbol", sorted(_build.SIGNATURES))
def test_signature_is_defined(symbol):
    """Every SIGNATURES entry is an extern "C" function of one source."""
    defined = [n for n in NAMES if n.endswith(".cu")
               and symbol in _extern_c_functions(_read(n))]
    assert len(defined) == 1, (symbol, defined)


def test_extern_c_parser():
    src = ('namespace {\nint hidden(int a) { return a; }\n}\n'
           'extern "C" {\n// comment\nint pn_a(const void* t, int64_t M,\n'
           '         void* s) {\n  if (M) { return 1; }\n  return 0;\n}\n'
           'const char* pn_b(int c) {\n  return "x";\n}\n}  // extern "C"\n')
    assert _extern_c_functions(src) == ["pn_a", "pn_b"]
