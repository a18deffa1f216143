"""Native (host C++) layer: mesh/graph helpers and the async binary writer.

Port of pynama_tpu/native: `meshkernel.cpp` (this package's own copy) is
compiled with g++ at first use into `pynama_tpu_torch/_build/`, named by a
hash of the source and the flags, and bound through ctypes. Nothing here
runs on the GPU, and nothing is built at import time.

Everything here has a numpy fallback of identical semantics, as in the
JAX package: the native path speeds up setup-time graph building on large
meshes and makes snapshot IO non-blocking; it is not a hard dependency. A
failed build is logged and the fallbacks run (`AsyncBinaryWriter.is_async`
then reads False). Set PYNAMA_NO_NATIVE=1 to force the fallbacks.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger("pynama_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "meshkernel.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"_meshkernel_{h.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    # compile to a unique temp path and os.replace() it into place, so two
    # concurrent processes (parallel pytest) never load a partly written .so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native build failed (%s); using numpy fallbacks", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("PYNAMA_NO_NATIVE"):
        return None
    path = _lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("native load failed (%s); using numpy fallbacks", e)
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_vp = ctypes.c_void_p
    lib.pn_unique_edges.restype = ctypes.c_int64
    lib.pn_unique_edges.argtypes = [c_i32p, ctypes.c_int64, c_i32p, c_i32p]
    lib.pn_cell_nodes.restype = None
    lib.pn_cell_nodes.argtypes = [c_i32p, c_i32p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, c_i32p]
    lib.pn_incidence_kmax.restype = ctypes.c_int64
    lib.pn_incidence_kmax.argtypes = [c_i32p, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.pn_incidence_fill.restype = None
    lib.pn_incidence_fill.argtypes = [c_i32p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      c_i32p]
    lib.pn_writer_create.restype = c_vp
    lib.pn_writer_create.argtypes = [ctypes.c_int64]
    lib.pn_writer_submit.restype = None
    lib.pn_writer_submit.argtypes = [c_vp, ctypes.c_char_p, c_vp,
                                     ctypes.c_int64]
    lib.pn_writer_flush.restype = None
    lib.pn_writer_flush.argtypes = [c_vp]
    lib.pn_writer_destroy.restype = None
    lib.pn_writer_destroy.argtypes = [c_vp]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --------------------------------------------------------------- mesh graph
def unique_edges(cells_tensor: np.ndarray):
    """-> (edges (E,2) int32 sorted pairs in lex order, cell_edges (C,4)).

    Native or numpy; both number edges identically (lexicographic)."""
    cells = np.ascontiguousarray(cells_tensor, dtype=np.int32)
    C = len(cells)
    lib = _load()
    if lib is not None:
        edges = np.empty((4 * C, 2), dtype=np.int32)
        cell_edges = np.empty((C, 4), dtype=np.int32)
        ne = lib.pn_unique_edges(_ptr(cells), C, _ptr(edges),
                                 _ptr(cell_edges))
        return edges[:ne].copy(), cell_edges
    pairs = np.concatenate([cells[:, [0, 1]], cells[:, [2, 3]],
                            cells[:, [0, 2]], cells[:, [1, 3]]], axis=0)
    keys = np.sort(pairs, axis=1)
    edges, inverse = np.unique(keys, axis=0, return_inverse=True)
    # reorder from [slotA cells..., slotB cells...] to (C, 4) slot-major
    return (edges.astype(np.int32),
            inverse.reshape(4, C).T.astype(np.int32))


def cell_nodes(cells_tensor, cell_edges, n_vertices, n_edges, ngl):
    """(C, ngl^2) int32 high-order node table (see meshkernel.cpp), or
    None without the native library (the caller uses its own loop)."""
    cells = np.ascontiguousarray(cells_tensor, dtype=np.int32)
    ce = np.ascontiguousarray(cell_edges, dtype=np.int32)
    C = len(cells)
    lib = _load()
    if lib is None:
        return None
    out = np.empty((C, ngl * ngl), dtype=np.int32)
    lib.pn_cell_nodes(_ptr(cells), _ptr(ce), C, int(n_vertices),
                      int(n_edges), int(ngl), _ptr(out))
    return out


def build_incidence(cell_nodes_arr: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_nodes, kmax) padded fan-in table (pad = total slots)."""
    cn = np.ascontiguousarray(cell_nodes_arr, dtype=np.int32)
    total = cn.size
    lib = _load()
    if lib is not None:
        flat = cn.reshape(-1)
        kmax = lib.pn_incidence_kmax(_ptr(flat), total, int(n_nodes))
        out = np.empty((n_nodes, kmax), dtype=np.int32)
        lib.pn_incidence_fill(_ptr(flat), total, int(n_nodes), kmax,
                              _ptr(out))
        return out
    from pynama_tpu_torch.mesh.box import build_incidence as np_build
    return np_build(cn, n_nodes)


# ------------------------------------------------------------ async writer
class AsyncBinaryWriter:
    """Background double-buffered raw writer (C++ worker thread).

    submit() copies the array and returns immediately; flush() blocks until
    everything submitted has hit disk. Without the native library it
    writes synchronously (logged; `is_async` is False).
    """

    def __init__(self, max_queue: int = 4):
        self._lib = _load()
        self._h = self._lib.pn_writer_create(max_queue) \
            if self._lib is not None else None
        if self._h is None:
            logger.warning("native library unavailable: snapshots are "
                           "written synchronously")

    @property
    def is_async(self) -> bool:
        return self._h is not None

    def submit(self, path: str, array: np.ndarray):
        a = np.ascontiguousarray(array)
        if self._h is None:
            a.tofile(path)
            return
        self._lib.pn_writer_submit(
            self._h, path.encode(), a.ctypes.data_as(ctypes.c_void_p),
            a.nbytes)

    def flush(self):
        if self._h is not None:
            self._lib.pn_writer_flush(self._h)

    def close(self):
        if self._h is not None:
            self._lib.pn_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
