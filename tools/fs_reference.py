"""The JAX package's FS-stage analyses at full precision, and the port's
gap to them on the CPU: the constants and the limit of chip_smoke.py's
phase 18 (`analyses`).

    python tools/fs_reference.py [--spectrum 3 4] [--walls 2]
        [--woodbury 3] [--no-port]

Runs the JAX package's exp/fs_spectrum.py, fs_walls.py and fs_woodbury.py
(imported as `exp.*` from the repo root) in float64 on the CPU, recording
what their `analyze` computes at full precision rather than as printed:
fs_spectrum's eigenvalue arrays (through its `effective_kappas`, which its
`analyze` calls on each), fs_walls' per-variant eigenvalues (through its
`report`) and fs_woodbury's CG iteration counts (through its `pcg_np`).
The eigenvalues become records by the port's own arithmetic
(`fs_spectrum.spectrum_record`, `fs_walls.summary`), so that a gap is one
of eigenvalues, not of formulas. Then, unless --no-port, it runs the
port's `analyze` on the same sizes, float64 on the CPU (the plain
versions), and prints each pair's gap: the largest relative difference of
their floats (`fs_spectrum.record_gap`) and the counts that differ. The
two runs differ only in the order of their sums (LAPACK through numpy
against torch, the FDM apply's contractions).

Last, it prints the JAX records as chip_smoke.py holds them
(`chip_smoke.fs_digest`): its FS_REF.
"""
import argparse
import contextlib
import importlib
import io
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from pynama_tpu_torch.exp import fs_spectrum as PS  # noqa: E402
from pynama_tpu_torch.exp import fs_walls as PW  # noqa: E402
from pynama_tpu_torch.exp import fs_woodbury as PB  # noqa: E402


@contextlib.contextmanager
def recording(module, name, record):
    """Replace module.name by a function that passes its arguments and
    result to record(args, result) and returns the result."""
    orig = getattr(module, name)

    def wrapped(*a, **k):
        out = orig(*a, **k)
        record(a, out)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def jax_module(name):
    cwd = os.getcwd()
    os.chdir(ROOT)                  # the scripts import `exp.*` from "."
    try:
        return importlib.import_module(f"exp.{name}")
    finally:
        os.chdir(cwd)


def jax_spectrum(ne, ngl=4, stdout=None):
    """The JAX fs_spectrum.analyze's numbers at ne^3: {"FS": {"free",
    "jacobi", "fdm"}, "MAIN": ...}, records of its eigenvalues. What it
    prints goes to stdout (a text stream; default: dropped); so in the two
    below."""
    m = jax_module("fs_spectrum")
    lams = []
    with recording(m, "effective_kappas",
                   lambda a, out: lams.append(np.asarray(a[0]))), \
            contextlib.redirect_stdout(stdout or io.StringIO()):
        m.analyze(ne, ngl)
    assert len(lams) == 4, len(lams)
    return {tag: {"free": int(lams[2 * i].size),
                  "jacobi": PS.spectrum_record(lams[2 * i]),
                  "fdm": PS.spectrum_record(lams[2 * i + 1])}
            for i, tag in enumerate(("FS", "MAIN"))}


def jax_walls(ne, stdout=None):
    """The JAX fs_walls.analyze's variants at ne^3: {tag: summary}."""
    m = jax_module("fs_walls")
    out = {}
    with recording(m, "report",
                   lambda a, _: out.update({a[0]: PW.summary(a[1])})), \
            contextlib.redirect_stdout(stdout or io.StringIO()):
        m.analyze(ne)
    return {"variants": out}


def jax_woodbury(ne, stdout=None):
    """The JAX fs_woodbury.analyze's CG iteration counts at ne^3, in the
    port's keys."""
    m = jax_module("fs_woodbury")
    its = []
    with recording(m, "pcg_np", lambda a, out: its.append(int(out[1]))), \
            contextlib.redirect_stdout(stdout or io.StringIO()):
        m.analyze(ne)
    keys = ("K/jacobi", "K/Sinv", "G/I", "G/diag", "G/qp-block(4)",
            "G/elem-block(108)")
    return {"iters": dict(zip(keys, its))}


def port(analysis, ne, stdout=None):
    with contextlib.redirect_stdout(stdout or io.StringIO()):
        return analysis.analyze(ne, 4, device=torch.device("cpu"),
                                dtype=torch.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spectrum", type=int, nargs="*", default=[3, 4])
    ap.add_argument("--walls", type=int, nargs="*", default=[2])
    ap.add_argument("--woodbury", type=int, nargs="*", default=[3])
    ap.add_argument("--no-port", action="store_true")
    args = ap.parse_args()
    ref = {"spectrum": {}, "walls": {}, "woodbury": {}}
    parts = (("spectrum", args.spectrum, jax_spectrum, PS,
              lambda r: {k: r[k] for k in ("FS", "MAIN")}),
             ("walls", args.walls, jax_walls, PW,
              lambda r: {"variants": r["variants"]}),
             ("woodbury", args.woodbury, jax_woodbury, PB,
              lambda r: {"iters": r["iters"]}))
    for part, sizes, jax_fn, analysis, keep in parts:
        for ne in sizes:
            t0 = time.perf_counter()
            rec = jax_fn(ne)
            line = {"part": part, "ne": ne,
                    "jax_s": time.perf_counter() - t0}
            ref[part][ne] = chip_smoke.fs_digest(part, rec)
            if not args.no_port:
                t0 = time.perf_counter()
                mine = keep(port(analysis, ne))
                gap, bad = PS.record_gap(mine, rec)
                line.update(port_s=time.perf_counter() - t0, gap=gap,
                            counts_differ=bad)
                if part == "spectrum":
                    line["census_margin"] = min(
                        rec[s][pc]["margin"] for s in ("FS", "MAIN")
                        for pc in ("jacobi", "fdm"))
            print(json.dumps(line), flush=True)
    print("FS_REF = " + repr(ref))


if __name__ == "__main__":
    main()
