"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`: each compared number beside its limit); the compared
numbers are also the last lines of standard error. --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer ones. The run exits
non-zero with no result line when the card is missing, when the solver
fails, or when a module of the JAX package or JAX itself is loaded.

Build and kernel caches stay at fixed paths inside the checkout: the
solver's K1 library in `pynama_tpu_torch/_build/` (built by the first run
in a checkout, whose set-up therefore compiles), and `TORCH_EXTENSIONS_DIR`
and `TRITON_CACHE_DIR` under `benchmark/_cache/`. Traces go to
`benchmark/_out/`.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(BENCH, "_cache", sub)
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)

    from harness.spec import load_cell
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} card(s): "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" device(s)", file=sys.stderr)
        return 2

    from harness.cell import forbidden_modules, run_cell
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START, out_dir=os.path.join(BENCH, "_out"),
                      log=log)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
