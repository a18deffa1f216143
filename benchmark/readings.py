"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the lower-precision control's.

    python3 benchmark/readings.py --workload <cell> --seeds S [S ...]
        [--controls N] [--device cuda]

One process, through `harness/check.py`'s `readings`: the program is set
up once and runs one replay of the segment per seed (the timed path, at
the cell's own size); then, with the program freed, `judge` holds each
answer to the float64 reference, and for the first N seeds the control
(the reference in float32 with TF32 products and the mix's CG settings)
marches the segment in the program's place and is judged the same way.
One JSON line per reading (its numbers, and whether `judge` failed it),
then a summary line with the largest program reading and the smallest
control reading of each number. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec", default=None)
    args = ap.parse_args(argv)

    import torch
    from harness import check
    from harness.spec import load_cell

    bench_dir = os.path.dirname(args.spec) if args.spec else None
    cell = load_cell(args.workload, spec_path=args.spec, bench_dir=bench_dir)
    dev = torch.device(args.device)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    rows = []
    for side, seeds, control in (("program", args.seeds, False),
                                 ("control", args.seeds[:args.controls],
                                  True)):
        for seed, ans, v in check.readings(cell, seeds, dev, control, log):
            row = {"seed": seed, "side": side, **v["numbers"],
                   "compared": v["compared"], "failed": v["failed"],
                   "reference_s": v["reference_s"]}
            if not isinstance(ans, Exception):
                row.update(t=ans[0], steps=ans[1])
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for k in check.NUMBERS:
        prog = [r[k] for r in rows if r["side"] == "program"]
        ctl = [r[k] for r in rows if r["side"] == "control"]
        summary[k] = {"program_max": max(prog), "control_min":
                      min(ctl) if ctl else None}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "program_failed": sum(r["failed"] for r in rows
                                            if r["side"] == "program"),
                      "control_failed": sum(r["failed"] > 0 for r in rows
                                            if r["side"] == "control")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
