"""Where torch.profiler loses kernel records on a CUDA card. Each window
is padded: --pad fill_ kernels before the work and --pad abs_ kernels after
it, so a lost record is placed at the window's head, in its body or at its
tail. Windows are taken before and after a CUDA graph was captured in the
same process (chip_smoke's _graph_record), and with and without a pause of
--sleep seconds after the profiler's start and after the last kernel's end.

    python3 tools/profiler_windows.py [--pad 64] [--windows 5] [--sleep 0.05]
                                      [--keep-cupti]

--keep-cupti sets TEARDOWN_CUPTI=0 and DISABLE_CUPTI_LAZY_REINIT=1 before
torch is imported, so Kineto keeps CUPTI set up between profiler sessions
(what torch's profiler arranges when inductor captures CUDA graphs).

Two bodies: 20 calls of K1 (fused_apply) at the flagship's shape (24^3
ngl=4, 192 -> 192, float32), 40 kernels; and a burst of 600 K1 calls, each
followed by 38 elementwise adds, 24,000 kernels (about one flagship
rhs_local). Needs one CUDA card; prints one JSON line: per case the records
seen at head, body and tail of each window, against the launches.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

K1_CALLS, BURST_CALLS, BURST_ADDS = 20, 600, 38


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pad", type=int, default=64)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--sleep", type=float, default=0.05)
    ap.add_argument("--keep-cupti", action="store_true")
    a = ap.parse_args()
    if a.keep_cupti:
        os.environ["TEARDOWN_CUPTI"] = "0"
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch

    import chip_smoke
    from pynama_tpu_torch.ops.fused import fused_apply

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    nnc = 4 ** 3 * 3
    t = torch.as_tensor(rng.standard_normal((24 ** 3, nnc)),
                        dtype=torch.float32, device=dev)
    m = torch.as_tensor(rng.standard_normal((nnc, nnc)) / nnc,
                        dtype=torch.float32, device=dev)
    x = torch.zeros(1 << 20, device=dev)

    def k1():
        fused_apply(t, m, (24, 24, 24), 4, 3)

    def burst():
        for _ in range(BURST_CALLS):
            k1()
            for _ in range(BURST_ADDS):
                x.add_(1.0)

    def seen(fn, sleep):
        """Kernel records at the head, in the body and at the tail of one
        padded profiler window around fn."""
        act = torch.profiler.ProfilerActivity.CUDA
        with torch.profiler.profile(activities=[act]) as prof:
            time.sleep(sleep)
            for _ in range(a.pad):
                x.fill_(0.5)
            fn()
            for _ in range(a.pad):
                x.abs_()
            torch.cuda.synchronize()
            time.sleep(sleep)
        n = {"head": 0, "body": 0, "tail": 0}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                part = ("head" if "FillFunctor" in e.key else
                        "tail" if "abs" in e.key.lower() else "body")
                n[part] += int(e.count)
        return [n["head"], n["body"], n["tail"]]

    bodies = {"k1": (lambda: [k1() for _ in range(K1_CALLS)], 2 * K1_CALLS),
              "burst": (burst, BURST_CALLS * (2 + BURST_ADDS))}
    burst()
    torch.cuda.synchronize()
    out = {"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
           "pad": a.pad, "keep_cupti": a.keep_cupti, "launches": {k: n for k, (_, n) in bodies.items()}}
    for side in ("before_graph", "after_graph"):
        if side == "after_graph":
            for _ in range(2):
                chip_smoke._graph_record(torch, k1)
        for sleep in (0.0, a.sleep):
            for k, (fn, n) in bodies.items():
                rec = [seen(fn, sleep) for _ in range(a.windows)]
                out[f"{side} sleep={sleep} {k}"] = {
                    "head_body_tail": rec,
                    "body_whole": sum(r[1] == n for r in rec)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
