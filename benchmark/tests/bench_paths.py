"""Where the benchmark's tests find its files; importing this puts the
repository root and `benchmark/` on `sys.path`."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FIXTURE = os.path.join(BENCH, "tests", "fixture")
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)
