"""The control comes out not correct: the reference put in the program's
place in the nearest precision below the configuration's (float32 with
TF32 products, the mix's own CG settings) is failed by the harness's own
`judge` on every seed, while the program's answers pass it. On the CPU at
the fixture's tiny sizes; on the card at each cell's own size (`card`)."""
import json
import os

import pytest
import torch

from bench_paths import FIXTURE, ROOT
from harness import check
from harness.spec import load_cell

SEEDS = [2**31 + 3, 4_000_000_007, 12345]


def _failed(cell, device, control):
    """`judge`'s failed count of each seed's answer, program or control."""
    return [v["failed"] for _, _, v in
            check.readings(cell, SEEDS, device, control, log=print)]


@pytest.mark.parametrize("name", ["tiny2d.cg", "tiny2d.direct", "tiny3d.cg"])
def test_control_fails_program_passes_tiny(name):
    cell = load_cell(name, os.path.join(FIXTURE, "BENCHMARK.json"), FIXTURE)
    dev = torch.device("cpu")
    assert all(f > 0 for f in _failed(cell, dev, True))
    assert _failed(cell, dev, False) == [0] * len(SEEDS)


CELLS = [w["name"] for w in
         json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, card):
    cell = load_cell(name)
    failed = _failed(cell, card, True)
    print(name, "control failed", failed)
    assert all(f > 0 for f in failed)
