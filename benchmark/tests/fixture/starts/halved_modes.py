"""A start builder only this fixture defines (it shows a configuration's
start state found by the name its file gives): the benchmark's
`modes_at_rest` with the vorticity halved."""
from harness.spec import load_named


def build(case, coords, mix, seed):
    w, v = load_named("starts", "modes_at_rest").build(case, coords, mix,
                                                       seed)
    return 0.5 * w, v
