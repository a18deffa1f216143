"""setup.problem_s: seconds of `Problem.setUp` (cases/problem.py): the sum
of its `setup_phases` (mesh, BCs, operators, KLE solver, engine, initial
conditions), each ended by a synchronize of the card, so the device work
a phase queued counts in it. The rest of setup_s is the imports, the
start state and the warm rhs."""


def prepare(program, profile):
    phases = getattr(program.problem, "setup_phases", None)
    return sum(phases.values()) if phases else None


def read(rec):
    return rec.prepared.get("setup.problem_s")
