"""setup.assemble_s: seconds the direct route's set-up spends assembling
the dense masked K on the host, summed over its two systems (the free-slip
stage and the main one). Reads `KLESystem.setup_s["assemble"]`, the
program's own host clock around the numpy assembly (solver/kle.py
`build_system`). Nothing to read on an iterative route."""


def prepare(program, profile):
    p = program.problem
    if p.solver_method != "direct":
        return None
    return sum(s.setup_s.get("assemble", 0.0)
               for s in (p.kle.main, p.kle.fs) if s)


def read(rec):
    return rec.prepared.get("setup.assemble_s")
