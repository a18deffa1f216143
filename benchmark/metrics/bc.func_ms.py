"""bc.func_ms: host milliseconds per rhs evaluation spent evaluating the
analytic-function boundary values on the unstructured route: the
program's `bc.func` spans (engine/local_engine.py _value_buffer, the loop
over the function sides, each side's field computed on the card at the
stage time) summed over the window, over the window's `rhs.eval`
spans. No synchronize: the host's cost of issuing the evaluation."""
import program_trace as pt

SPANS = pt.labels("rhs.eval", "bc.func")


def prepare(program, profile):
    return pt.start()


def read(rec):
    recs = pt.window(rec, rec.prepared.get("bc.func_ms"))
    n = sum(1 for r in recs if r.name == "rhs.eval")
    func = [r.seconds for r in recs if r.name == "bc.func"]
    return 1e3 * sum(func) / n if n and func else None
