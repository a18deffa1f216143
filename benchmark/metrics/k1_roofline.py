"""k1_roofline: the operator applications' share of their roofline, in
percent, over the profiled rhs range: the least time the card could take
for the applications made (10 fixed ones per rhs of a two-stage solve
plus every CG loop application, each at its own shape, `counts.py`)
over the device time of the kernels that probe calls of K1 (`fused_apply`
at each engine shape, profiled once after set-up) launch, as the
profiler times them. Counting the work from the applications keeps the
share on the same work whatever implements them."""
import counts

SPANS = {"rhs": {"targets": [
    ("pynama_tpu_torch.cases.problem", "rhs_local"),
    ("pynama_tpu_torch.cases.problem", "Problem.rhs")]},
    "cg": {"targets": [
        ("pynama_tpu_torch.engine.local_engine", "pcg"),
        ("pynama_tpu_torch.solver.kle", "pcg")],
        "info": ("loop_applies", "iters")}}


def prepare(program, profile):
    """K1's kernel names and the engine's geometry, or None where the
    route has no fused engine or nothing is profiled."""
    ops = getattr(program.problem, "engine_ops", None)
    if profile is None or ops is None or not ops.fused:
        return None
    import torch
    from pynama_tpu_torch.ops.fused import fused_apply
    mats = {(ops.dim, ops.dim): ops.KT, (ops.dim_w, ops.dim): ops.RwT,
            (ops.dim, ops.dim_w): ops.curlT, (ops.dim, ops.dim_s): ops.srtT,
            (ops.dim_s, ops.dim): ops.divT}
    E = ops.free_main.shape[0]
    probes = [(torch.zeros((E, m.shape[0]), dtype=m.dtype, device=m.device),
               m, cout) for (_, cout), m in mats.items()]
    names = {r.name for r in profile(lambda: [
        fused_apply(t, m, ops.nelem, ops.ngl, c)
        for t, m, c in probes]).records}
    return {"names": names, "nelem": ops.nelem, "ngl": ops.ngl,
            "dim": ops.dim, "two_stage": ops.is_ns,
            "dtype": program.cell.config["precision"]}


def read(rec):
    k1 = rec.prepared.get("k1_roofline")
    if rec.trace is None or not k1 or not k1["names"]:
        return None
    n_rhs = sum(1 for s in rec.profiled if s.name == "rhs")
    loop = sum(s.info["loop_applies"] for s in rec.profiled
               if s.name == "cg")
    apps = counts.rhs_applications(k1["dim"], k1["two_stage"]) * n_rhs \
        + [(k1["dim"], k1["dim"])] * loop
    bound = sum(counts.apply_bound_s(k1["nelem"], k1["ngl"], cin, cout,
                                     k1["dtype"]) for cin, cout in apps)
    t = rec.trace.device_s(names=k1["names"])
    return 100.0 * bound / t if t > 0 and bound > 0 else None
