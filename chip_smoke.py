"""GPU smoke run of pynama_tpu_torch: build the kernels, check them, drive
the main path, the analytic-function case, the FDM preconditioner and the
decomposition drivers at full size.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc; it
builds `pynama_tpu_torch/csrc/` into `pynama_tpu_torch/_build/` on first
use. Phases, each printing its own line; any failure raises and the script
exits non-zero without the final result line:

1. device   the card, its power limit, torch and CUDA versions
2. build    nvcc build of the kernel library (seconds, ptxas register use)
3. kernels  fused_apply's CUDA kernel against its plain PyTorch version on
            the card, at every operator shape of the engine (3D ngl=4 24^3,
            3D ngl=3 25^3, 3D ngl=7 8^3, 2D ngl=3 50x50, degenerate
            extents), float32 and
            float64: y and bnd each within max|err|/max|ref| <= 1e-5 (f32) /
            1e-12 (f64), and every duplicated slot bitwise equal; its DSS
            pass alone (dss_pass) on a random u bitwise equal to the plain
            DSS of that u, y and bnd, and its plan equal to
            ops.fused.dss_tile_plan's; kernel and plain times at the 24^3
            ngl=4 and 25^3 ngl=3 shapes (TIMED): CUDA-event medians around
            single calls (`ms`, host enqueue included) and device time per
            call from torch.profiler over 20 calls (`device_us`, every
            kernel the call launches; `dss_device_us`, the DSS pass's
            share), which ranks kernel against plain, beside the bound
            (`bound_ms`); then the DSS pass
            at 24^3 ngl=4 over chunk lengths DSS_CHUNKS (device time, each
            checked bitwise)
3b. decomp  the decomposition kernels against their plain versions at the
            same shapes: K4 plainmm_apply and K3 variant_apply (blocks 1, 2
            and ne0, both do_rolls; f32 and f64, same limits; duplicate
            slots or seam pairs bitwise equal), K2 fused3x_apply (f32, same
            limit, duplicate slots bitwise equal, <= 5e-5 from fused_apply,
            its GEMM's plan equal to exp.mm3x.gemm3x_plan's);
            kernel and plain times at the 24^3 ngl=4 shapes (K4 also
            beside cuBLAS, `library_ms`; K2 also with its GEMM alone,
            `gemm3x_device_us`, beside that GEMM's bytes bound); a GEMM sweep
            of plainmm_apply over M in GEMM_M and (K, N) in GEMM_KN plus two
            misaligned views, f32 and f64, printing each case's loader and
            tile and failing unless both loaders ran in both dtypes; the
            same sweep of K2's GEMM (exp.mm3x.gemm3x against mm3x_ref, plus
            GEMM3X_KN), failing unless every tile width, resident and
            streamed, and both loaders ran; then the
            two drivers exp.fused_decomp and exp.mm3x at 24^3 ngl=4 (200
            applies per chain, 3 rounds), with each kernel's launch count
            set to 0 just before them and read just after
4. parity   small f64 cases, each one rhs_local and a 3-step transient on
            the GPU (kernel) against the CPU (plain version), relative
            error <= 1e-9, same accepted steps: the 3D no-slip cavity (3^3
            ngl=3), the 3D Taylor-Green case (3^3 ngl=3), the flat plate
            with mixed walls (4^2 ngl=3 from t=0.1) and the cavity under
            pc="fdm"
5. main     the flagship no-slip 3D lid-driven cavity (24^3 elements,
            ngl=4, float32, CG rtol 1e-6): Problem.setUp() and 2 accepted
            adaptive steps through start_solver(); prints setup phases,
            seconds per step, CG iterations per solve, kernel launches (which
            must account for every operator application) and peak memory
6. rhs_trace one warm rhs_local of the flagship after phase 5's steps,
            timed untraced (median of 3) and traced once with
            torch.profiler: the device-busy, K1 and other-kernel (CG
            vectors, BC writes, vtensv) shares of its untraced wall time;
            K1's launches in the trace must be 2 per operator application
            (a trace short of them lost records and is taken again, 3 times
            at most)
7. cg_split the flagship's free-slip-stage system after those steps, solved
            by solver.cg.pcg (rtol 1e-6) once with apply_K through K1 and
            once through K2, same b and x0: iterations, loop applies and
            the true residual (float64 operator) of each; a record, no gate
8. taylor_green3d
            the 3D Taylor-Green case file at full width (25^3 elements,
            ngl=3, custom-func boundary and initial conditions, float32, CG
            rtol 1e-6): setUp and 3 accepted steps; setup phases, s/step, CG
            iterations, K1 launches against the expected count, peak memory
            and the relative max-norm vorticity error against the analytic
            field at the end time, which must be <= TG3D_ERR_LIMIT
9. fdm      the flagship's config built with pc="jacobi" and pc="fdm", one
            cold two-stage solve each from the curl of a numpy-seeded random
            velocity, K1's launches in it against the expected count: in
            f64 (CG rtol 1e-10) the velocities agree to 1e-6 and FDM takes
            fewer iterations on both stages; in f32 (rtol 1e-6) a record:
            iterations, CUDA-event ms per solve (median of 3), and per call
            of the FDM apply and of K1 the event ms and, from one call
            captured in a CUDA graph, its kernel and copy nodes and the
            device µs of graph replays (`_graph_record`); the FDM apply's
            per-mode block step alone, broadcast against einsum; the FDM
            setup seconds

The last three lines are the card's name and power limit (nvidia-smi), the
record of the four kernels as JSON and the result line
{"ok": true, "device": {...}}. A kernel's `bound_ms` is the larger of the
operations of its function over the card's peak rate for their type and its
bytes (each input read once, each output written once) over the memory rate,
from the H100 SXM data-sheet peaks below.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

F32_LIMIT = 1e-5     # max|err|/max|ref|, float32 (tests/test_fused.py)
F64_LIMIT = 1e-12
PARITY_LIMIT = 1e-9
# the taylor_green3d phase's vorticity error limit: twice the JAX package's own
# relative max-norm error at the same config and end time, f64 on the CPU
# (`python tools/tg3d_reference_error.py`: TG3D_REF_ERR, in 3 steps to
# TG3D_REF_T, the end time this phase's 3 steps reached on an NVIDIA H100
# 80GB HBM3)
TG3D_REF_ERR = 0.043948261261991015
TG3D_REF_T = 0.013183098548825902
TG3D_ERR_LIMIT = 2 * TG3D_REF_ERR
# the fdm phase: f64 jacobi and fdm solutions agree to this, relative
FDM_AGREE_LIMIT = 1e-6
# the decomposition drivers: the flagship shape, depth cut to 200 applies
# per chain and 3 rounds
DRIVER_ARGS = ["24", "4", "--nit", "200", "--rounds", "3"]
SPLIT_LIMIT = 5e-5   # fused3x vs fused_apply: the bf16 split's own error
                     # (~7e-6 on the CPU), with margin
DEVICE_CALLS = 20    # calls per profiled device time
PAD_KERNELS = 256    # filler kernels at each end of a profiler window
# the GEMM sweep: row counts around the 64- and 128-row tiles and the
# flagship's E, at every (K, N) the engine gives the GEMM
GEMM_M = [1, 63, 64, 127, 129, 13824]
GEMM_KN = [(9, 18), (27, 18), (192, 192), (192, 384), (384, 192),
           (1029, 2058)]
# more (K, N) for the sweep of K2's GEMM: streamed matT halves at the
# 32-column tile, and N <= 96 on the 192-column tile, which no engine shape
# gives
GEMM3X_KN = [(2058, 18), (1029, 96)]
GEMM3X_M = [129, 1000]
# every (tile columns, resident, bytes per copy of t) of K2's GEMM
GEMM3X_PATHS = {(32, 1, 4), (192, 1, 16), (192, 1, 4), (32, 0, 4),
                (192, 0, 4), (192, 0, 16)}
# chunk lengths of the DSS sweep (0: make_dss_plan's rule)
DSS_CHUNKS = [0, 2, 3, 4, 6, 8, 12, 24]
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s; FLOP/s of FP32
# outside the tensor cores (FFMA), of the FP64 tensor cores (DMMA) and of
# bf16 on the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}

# (label, nelem, ngl, [(ncomp_in, ncomp_out), ...]) — every (nnc_in,
# nnc_out) pair the engine applies: K v->v, Rw w->v, curl v->w, srt v->s,
# div s->v
SHAPES = [
    ("3d-ngl4-24^3", (24, 24, 24), 4, [(3, 3), (3, 6), (6, 3)]),
    # the 3D Taylor-Green case file's mesh (taylor_green3d phase)
    ("3d-ngl3-25^3", (25, 25, 25), 3, [(3, 3), (3, 6), (6, 3)]),
    ("3d-ngl7-8^3", (8, 8, 8), 7, [(3, 3), (3, 6), (6, 3)]),
    ("2d-ngl3-50^2", (50, 50), 3, [(2, 2), (1, 2), (2, 1), (2, 3), (3, 2)]),
    ("3d-ngl3-1x2x2", (1, 2, 2), 3, [(3, 1)]),
    ("3d-ngl4-4x1x2", (4, 1, 2), 4, [(3, 3)]),
    ("3d-ngl2-2^3", (2, 2, 2), 2, [(3, 3)]),
]
# shapes at which phase 3 times K1 against its plain version and its bound
TIMED = ("3d-ngl4-24^3", "3d-ngl3-25^3")


def _bound(flops, peak, nbytes):
    """(bound_ms, bound_by): the larger of flops over the peak rate and
    nbytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _gemm_bound(E, K, N, dtype_name, nbytes_out_extra=0, products=1,
                peak=None):
    """Bound of y = f(t @ matT) with t (E, K), matT (K, N), y (E, N) and
    nbytes_out_extra more bytes of output, products GEMMs of its FLOPs."""
    eb = 8 if dtype_name == "float64" else 4
    return _bound(products * 2 * E * K * N,
                  peak or PEAK_FLOPS[dtype_name],
                  (E * K + K * N + E * N) * eb + nbytes_out_extra)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cavity_config(nelem, ngl, rho, mu, lid, max_steps, end_time):
    zero = [0] * len(nelem)
    sides = ("up", "down", "left", "right", "back", "front")
    return {
        "name": "cavity3d",
        "material-properties": {"rho": rho, "mu": mu},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": zero, "upper": [1] * len(nelem)}},
        "time-solver": {"start-time": 0, "end-time": end_time,
                        "max-steps": max_steps},
        "boundary-conditions": {"no-slip": {
            s: (lid if s == "up" else zero) for s in sides}},
        "initial-conditions": {"vorticity": [0, 0, 0]},
    }


def tg3d_config(nelem, ngl, max_steps):
    """pynama_tpu/cases/yaml/taylor-green3d.yaml (25^3 elements, ngl=3, rho
    0.5, mu 0.01, taylor_green3d on every side, as initial condition and as
    the exact solution), with the mesh and the step count given."""
    cf = {"custom-func": {"name": "taylor_green3d",
                          "attributes": ["velocity", "vorticity", "alpha"]}}
    return {
        "name": "taylor-green3d",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": [0, 0, 0], "upper": [1, 1, 1]}},
        "time-solver": {"max-steps": max_steps, "start-time": 0,
                        "end-time": 10},
        "boundary-conditions": cf, "initial-conditions": cf, "tests": cf,
    }


def fsns_config(nelem, ngl, start, max_steps):
    """pynama_tpu/cases/yaml/flat-plate-FSNS.yaml (rho 0.5, mu 0.01; no-slip
    plate [0, 1] at the bottom, the flat_plate solution as free-slip values
    on the other sides) with the mesh, start time and step count given."""
    fp = {"custom-func": {"name": "flat_plate"}}
    return {
        "name": "flat-plate-FSNS",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": [0, 0], "upper": [1, 1]}},
        "time-solver": {"max-steps": max_steps, "start-time": start,
                        "end-time": start + 1.0},
        "boundary-conditions": {"no-slip": {"down": [0, 1]},
                                "free-slip": {"left": fp, "right": fp,
                                              "up": fp}},
        "initial-conditions": fp, "tests": fp,
    }


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    return card


def phase_build():
    from pynama_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    regs = [ln.strip() for ln in _build.last_build_log.splitlines()
            if "registers" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.last_build_seconds, ptxas=regs)


def _dup_spread(torch, y, cell_nodes, ncomp):
    """max over global dofs of (max - min) over the dof's slots."""
    cn = torch.as_tensor(cell_nodes.ravel(), device=y.device,
                         dtype=torch.int64)
    gid = (cn.repeat_interleave(ncomp) * ncomp
           + torch.arange(ncomp, device=y.device).repeat(cn.numel()))
    n = int(cn.max()) * ncomp + ncomp
    flat = y.reshape(-1)
    hi = torch.full((n,), -float("inf"), dtype=y.dtype, device=y.device)
    lo = torch.full((n,), float("inf"), dtype=y.dtype, device=y.device)
    hi = hi.scatter_reduce(0, gid, flat, "amax")
    lo = lo.scatter_reduce(0, gid, flat, "amin")
    return float((hi - lo).max())


def _median_ms(torch, fn, reps=30, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _padding(torch):
    """The filler kernel _profile pads its windows with (fill_ of an int16
    buffer of its own) and its profiler keys, learnt once from a window of
    fillers alone: (fill, keys)."""
    if not _PAD:
        buf = torch.zeros(256, dtype=torch.int16, device="cuda")
        act = torch.profiler.ProfilerActivity.CUDA
        for _ in range(3):
            with torch.profiler.profile(activities=[act]) as prof:
                for _ in range(2 * PAD_KERNELS):
                    buf.fill_(1)
                torch.cuda.synchronize()
            keys = {e.key for e in prof.key_averages()
                    if e.self_device_time_total > 0}
            if keys:
                break
        check(len(keys) == 1, f"filler kernels seen as {sorted(keys)}")
        _PAD.update(fill=lambda: buf.fill_(1), keys=keys)
    return _PAD["fill"], _PAD["keys"]


_PAD = {}


def _profile(torch, fn, calls=DEVICE_CALLS, tries=3, whole=True):
    """Per kernel name (its first 60 characters; instantiations that share
    them are summed): device µs and launches per call of fn, from the self
    device time and count of every kernel that `calls` calls launch
    (torch.profiler, CUDA activity). On the H100 machine the profiler drops
    the first few kernel records of a window and now and then a few of the
    last (up to 6 and 8 of them in tools/profiler_windows.py's 40 padded
    windows), so each window is padded with PAD_KERNELS filler kernels
    before and after fn's calls, which the result leaves out. A window in which some kernel did not run a multiple
    of `calls` times is taken again, `tries` times at most; with
    whole=False the first window with records is taken as it is (launch
    counts per call may then be fractions)."""
    fill, skip = _padding(torch)
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity.CUDA
    for _ in range(tries):
        with torch.profiler.profile(activities=[act]) as prof:
            for _ in range(PAD_KERNELS):
                fill()
            for _ in range(calls):
                fn()
            for _ in range(PAD_KERNELS):
                fill()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.key not in skip]
        if rows and (not whole or all(e.count % calls == 0 for e in rows)):
            per, counts = {}, {}
            for e in rows:
                k = e.key[:60]
                per[k] = per.get(k, 0.0) + e.self_device_time_total / calls
                counts[k] = counts.get(k, 0) + e.count / calls
            return per, counts
    raise RuntimeError(f"the profiler saw no whole window in {tries} tries")


def _device_us(torch, fn, calls=DEVICE_CALLS, tries=3):
    """Device time per call, µs, summed over the kernels fn launches; and
    the same per kernel name (see _profile)."""
    per, _ = _profile(torch, fn, calls, tries)
    return sum(per.values()), per


# CUgraphNodeType values (cuda.h) of the nodes _graph_record counts
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def _graph_record(torch, fn):
    """fn's device work with no host in the way, without the profiler: fn
    captured once into a CUDA graph, the graph's nodes counted by type
    through libcuda's cuGraphGetNodes (every launch and copy of one call),
    and the graph replayed DEVICE_CALLS times back to back between two
    CUDA events. Returns (device µs per call: its kernels and the gaps
    between them, {node type: count})."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw, n = g.raw_cuda_graph(), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    counts = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(t.value, f"type{t.value}")
        counts[name] = counts.get(name, 0) + 1
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(DEVICE_CALLS):
        g.replay()
    b.record()
    b.synchronize()
    us = a.elapsed_time(b) * 1e3 / DEVICE_CALLS
    g.reset()
    return us, counts


def _timed_pair(torch, kernel, plain):
    """Kernel and plain-version times: CUDA-event medians around single
    calls (host enqueue included), interleaved plain, kernel, kernel, plain,
    the min of each pair of runs; and device time per call from the
    profiler, which ranks the two."""
    p1 = _median_ms(torch, plain)
    k1 = _median_ms(torch, kernel)
    k2 = _median_ms(torch, kernel)
    p2 = _median_ms(torch, plain)
    dev_us, dev_per = _device_us(torch, kernel)
    plain_us, plain_per = _device_us(torch, plain)
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), ms_runs=[k1, k2],
                plain_ms_runs=[p1, p2], device_us=dev_us,
                plain_device_us=plain_us, device_kernels=dev_per,
                plain_device_kernels=plain_per)


def phase_kernels(torch, dev):
    from pynama_tpu_torch.mesh import BoxMesh
    from pynama_tpu_torch.ops.fused import (dss_library_plan, dss_pass,
                                            dss_ref, dss_tile_plan,
                                            fused_apply, fused_apply_ref)

    record = None
    seed = 0
    for label, nelem, ngl, pairs in SHAPES:
        dim = len(nelem)
        nn = ngl ** dim
        E = int(np.prod(nelem))
        mesh = BoxMesh.create(ngl, nelem, [0] * dim, [1] * dim)
        for dtype, limit in ((torch.float32, F32_LIMIT),
                             (torch.float64, F64_LIMIT)):
            for cin, cout in pairs:
                seed += 1
                rng = np.random.default_rng(seed)
                t = torch.as_tensor(rng.standard_normal((E, nn * cin)),
                                    dtype=dtype, device=dev)
                m = torch.as_tensor(
                    rng.standard_normal((nn * cin, nn * cout)),
                    dtype=dtype, device=dev)
                y, bnd = fused_apply(t, m, nelem, ngl, cout)
                yr, br = fused_apply_ref(t, m, nelem, ngl, cout)
                torch.cuda.synchronize()
                scale = float(yr.abs().max())
                err_y = float((y - yr).abs().max())
                err_b = float((bnd - br).abs().max())
                spread = _dup_spread(torch, y, mesh.cell_nodes, cout)
                # the DSS pass alone: bitwise the plain DSS of the same u
                u = torch.as_tensor(rng.standard_normal((E, nn * cout)),
                                    dtype=dtype, device=dev)
                yd, bd = dss_pass(u, nelem, ngl, cout)
                ydr, bdr = dss_ref(u, nelem, ngl, cout)
                bitwise = torch.equal(yd, ydr) and torch.equal(bd, bdr)
                eb = t.element_size()
                plan = dss_library_plan(nelem, ngl, cout, eb)
                want = dss_tile_plan(nelem, ngl, cout, eb)
                dname = str(dtype).split(".")[-1]
                row = dict(shape=label, dtype=dname,
                           nnc_in=nn * cin, nnc_out=nn * cout,
                           max_abs_err=err_y, bnd_abs_err=err_b,
                           rel_err=err_y / scale, bnd_rel_err=err_b / scale,
                           limit=limit, dup_spread=spread,
                           dss_bitwise=bitwise,
                           dss_plan=[plan[k] for k in ("C", "nch", "threads",
                                                       "tile_bytes",
                                                       "copy_bytes")])
                if label in TIMED:
                    row.update(_timed_pair(
                        torch, lambda: fused_apply(t, m, nelem, ngl, cout),
                        lambda: fused_apply_ref(t, m, nelem, ngl, cout)))
                    row["dss_device_us"] = sum(
                        v for k, v in row["device_kernels"].items()
                        if "dss" in k)
                    R, plane = E // nelem[0], nn * cout // ngl
                    row["bound_ms"], row["bound_by"] = _gemm_bound(
                        E, nn * cin, nn * cout, dname, 2 * R * plane * eb)
                    row["dss_bound_us"] = 1e6 * (
                        2 * E * nn * cout + 2 * R * plane) * eb / HBM_BPS
                    row["library_ms"] = None
                    if label == TIMED[0] and dtype == torch.float32 \
                            and (cin, cout) == (3, 3):
                        record = row
                emit("kernels", **row)
                what = f"fused_apply {label} {dname} {nn * cin}->{nn * cout}"
                check(err_y / scale <= limit, f"{what}: rel err "
                      f"{err_y / scale:.3e} > {limit}")
                check(err_b / scale <= limit, f"{what}: bnd rel err "
                      f"{err_b / scale:.3e} > {limit}")
                check(spread == 0.0, f"{what}: duplicate slots differ by "
                      f"{spread:.3e}")
                check(bitwise, f"{what}: the DSS pass is not bitwise the "
                      "plain DSS")
                check(all(plan[k] == want[k] for k in plan),
                      f"{what}: DSS plan {plan} != dss_tile_plan's")
    _dss_sweep(torch, dev)
    return record


def _dss_sweep(torch, dev):
    """The DSS pass alone at 24^3 ngl=4 (192 and 384 columns, f32 and
    f64) over the chunk lengths DSS_CHUNKS: device time per call, each
    checked bitwise against the plain DSS."""
    from pynama_tpu_torch.ops.fused import (dss_library_plan, dss_pass,
                                            dss_ref)
    nelem, ngl = (24, 24, 24), 4
    E = int(np.prod(nelem))
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for ncomp in (3, 6):
            nnc = ngl ** 3 * ncomp
            rng = np.random.default_rng(700 + ncomp)
            u = torch.as_tensor(rng.standard_normal((E, nnc)), dtype=dtype,
                                device=dev)
            yr, br = dss_ref(u, nelem, ngl, ncomp)
            rows = []
            for chunk in DSS_CHUNKS:
                y, b = dss_pass(u, nelem, ngl, ncomp, chunk)
                check(torch.equal(y, yr) and torch.equal(b, br),
                      f"DSS pass {dname} {nnc} chunk {chunk}: not bitwise "
                      "the plain DSS")
                plan = dss_library_plan(nelem, ngl, ncomp,
                                        u.element_size(), chunk)
                us, _ = _device_us(
                    torch, lambda: dss_pass(u, nelem, ngl, ncomp, chunk))
                rows.append([chunk, plan["C"], plan["threads"],
                             plan["tile_bytes"], us])
            emit("dss_sweep", dtype=dname, nnc=nnc,
                 cases="[chunk, C, threads, tile_bytes, device_us]",
                 rows=rows)


def _seam_pairs_equal(torch, y, nelem, ngl, blk):
    """Both slots of every interior block-seam pair hold the same bits."""
    ne0 = nelem[0]
    nnc = y.shape[1]
    plane = nnc // ngl
    y3 = y.view(ne0, y.shape[0] // ne0, nnc)
    return torch.equal(y3[blk - 1:ne0 - 1:blk, :, nnc - plane:],
                       y3[blk::blk, :, :plane])


def _decomp_checks(torch, dev):
    """K2-K4 against their plain versions at every engine shape; returns
    the 24^3 ngl=4 f32 192->192 row of each kernel (with its times)."""
    from pynama_tpu_torch.exp import fused_decomp as D
    from pynama_tpu_torch.exp import mm3x as M3
    from pynama_tpu_torch.mesh import BoxMesh
    from pynama_tpu_torch.ops.fused import fused_apply

    record = {}
    seed = 100
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, nelem, ngl, pairs in SHAPES:
        dim = len(nelem)
        nn = ngl ** dim
        E = int(np.prod(nelem))
        R = E // nelem[0]
        blocks = sorted({b for b in (1, 2, nelem[0]) if nelem[0] % b == 0})
        mesh = BoxMesh.create(ngl, nelem, [0] * dim, [1] * dim)
        flagship = label == "3d-ngl4-24^3"
        for dtype, limit in ((torch.float32, F32_LIMIT),
                             (torch.float64, F64_LIMIT)):
            dname = str(dtype).split(".")[-1]
            rows = {"plainmm": [], "variant": [], "fused3x": []}
            for cin, cout in pairs:
                seed += 1
                rng = np.random.default_rng(seed)
                t = torch.as_tensor(rng.standard_normal((E, nn * cin)),
                                    dtype=dtype, device=dev)
                m = torch.as_tensor(
                    rng.standard_normal((nn * cin, nn * cout)),
                    dtype=dtype, device=dev)
                what = f"{label} {dname} {nn * cin}->{nn * cout}"

                def compare(name, y, yr, **extra):
                    scale = float(yr.abs().max())
                    err = float((y - yr).abs().max())
                    row = dict(pair=[nn * cin, nn * cout], max_abs_err=err,
                               rel_err=err / scale, **extra)
                    rows[name].append(row)
                    check(err / scale <= limit, f"{name} {what} "
                          f"{extra}: rel err {err / scale:.3e} > {limit}")
                    return row

                # K4: the GEMM alone, one axis-0 slice per TPU block
                row = compare("plainmm", D.plainmm_apply(t, m, R),
                              D.plainmm_apply_ref(t, m, R))
                if flagship:
                    row.update(_timed_pair(
                        torch, lambda: D.plainmm_apply(t, m, R),
                        lambda: D.plainmm_apply_ref(t, m, R)))
                    row["bound_ms"], row["bound_by"] = _gemm_bound(
                        E, nn * cin, nn * cout, dname)
                    # one PyTorch call of the same function: cuBLAS
                    row["library_ms"] = _median_ms(torch, lambda: t @ m)
                    row["library_device_us"] = _device_us(
                        torch, lambda: t @ m)[0]
                    if dtype == torch.float32 and (cin, cout) == (3, 3):
                        record["plainmm"] = row
                # K3: both do_rolls, every block
                for blk in blocks:
                    for rolls in (True, False):
                        args = (t, m, nelem, ngl, cout, blk, rolls)
                        y = D.variant_apply(*args)
                        torch.cuda.synchronize()
                        if rolls:
                            spread = _dup_spread(torch, y, mesh.cell_nodes,
                                                 cout)
                            check(spread == 0.0, f"variant {what} block "
                                  f"{blk}: duplicate slots differ by "
                                  f"{spread:.3e}")
                        else:
                            check(_seam_pairs_equal(torch, y, nelem, ngl,
                                                    blk),
                                  f"variant {what} block {blk}: seam "
                                  "pair slots differ")
                        row = compare("variant", y,
                                      D.variant_apply_ref(*args),
                                      block=blk, do_rolls=rolls)
                        if flagship and blk == 1 and not rolls:
                            row.update(_timed_pair(
                                torch, lambda: D.variant_apply(*args),
                                lambda: D.variant_apply_ref(*args)))
                            row["bound_ms"], row["bound_by"] = _gemm_bound(
                                E, nn * cin, nn * cout, dname)
                            row["library_ms"] = None
                            if dtype == torch.float32 and (cin, cout) \
                                    == (3, 3):
                                record["variant"] = row
                if dtype != torch.float32:
                    continue
                # K2: f32 only; against its plain version and against K1
                y = M3.fused3x_apply(t, m, nelem, ngl, cout, 1)
                spread = _dup_spread(torch, y, mesh.cell_nodes, cout)
                y1 = fused_apply(t, m, nelem, ngl, cout)[0]
                split = float((y - y1).abs().max() / y1.abs().max())
                row = compare("fused3x", y, M3.fused3x_apply_ref(
                    t, m, nelem, ngl, cout, 1), dup_spread=spread,
                    rel_vs_fused_apply=split)
                check(spread == 0.0, f"fused3x {what}: duplicate slots "
                      f"differ by {spread:.3e}")
                check(split <= SPLIT_LIMIT, f"fused3x {what}: {split:.3e} "
                      f"from fused_apply > {SPLIT_LIMIT}")
                plan = M3.gemm3x_library_plan(t, nn * cout)
                want = M3.gemm3x_plan(E, nn * cin, nn * cout,
                                      t.data_ptr() % 16 == 0, sms)
                check(plan == want, f"fused3x {what}: GEMM plan {plan} != "
                      f"gemm3x_plan's {want}")
                row["gemm_plan"] = [plan[k] for k in M3.PLAN_KEYS]
                if flagship:
                    row.update(_timed_pair(
                        torch, lambda: M3.fused3x_apply(t, m, nelem, ngl,
                                                        cout, 1),
                        lambda: M3.fused3x_apply_ref(t, m, nelem, ngl,
                                                     cout, 1)))
                    # three bf16 products on the tensor cores
                    row["bound_ms"], row["bound_by"] = _gemm_bound(
                        E, nn * cin, nn * cout, dname, products=3,
                        peak=PEAK_FLOPS["bfloat16"])
                    row["library_ms"] = None
                    # its GEMM alone (the split of matT and the wgmma
                    # kernel); same bytes, same bound
                    row["gemm3x_device_us"], row["gemm3x_kernels"] = \
                        _device_us(torch, lambda: M3.gemm3x(t, m))
                    row["gemm3x_bound_us"] = row["bound_ms"] * 1e3
                    if (cin, cout) == (3, 3):
                        record["fused3x"] = row
            for name, kr in rows.items():
                if kr:
                    emit("decomp", kernel=name, shape=label, dtype=dname,
                         limit=limit,
                         worst_rel_err=max(r["rel_err"] for r in kr),
                         **({"rows": kr} if flagship else {}))
    return record


def _gemm_sweep(torch, dev):
    """K4 plainmm_apply (the GEMM of K1, K3 and K4) against its plain
    version at every GEMM_M x GEMM_KN, plus two misaligned contiguous views
    (`big[1:]` of an (M+1, 9) buffer; a (M, 192) view one element into a
    flat buffer), f32 and f64; prints the loader and tile of each case."""
    from pynama_tpu_torch.exp import fused_decomp as D

    seed = 500
    loaders = set()
    for dtype, limit in ((torch.float32, F32_LIMIT),
                         (torch.float64, F64_LIMIT)):
        dname = str(dtype).split(".")[-1]
        cases = [(M, K, N, "") for M in GEMM_M for K, N in GEMM_KN]
        cases += [(13824, 9, 18, "rows+1"), (13824, 192, 192, "offset+1")]
        rows = []
        for M, K, N, view in cases:
            seed += 1
            rng = np.random.default_rng(seed)
            t = _sweep_input(torch, dev, rng, M, K, view, dtype)
            m = torch.as_tensor(rng.standard_normal((K, N)), dtype=dtype,
                                device=dev)
            y = D.plainmm_apply(t, m, M)
            yr = D.plainmm_apply_ref(t, m, M)
            torch.cuda.synchronize()
            plan = D.gemm_plan(t, m, y)
            rel = float((y - yr).abs().max() / yr.abs().max())
            loaders.add((dname, plan["loader_bytes"]))
            rows.append([M, K, N, view, plan["loader_bytes"], plan["tile"],
                         rel])
            check(rel <= limit, f"plainmm {dname} M={M} K={K} N={N} {view}:"
                  f" rel err {rel:.3e} > {limit}")
        emit("gemm_sweep", dtype=dname, limit=limit,
             worst_rel_err=max(r[-1] for r in rows),
             cases="[M, K, N, view, loader_bytes, tile, rel_err]", rows=rows)
    want = {("float32", 16), ("float32", 4), ("float64", 16), ("float64", 8)}
    check(loaders == want, f"GEMM loaders exercised {sorted(loaders)}, want "
          f"{sorted(want)}")


def _sweep_input(torch, dev, rng, M, K, view, dtype):
    """t (M, K) for a sweep case: contiguous, or one of the two misaligned
    views."""
    if view == "rows+1":
        return torch.as_tensor(rng.standard_normal((M + 1, K)), dtype=dtype,
                               device=dev)[1:]
    if view == "offset+1":
        return torch.as_tensor(rng.standard_normal(M * K + 1), dtype=dtype,
                               device=dev)[1:].view(M, K)
    return torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype,
                           device=dev)


def _gemm3x_sweep(torch, dev):
    """K2's GEMM alone (exp.mm3x.gemm3x) against mm3x_ref over the GEMM
    sweep's cases and GEMM3X_M x GEMM3X_KN; prints each case's plan and
    fails unless every path of GEMM3X_PATHS ran."""
    from pynama_tpu_torch.exp import mm3x as M3

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(M, K, N, "") for M in GEMM_M for K, N in GEMM_KN]
    cases += [(13824, 9, 18, "rows+1"), (13824, 192, 192, "offset+1")]
    cases += [(M, K, N, "") for M in GEMM3X_M for K, N in GEMM3X_KN]
    seed = 900
    rows, paths = [], set()
    for M, K, N, view in cases:
        seed += 1
        rng = np.random.default_rng(seed)
        t = _sweep_input(torch, dev, rng, M, K, view, torch.float32)
        m = torch.as_tensor(rng.standard_normal((K, N)), dtype=torch.float32,
                            device=dev)
        u = M3.gemm3x(t, m)
        ur = M3.mm3x_ref(t, m)
        torch.cuda.synchronize()
        rel = float((u - ur).abs().max() / ur.abs().max())
        plan = M3.gemm3x_library_plan(t, N)
        want = M3.gemm3x_plan(M, K, N, t.data_ptr() % 16 == 0, sms)
        what = f"gemm3x M={M} K={K} N={N} {view}"
        check(plan == want, f"{what}: plan {plan} != gemm3x_plan's {want}")
        check(rel <= F32_LIMIT, f"{what}: rel err {rel:.3e} > {F32_LIMIT}")
        paths.add((plan["tile_n"], plan["resident"], plan["loader_bytes"]))
        rows.append([M, K, N, view, plan["tile_n"], plan["resident"],
                     plan["loader_bytes"], plan["grid_x"], plan["ncol"],
                     rel])
    emit("gemm3x_sweep", limit=F32_LIMIT,
         worst_rel_err=max(r[-1] for r in rows),
         cases="[M, K, N, view, tile_n, resident, loader_bytes, grid_x, "
         "ncol, rel_err]", rows=rows)
    check(paths >= GEMM3X_PATHS, f"gemm3x paths exercised {sorted(paths)}, "
          f"want {sorted(GEMM3X_PATHS)}")


def phase_decomp(torch, dev):
    """3b: K2-K4 checked, the GEMM sweep, then both decomposition drivers
    at 24^3 ngl=4 with the launch counts read around them."""
    from pynama_tpu_torch.exp import fused_decomp as D
    from pynama_tpu_torch.exp import mm3x as M3

    record = _decomp_checks(torch, dev)
    _gemm_sweep(torch, dev)
    _gemm3x_sweep(torch, dev)
    wrappers = {"plainmm": D.plainmm_apply, "variant": D.variant_apply,
                "fused3x": M3.fused3x_apply}
    for fn in wrappers.values():
        fn.launches = 0
    best = D.main(DRIVER_ARGS)
    m3 = M3.main(DRIVER_ARGS)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    us = {k: v * 1e6 for k, v in best.items()}
    emit("decomp_drivers", config="24^3 ngl=4 f32 192->192 block 1, "
         "nit 200, 3 rounds", fused_decomp_us=us,
         dss_pass_us=us["fused"] - us["nodss"],
         seam_adds_us=us["nodss"] - us["plainmm"],
         hand_vs_cublas_mm_us=us["plainmm"] - us["torch_mm"],
         mm3x_us={k: v * 1e6 for k, v in m3["times"].items()},
         mm3x_max_abs_diff=m3["max_abs_diff"], mm3x_scale=m3["scale"],
         launches=launches)
    check(m3["max_abs_diff"] <= SPLIT_LIMIT * m3["scale"],
          f"mm3x driver: 3x vs fused_apply {m3['max_abs_diff']:.3e} > "
          f"{SPLIT_LIMIT} x {m3['scale']:.3e}")
    check(all(np.isfinite(v) and v > 0 for v in us.values()),
          f"decomposition times {us}")
    check(all(n > 0 for n in launches.values()),
          f"a decomposition kernel was not launched by the drivers: "
          f"{launches}")
    for k, n in launches.items():
        record[k]["launches"] = n
    return record


def parity_cases():
    """(label, config, Problem options, stepper tolerance) of the GPU-vs-CPU
    parity cases. The stepper's tolerance is one at which every accepted
    step's size factor is clipped at 10 (dt 1e-3, 1e-2, 1e-1): a factor the
    error norm sets moves with the CG solves' last bits (at 1e-8 the 3D
    Taylor-Green case's third dt differs by ~1e-5 between the kernel and
    the plain version), and so would the end time."""
    opts = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
    cavity = cavity_config((3, 3, 3), 3, 1.0, 0.02, [1.0, 0, 0], 3, 1.0)
    return [
        ("cavity3d 3^3 ngl=3", cavity, opts, 1e-8),
        ("taylor-green3d 3^3 ngl=3", tg3d_config((3, 3, 3), 3, 3), opts,
         1e-4),
        # from t = 0.1: the flat plate's tau is 0 at t = 0
        ("flat-plate-FSNS 4^2 ngl=3 t0=0.1",
         fsns_config((4, 4), 3, 0.1, 3), opts, 1e-4),
        ("cavity3d 3^3 ngl=3 pc=fdm", cavity, dict(opts, pc="fdm"), 1e-8),
    ]


def phase_parity(torch, dev):
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.engine.local_engine import rhs_local

    for label, cfg, opts, tol in parity_cases():
        out = {}
        for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
            p = Problem(cfg, device=device, dtype=torch.float64, **opts)
            p.setUp()
            rng = np.random.default_rng(0)
            vort = p.to_local(rng.standard_normal((p.mesh.n_nodes,
                                                   p.dim_w)))
            vel = torch.zeros((p.mesh.n_cells, p.mesh.nnode_el * p.dim),
                              dtype=torch.float64, device=device)
            f, _ = rhs_local(p.engine_ops, p.start_time, vort, vel)
            t_end, steps = p.start_solver(atol=tol, rtol=tol, dt0=1e-3)
            out[name] = dict(f=f.cpu().numpy(), vort=p.vort.cpu().numpy(),
                             vel=p.vel.cpu().numpy(), t=t_end, steps=steps,
                             pc=p.engine_ops.pc)
        rel = {k: float(np.abs(out["gpu"][k] - out["cpu"][k]).max()
                        / np.abs(out["cpu"][k]).max())
               for k in ("f", "vort", "vel")}
        emit("parity", case=label, rel_err=rel, limit=PARITY_LIMIT,
             stepper_tol=tol,
             pc=out["gpu"]["pc"], steps_gpu=out["gpu"]["steps"],
             steps_cpu=out["cpu"]["steps"], t_gpu=out["gpu"]["t"],
             t_cpu=out["cpu"]["t"])
        check(out["gpu"]["pc"] == out["cpu"]["pc"] == opts.get("pc",
                                                               "jacobi"),
              f"parity {label}: preconditioner {out['gpu']['pc']}")
        check(out["gpu"]["steps"] == out["cpu"]["steps"] == 3,
              f"parity {label}: accepted steps gpu {out['gpu']['steps']} "
              f"cpu {out['cpu']['steps']} (want 3)")
        check(all(v <= PARITY_LIMIT for v in rel.values()),
              f"parity {label}: GPU vs CPU relative error {rel} > "
              f"{PARITY_LIMIT}")


def phase_main(torch, dev):
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops.fused import fused_apply

    # bench.py's flagship: 3D no-slip lid-driven cavity, 24^3 ngl=4, f32
    cfg = cavity_config((24, 24, 24), 4, 0.5, 0.01, [2, 0, 0], 2, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = 0
    p = Problem(cfg, device=dev, dtype=torch.float32, solver="cg",
                cg_rtol=1e-6, cg_maxiter=1000)
    t0 = time.perf_counter()
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p.cg_log = []
    t0 = time.perf_counter()
    t_end, steps = p.start_solver(dt0=1e-3)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)

    iters = [int(it) for it, _ in p.cg_log]
    applies = [n for _, n in p.cg_log]
    n_rhs = len(p.cg_log) // 2
    # per rhs_local: Rw, apply_K(vc), A0 residual per stage (2 stages),
    # curl between the stages, then srt, div_srt, curl -> 10; plus every
    # operator application of the CG loops
    expected = 10 * n_rhs + sum(applies)
    ops = p.engine_ops
    vel_l = p.to_local(p.vel)
    ke = 0.5 * p.rho * float((vel_l * vel_l * ops.lay_v.inv_mult
                              / ops.winv_v).sum())
    vort, vel = p.vort, p.vel
    finite = bool(torch.isfinite(vort).all()) and bool(
        torch.isfinite(vel).all())
    emit("main", config="cavity3d 24^3 ngl=4 f32 cg_rtol=1e-6",
         n_nodes=p.mesh.n_nodes, velocity_dofs=p.mesh.n_nodes * 3,
         setup_s=setup_s, setup_phases_s=p.setup_phases,
         accepted_steps=steps, attempts=n_rhs // 8, t_end=t_end,
         run_s=run_s, s_per_step=run_s / max(steps, 1), rhs_evals=n_rhs,
         cg_iters_fs_main=[iters[i:i + 2] for i in range(0, len(iters), 2)],
         cg_loop_applies=sum(applies), fused_apply_launches=launches,
         expected_launches=expected, peak_mem_bytes=peak,
         kinetic_energy=ke, finite=finite)
    check(steps == 2, f"accepted {steps} steps, want 2")
    check(finite, "non-finite vort/vel")
    check(ke > 0.0, f"kinetic energy {ke} <= 0")
    check(len(p.cg_log) == 2 * n_rhs and n_rhs >= 16,
          f"{len(p.cg_log)} CG solves for {n_rhs} right-hand sides")
    check(launches > 0 and launches == expected,
          f"fused_apply launched {launches} times, the path made "
          f"{expected} operator applications")
    check(all(n >= it for it, n in zip(iters, applies)),
          "CG made fewer operator applications than iterations")
    return launches, p, t_end


def phase_rhs_trace(torch, p, t):
    """One warm rhs_local of the flagship at its state after the steps:
    the median wall time of 3 untraced calls, then one call traced with
    torch.profiler; the device-busy share of the untraced wall and the
    shares of K1's kernels (the ones one fused_apply call launches) and of
    every other kernel (CG vectors, BC writes, vtensv)."""
    from pynama_tpu_torch.engine.local_engine import rhs_local
    from pynama_tpu_torch.ops.fused import fused_apply

    ops = p.engine_ops
    vort, vel = p.to_local(p.vort), p.to_local(p.vel)
    k1_names = set(_profile(torch, lambda: fused_apply(
        vel, ops.KT, ops.nelem, ops.ngl, ops.dim))[0])
    stats = []

    def rhs():
        stats.clear()
        rhs_local(ops, t, vort, vel, stats)
        torch.cuda.synchronize()

    rhs()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rhs()
        walls.append(time.perf_counter() - t0)
    wall_us = float(np.median(walls)) * 1e6
    # a window that lost records shows as K1 launches short of 2 per
    # operator application (10 fixed ones per rhs, plus the CG loops'):
    # such a window is taken again, 3 times at most
    for tries in range(1, 4):
        per, counts = _profile(torch, rhs, calls=1, whole=False)
        applies = sum(n for _, n in stats)
        k1_launches = sum(counts.get(k, 0) for k in k1_names)
        k1_expected = 2 * (applies + 10)
        if k1_launches == k1_expected:
            break
    total = sum(per.values())
    k1 = sum(v for k, v in per.items() if k in k1_names)
    iters = [int(it) for it, _ in stats]
    emit("rhs_trace", config="cavity3d 24^3 ngl=4 f32, one warm rhs_local",
         wall_us_untraced=wall_us, wall_us_runs=[w * 1e6 for w in walls],
         device_us=total, k1_device_us=k1, vector_device_us=total - k1,
         device_busy_share=total / wall_us, k1_share=k1 / wall_us,
         vector_share=(total - k1) / wall_us,
         idle_share=1.0 - total / wall_us, cg_iters_fs_main=iters,
         cg_loop_applies=applies, k1_kernels=sorted(k1_names),
         kernel_launches=sum(counts.values()), k1_launches=k1_launches,
         k1_launches_expected=k1_expected, trace_tries=tries,
         wall_us_per_loop_apply=wall_us / max(applies, 1),
         top_kernels=sorted(per.items(), key=lambda kv: -kv[1])[:8])
    check(k1_launches == k1_expected,
          f"rhs_trace: the trace saw {k1_launches} K1 launches, the rhs "
          f"made {k1_expected}, in {tries} tries")


def phase_taylor_green3d(torch, dev):
    """The 3D Taylor-Green case file at full width, depth cut to 3 steps."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops.fused import fused_apply

    cfg = tg3d_config((25, 25, 25), 3, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = 0
    p = Problem(cfg, device=dev, dtype=torch.float32, solver="cg",
                cg_rtol=1e-6, cg_maxiter=1000)
    t0 = time.perf_counter()
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p.cg_log = []
    t0 = time.perf_counter()
    t_end, steps = p.start_solver(dt0=1e-3, atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)

    iters = [int(it) for it, _ in p.cg_log]
    applies = [n for _, n in p.cg_log]
    n_rhs = len(p.cg_log)            # free-slip sides only: one solve each
    # per rhs_local: Rw, apply_K(vc), the A0 residual, then srt, div_srt,
    # curl -> 6; plus every operator application of the CG loops
    expected = 6 * n_rhs + sum(applies)
    w_exact = p.exact_fields(t_end)[1].double()
    vort = p.vort.double()
    err = float((vort - w_exact).abs().max() / w_exact.abs().max())
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all())
    emit("taylor_green3d", config="taylor-green3d 25^3 ngl=3 f32 cg_rtol=1e-6",
         n_nodes=p.mesh.n_nodes, bc_type=p.bc.bc_type,
         func_sides=len(p.engine_ops.func_sides), setup_s=setup_s,
         setup_phases_s=p.setup_phases, accepted_steps=steps, t_end=t_end,
         run_s=run_s, s_per_step=run_s / max(steps, 1), rhs_evals=n_rhs,
         cg_iters=iters, cg_loop_applies=sum(applies),
         fused_apply_launches=launches, expected_launches=expected,
         peak_mem_bytes=peak, vort_rel_max_err=err,
         err_limit=TG3D_ERR_LIMIT, jax_ref_err=TG3D_REF_ERR,
         jax_ref_t_end=TG3D_REF_T, finite=finite)
    check(steps == 3, f"taylor_green3d: accepted {steps} steps, want 3")
    check(finite, "taylor_green3d: non-finite vort/vel")
    check(p.bc.bc_type == "FS" and not p.engine_ops.is_ns,
          f"taylor_green3d: bc type {p.bc.bc_type}")
    check(launches > 0 and launches == expected,
          f"taylor_green3d: fused_apply launched {launches} times, the "
          f"path made {expected} operator applications")
    check(err <= TG3D_ERR_LIMIT, f"taylor_green3d: vorticity error "
          f"{err:.3e} > {TG3D_ERR_LIMIT:.3e}")


def phase_fdm(torch, dev):
    """Cold two-stage solves of the flagship's system under pc="jacobi" and
    pc="fdm" (the JAX bench's cold solve: solve_kle_local from zero
    velocity, vorticity = curl of a numpy-seeded random velocity)."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.engine.local_engine import curl, solve_kle_local
    from pynama_tpu_torch.ops.fused import fused_apply
    from pynama_tpu_torch.solver.fdm import fdm_apply

    cfg = cavity_config((24, 24, 24), 4, 0.5, 0.01, [2, 0, 0], 2, 1.0)
    out = {}
    for dtype, rtol, maxiter in ((torch.float64, 1e-10, 4000),
                                 (torch.float32, 1e-6, 1000)):
        dname = str(dtype).split(".")[-1]
        for pc in ("jacobi", "fdm"):
            t0 = time.perf_counter()
            p = Problem(cfg, device=dev, dtype=dtype, solver="cg",
                        cg_rtol=rtol, cg_maxiter=maxiter, pc=pc)
            p.setUp()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            ops = p.engine_ops
            check(ops.pc == pc, f"fdm: built pc={ops.pc}, asked {pc}")
            rng = np.random.default_rng(0)
            v = p.to_local(rng.standard_normal((p.mesh.n_nodes, p.dim)))
            vort = curl(ops, v)
            vel0 = torch.zeros_like(v)
            stats = []
            solve = lambda: solve_kle_local(ops, vort, vel0, 0.0, stats)[1]
            fused_apply.launches = 0
            vel = solve()
            launches = fused_apply.launches
            # per stage: Rw, apply_K(vc) and the A0 residual; the curl
            # between the stages; plus every CG-loop application
            expected = 4 * len(stats) - 1 + sum(n for _, n in stats)
            row = dict(setup_s=setup_s, setup_phases_s=p.setup_phases,
                       iters_fs_main=[int(it) for it, _ in stats],
                       loop_applies=[n for _, n in stats],
                       fused_apply_launches=launches,
                       expected_launches=expected)
            check(len(stats) == 2 and launches == expected,
                  f"fdm {dname} {pc}: fused_apply launched {launches} "
                  f"times, the solve made {expected} operator applications "
                  f"in {len(stats)} stages")
            if dtype == torch.float32:
                row["solve_ms"] = _median_ms(torch, solve, reps=3,
                                             warmup=0)
                r = ops.free_fs * v
                k1 = lambda: fused_apply(r, ops.KT, ops.nelem, ops.ngl,
                                         ops.dim)
                row["k1_ms"] = _median_ms(torch, k1)
                row["k1_graph_us"], row["k1_nodes"] = _graph_record(torch,
                                                                    k1)
                check(row["k1_nodes"] == {"kernel": 2},
                      f"fdm: one K1 call captured as {row['k1_nodes']}, "
                      f"want 2 kernels")
                if pc == "fdm":
                    f = ops.fdm_fs
                    fa = lambda: fdm_apply(f, r, nelem=ops.nelem,
                                           ngl=ops.ngl)
                    row["fdm_apply_ms"] = _median_ms(torch, fa)
                    (row["fdm_apply_graph_us"],
                     row["fdm_apply_nodes"]) = _graph_record(torch, fa)
                    # the per-mode block step alone, as fdm_apply does it
                    # and as the reference's einsum
                    z = torch.as_tensor(rng.standard_normal(
                        (f.ncomp,) + f.npts), dtype=dtype, device=dev)
                    row["binv_step_graph_us"] = {
                        "broadcast": _graph_record(torch, lambda: (
                            f.binv * z.unsqueeze(0)).sum(dim=1))[0],
                        "einsum": _graph_record(torch, lambda: torch.einsum(
                            "ab...,b...->a...", f.binv, z))[0]}
            row["finite"] = bool(torch.isfinite(vel).all())
            out[(dname, pc)] = (row, vel)
            check(row["finite"], f"fdm {dname} {pc}: non-finite velocity")
            del p, ops
        rj, vj = out[(dname, "jacobi")]
        rf, vf = out[(dname, "fdm")]
        rel = float((vf - vj).abs().max() / vj.abs().max())
        engine_s = {pc: out[(dname, pc)][0]["setup_phases_s"]["engine"]
                    for pc in ("jacobi", "fdm")}
        emit("fdm", config=f"cavity3d 24^3 ngl=4 {dname} cold two-stage "
             f"solve, cg_rtol={rtol}", jacobi=rj, fdm=rf,
             fdm_setup_s=engine_s["fdm"] - engine_s["jacobi"],
             vel_rel_diff=rel, limit=FDM_AGREE_LIMIT
             if dtype == torch.float64 else None)
        if dtype == torch.float64:
            check(rel <= FDM_AGREE_LIMIT, f"fdm f64: jacobi and fdm "
                  f"velocities differ by {rel:.3e} > {FDM_AGREE_LIMIT}")
            check(all(f < j for f, j in zip(rf["iters_fs_main"],
                                            rj["iters_fs_main"])),
                  f"fdm f64: iterations fdm {rf['iters_fs_main']} not fewer "
                  f"than jacobi {rj['iters_fs_main']} on both stages")
        for key in [k for k in out if k[0] == dname]:
            out[key] = (out[key][0], None)
        torch.cuda.empty_cache()


def phase_cg_split(torch, p):
    """The free-slip-stage system of the flagship at its state after
    phase_main's steps, built as engine.local_engine._masked_solve builds
    it, solved by pcg once with apply_K through K1 (full f32) and once
    through K2 (split bf16), same b and x0. A record: nothing is gated."""
    from pynama_tpu_torch.engine import local_engine as LE
    from pynama_tpu_torch.exp.mm3x import fused3x_apply
    from pynama_tpu_torch.ops.fused import fused_apply
    from pynama_tpu_torch.solver.cg import pcg

    ops = p.engine_ops
    shape = (ops.nelem, ops.ngl, ops.lay_v.ncomp)
    vort = LE.apply_vorticity_bc(ops, p.to_local(p.vort), 0.0)
    vel = LE.apply_velocity_bc(ops, p.to_local(p.vel), 0.0)
    free = ops.free_fs
    con = 1.0 - free
    vc = con * vel
    dot = LE._dot_v(ops)

    def K1(v):
        return fused_apply(v, ops.KT, *shape)[0]

    def K2(v):
        return fused3x_apply(v, ops.KT, *shape, 1)

    b = free * (fused_apply(vort, ops.RwT, *shape)[0] - K1(vc)) + vc
    x0 = free * vel + vc
    dmask = free * ops.diag + con
    # the true residual, with the operator in float64
    KT64, free64, b64 = ops.KT.double(), free.double(), b.double()
    inv64 = ops.lay_v.inv_mult.double()

    def true_residual(x):
        x64 = x.double()
        r = b64 - (free64 * fused_apply(free64 * x64, KT64, *shape)[0]
                   + (1.0 - free64) * x64)
        return float(torch.sqrt((r * r * inv64).sum()
                                / (b64 * b64 * inv64).sum()))

    out = {"rtol": 1e-6, "x0_true_residual": true_residual(x0)}
    xs = {}
    for name, K in (("K1", K1), ("K2", K2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pcg(lambda v: free * K(v), b, x0, M_inv=lambda r: r / dmask,
                  rtol=1e-6, atol=ops.cg_atol, maxiter=ops.cg_maxiter,
                  dot=dot, A0=lambda v: free * K(free * v) + con * v)
        torch.cuda.synchronize()
        out[name] = dict(iters=int(res.iters), loop_applies=res.loop_applies,
                         cg_residual=float(res.residual),
                         true_residual=true_residual(res.x),
                         seconds=time.perf_counter() - t0)
        check(bool(torch.isfinite(res.x).all()),
              f"cg_split {name}: non-finite solution")
        xs[name] = res.x
    out["x_rel_diff"] = float((xs["K2"] - xs["K1"]).abs().max()
                              / xs["K1"].abs().max())
    emit("cg_split", config="cavity3d 24^3 ngl=4 f32, free-slip stage after "
         "2 steps", **out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    import pynama_tpu_torch  # noqa: F401 -- fail before printing anything
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = phase_device(torch)
    phase_build()
    record = phase_kernels(torch, dev)
    decomp = phase_decomp(torch, dev)
    phase_parity(torch, dev)
    launches, problem, t_main = phase_main(torch, dev)
    # the last profiler windows, before the fdm phase's CUDA graph captures
    # (after them the profiler drops more records at a window's head)
    phase_rhs_trace(torch, problem, t_main)
    phase_cg_split(torch, problem)
    phase_taylor_green3d(torch, dev)
    phase_fdm(torch, dev)

    record["launches"] = launches
    kernels = [("fused_apply", "fused_apply.cu", "pynama_tpu/ops/fused.py:180",
                record),
               ("fused3x_apply", "fused3x.cu", "exp/mm3x.py:41",
                decomp["fused3x"]),
               ("variant_apply", "decomp.cu", "exp/fused_decomp.py:44",
                decomp["variant"]),
               ("plainmm_apply", "decomp.cu", "exp/fused_decomp.py:148",
                decomp["plainmm"])]
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"pynama_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "device_us": r["device_us"], "plain_device_us": r["plain_device_us"],
        **{k: r[k] for k in ("gemm3x_device_us", "gemm3x_bound_us")
           if k in r}}
        for name, src, replaces, r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
