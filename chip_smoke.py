"""GPU smoke run of pynama_tpu_torch: build the kernels, check them, drive
the main path, the analytic-function case, the FDM preconditioner, the
global-layout path (direct, Operators, GMRES), the command line
(run_case.py and its IO), gmsh meshes (quads and hexes, the gather DSS and
the sum-factorized K), the immersed-boundary cases and, at full size,
the exp/ decomposition runs, sharded runs, cut-down long-horizon
validation runs, cut-down FS-stage analyses and measurement drivers, and
the Schwarz preconditioner.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc; it
builds `pynama_tpu_torch/csrc/` into `pynama_tpu_torch/_build/` on first
use. Phases, each printing its own line; any failure raises and the script
exits non-zero without the final result line:

1. device   the card, its power limit, torch and CUDA versions
2. build    nvcc build of the kernel library (seconds, ptxas register use)
3. kernels  fused_apply's CUDA kernel against its plain PyTorch version on
            the card, at every operator shape of the engine (3D ngl=4 24^3,
            3D ngl=3 25^3, 3D ngl=7 8^3, 2D ngl=3 50x50, 35x35 and 70x70,
            2D ngl=4 10x10, degenerate extents), float32 and
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
4. parity   small f64 cases, each one rhs_local (Problem.rhs for the
            direct solve) and a 3-step transient on the GPU (kernel)
            against the CPU (plain version), relative error <= 1e-9, same
            accepted steps: the 3D no-slip cavity (3^3 ngl=3), the 3D
            Taylor-Green case (3^3 ngl=3), the flat plate with mixed walls
            (4^2 ngl=3 from t=0.1), the cavity under pc="fdm", the 2D
            cavity-2d case (4^2 ngl=3) under solver="direct", the 3D
            cavity under solver="gmres" (1 step), and two gmsh cases on
            the engine with the sumfact K and the gather DSS: Taylor-Green
            on 4^2 distorted quads (ngl=4) and 3D Taylor-Green on 3^3
            distorted hexes (ngl=3); and tests/test_ibm.py's cylinder on
            8^2 ngl=3, static (direct solve) and moving (CG), through the
            IBM classes and their global rhs
5. main     the flagship no-slip 3D lid-driven cavity (24^3 elements,
            ngl=4, float32, CG rtol 1e-6): Problem.setUp() and 2 accepted
            adaptive steps through start_solver(); prints setup phases,
            seconds per step, CG iterations per solve, kernel launches (which
            must account for every operator application) and peak memory;
            the CG epilogue's launches (ops/cg_epilogue.py), counted from 0
            around the run: cg_pap, cg_xr and cg_p once per CG-loop
            application each, cg_rz never (Jacobi: the divide is in the
            kernels)
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
            velocity, K1's launches in it against the expected count, and
            the CG epilogue's: cg_pap, cg_xr and cg_p once per CG-loop
            application, cg_rz as often under pc="fdm" and never under
            pc="jacobi"; in
            f64 (CG rtol 1e-10) the velocities agree to 1e-6 and FDM takes
            fewer iterations on both stages; in f32 (rtol 1e-6) a record:
            iterations, CUDA-event ms per solve (median of 3), and per call
            of the FDM apply and of K1 the event ms and, from one call
            captured in a CUDA graph, its kernel and copy nodes and the
            device µs of graph replays (`_graph_record`); the FDM apply's
            per-mode block step alone, broadcast against einsum; the FDM
            setup seconds
10. global_direct
            the cavity-2d case file at full width (50^2 elements, ngl=3,
            20,402 velocity dofs, no-slip), float32 with no solver option:
            "auto" must resolve to the direct solve with no engine; setUp
            (the two dense factors: host assembly and device Cholesky
            seconds apart) and 3 accepted steps through the global layout
            (Problem.rhs); s/step, one warm rhs, peak memory, diagnostics()
            after each step, K1 launches (0 on this path); then in float64
            from the state reached, one Problem.rhs of the direct solve
            against rhs_local of the engine's CG at rtol 1e-12, relative
            <= DIRECT_RHS_LIMIT, with K1's launches == expected
11. global_ops
            the taylor-green3d case file (25^3 ngl=3, f64): the global
            Operators (apply_op) against the engine's curl/srt/div_srt (K1)
            on the analytic velocity, relative <= OPS_LIMIT, with times of
            both; operators_errors(1.0) beside the JAX package's, and
            diagnostics() at t = 0 against the JAX package's
            (DIAG_LIMIT)
12. gmres   the same case, f64 at rtol 1e-10: kle_errors([0.5, 1.0]) with
            the engine's CG and with its GMRES (Jacobi), then one solve
            with GMRES under pc="fdm"; iterations, ms per solve and µs per
            iteration, K1's launches == expected in each, the errors
            within KLE_AGREE_LIMIT of CG's, relative to the exact
            velocity's norm (or its warm start's, where that is larger)
13. cli     the command line, pynama_tpu_torch.run_case, in process, each
            run in a directory of its own under a temporary one (the IO
            route is printed: "hdf5" where h5py imports, else "binary"):
            (a) cavity.yaml at its own size (30x10x10 ngl=3, 80,703
            velocity dofs, f32, "auto" -> CG at rtol 1e-6, dt0 the file's
            own) cut to CLI_STEPS accepted steps by a JSON copy of the
            file, through run_case.main (without h5py: the same setup and
            Problem.run(fast_io=True) with no viewer), against
            Problem.setUp(); start_solver() on the same config: same steps
            and CG iterations, fields within CLI_FIELD_LIMIT, K1 launches
            == the applications its CG log implies, the last snapshot's
            vorticity == the final p.vort; setup phases, s/step with the
            writer and without, the per-step save cost as their
            difference and timed alone (to_global, the write), peak
            memory; (b) the -fast-io run (without h5py: (a) itself): the
            native writer async, every snapshot read back equal to the
            field saved; (c) -checkpoint then -resume (h5py only: else
            recorded as not run): the resumed run starts at the
            checkpoint's t from its fields, bitwise; (d) taylor-green3d.yaml
            -test kle at 25^3 ngl=3 f32: the KLE |error| within
            KLE_ERR_LIMIT of the JAX package's (KLE_REF_ERR), K1 launches
            == expected; (e) -trace around a 1-step cavity run (3x1x1
            mesh): the Chrome trace holds K1 kernel records
14. unstructured
            gmsh meshes through Problem and run_case, written by the
            script (bench.py's hex writer; the quad rule of
            tests/msh_fixtures.py): (a) bench.py's hex config (10^3
            hexes distorted by 0.12, ngl=4, f32, uniform flow, CG rtol
            1e-6) set up with sumfact on and off: setup phases, device µs
            and event ms of apply_K on each route and of the gather DSS
            alone beside their bounds, peak memory; sumfact within 1e-5
            of dense, duplicate slots bitwise equal; (b) 3D Taylor-Green
            on those hexes, 3 steps: s/step, CG iterations, the vorticity
            error <= 2x the JAX package's (HEX_TG3D_REF_ERR), K1 and its
            DSS pass never launched; (c) 2D Taylor-Green on 50^2
            distorted quads (ngl=3, 20,402 velocity dofs) with no solver
            option: "auto" must take the direct solve; setup (host
            assembly, device factor), s/step, the error <= 2x the JAX
            package's (QUAD_TG_REF_ERR); (f) that case file with
            max-steps 2 through run_case, fields within CLI_FIELD_LIMIT of
            (c)'s after 2 steps; (d) sumfact=True on the flagship box
            mesh: apply_K (sumfact product + K1's DSS pass, dss_pass)
            within 1e-5 of K1's, device µs of each part beside K1's, and
            one rhs_local of the flagship's state: K1 6 launches, the DSS
            pass 4 + the CG loops' applications; (g) first, the sumfact
            kernel (csrc/sumfact_apply.cu) against apply_sumfact_k_ref at
            every instantiated (dim, ngl) and at 25^3 ngl=3, 10^3 ngl=3
            and 4 (f32 within F32_LIMIT, f64 SUMFACT_F64_LIMIT), its
            device µs beside the bound and the plain chain's; in (b) one
            sumfact launch per apply_k.element span
15. ibm     the three IBM case files at their own meshes through
            run_case.make_problem, f32 (CG rtol 1e-6 where "auto" takes
            CG), each cut to IBM_STEPS accepted steps replaying the steps
            of tools/ibm_reference.py's JAX f64 run (ibm_replay; the card's
            error norm of each step is printed): (a) ibm-static.yaml (50^2,
            20,402 velocity dofs, "auto" -> direct), (b) ibm-dynamic.yaml
            (100^2, 80,802, CG; the moving body's matrix-free correction
            CG), (c) ibm-sphere.yaml (16x12x12, 61,875, CG); for each: setup
            seconds by phase with the IBM part (ibm_tables, ibm_core,
            ibm_factor) apart, C's condition number in f64, s/step, CG and
            correction-CG iterations, the correction's device µs per step
            (profiler) and event ms, max|H v - v_body| after the last
            correction (<= IBM_BODY_RES_LIMIT), the cd, cl, cd_phys and
            cl_phys histories against the JAX package's (force_gaps <=
            IBM_FORCE_LIMIT), peak memory, K1 launches == the engine's
            applications (0 in (a)), and one RK stage traced: no
            host<->device copy as large as a field; (d) ibm-dynamic.yaml
            through run_case (-device cuda, max-steps cut to IBM_STEPS in a
            JSON copy, the same steps replayed, no snapshot due): fields
            within CLI_FIELD_LIMIT of (b)'s, K1 launches == expected; (e)
            spread_S twice on (b)'s last tables: bitwise equal
16. sharded SHARDED_NDEV ranks on the one card, spawned by the port's
            entry points (parallel/sharded_engine.py: gloo, every
            collective staged through pinned host buffers, since NCCL
            takes one rank per card): (a) f64 parity against one device on
            the card, relative error <= PARITY_LIMIT, the same accepted
            steps and end time: the 3D no-slip cavity (2^3 ngl=3, CG rtol
            1e-10, 3 steps through Problem(..., ndev=2).start_solver), the
            same under pc="fdm" (the slab FDM, 1 step), one rhs of the
            same with overlap_dss off and on on the plain DSS route (each
            other and one device's K1 rhs), one rhs of 3D Taylor-Green on
            4x3x3 distorted hexes (the gather DSS and its interface-row
            psum, job_rhs), the moving cylinder on 8^2 ngl=3 through
            _start_solver_sharded_ibm (3 steps, cd too); (b) the flagship
            (24^3 ngl=4, f32, CG rtol 1e-6) in 2 slabs of 12x24x24, 1
            accepted step from phase 5's state with dt0 1e-3, against the
            same step on one device: s/step, attempts (equal), CG
            iterations per solve on each rank, peak memory per rank, staged
            bytes per apply, fields within SHARDED_F32_LIMIT; (c) on every
            rank of every run K1's launches == the rank's own operator
            applications, and every rank took the same steps and CG
            iterations
17. validation
            cut-down versions of the two long-horizon validation drivers
            (pynama_tpu_torch/exp/): (a) tests/test_cavity_re100.py's
            coarse Re=100 cavity march (10x10 ngl=4, f64, CG rtol 1e-9,
            maxiter 4000) cut to t=1, through exp/cavity_re100.py's
            march_segments: its centerline profiles against the JAX
            package's own march (CAVITY_REF, within CAVITY_PROFILE_LIMIT),
            its accepted steps within CAVITY_STEP_SLACK of the JAX
            package's; (b) the static cylinder of exp/ibm_cd.py at 35^2
            (f32, CG rtol 1e-6, RK tolerances 1e-4) to t=30 through
            exp/ibm_cd.py's `run`: the cd_phys and cd_reference_definition
            tail means (t > 0.7 t_end) within the TPU run's tail std of its
            tail mean (exp/ibm_cd_r05.json), max|H v - v_body| after the
            last correction <= IBM_BODY_RES_LIMIT; in each, s/step, steps,
            CG iterations, and K1 launches == the engine's applications
18. analyses
            the port's twins of the JAX package's FS-stage analyses and
            measurement drivers (pynama_tpu_torch/exp/), cut down: (a)
            fs_spectrum.analyze at 3^3 and 4^3 ngl=4, float64 on the card
            (cuSOLVER): every Jacobi and FDM kappa, k-drop kappa and census
            count of the FS and main stages against the JAX package's
            (FS_REF, tools/fs_reference.py) within FS_LIMIT, counts equal;
            (b) fs_woodbury.analyze at 3^3: K = S + B^T B to
            FS_K_CHECK_LIMIT, the G/I, G/diag, qp-block and elem-block CG
            counts within FS_ITER_SLACK of the JAX package's (K/jacobi and
            K/Sinv recorded beside its); (c) fs_walls.analyze at 2^3: every
            variant's kappa within FS_LIMIT; K1 launched 0 times in each;
            wall seconds and peak memory; (d) the five measurement drivers
            at cut-down sizes and chains (ANALYSES_DRIVERS): fused_ab (12^3
            ngl=4), ngl7_blocks (4^3 ngl=7), sumfact_chip, sumfact_roofline
            and dss_gather_opt (5^3 hexes), each raising if its agreement
            check fails, one line of its times each; K1 launches == the
            applications fused_ab and ngl7_blocks made, 0 in the gmsh
            drivers
19. schwarz the reference's pc="schwarz" (element-wise additive Schwarz
            mixed with Jacobi, its element pseudo-inverse KinvT built on
            the host): (a) the flagship config (24^3 ngl=4, f32, CG rtol
            1e-6, maxiter SCHWARZ_MAXITER) set up and stepped once from
            rest under pc="jacobi" and under pc="schwarz": setup, s/step,
            FS and main CG iterations and their Schwarz/Jacobi ratios, K1
            launches == the step's applications (under Schwarz one more K1
            call per CG-loop application and one per solve: the
            preconditioner's DSS(t @ KinvT)), the CG epilogue's launches
            as in phase 9 (cg_rz once per application under Schwarz), no
            solve at the cap; (b) K1
            with KinvT in place of K^T at that shape, on the input the
            preconditioner gives it, against its plain version (f32 with
            the engine's KinvT, f64 with the host's, F32_LIMIT /
            F64_LIMIT, duplicate slots bitwise equal), event ms beside
            K1 with K^T, the plain version and the bound; (c) run_case
            -pc schwarz on cavity.yaml at its own size cut to 1 step, K1
            launches == expected; (d) the 3^3 ngl=3 cavity under Schwarz,
            f64, GPU against CPU within PARITY_LIMIT (as phase 4)
20. cg_epilogue
            the CG epilogue's kernels (csrc/cg_epilogue.cu) at the
            flagship's local velocity length (2,654,208 values), f32 and
            f64: one iteration's steps, Jacobi (cg_pap, cg_xr, cg_p) and
            with an eager preconditioner (cg_pap, cg_xr, cg_rz, cg_p),
            against the plain steps on the same values on the CPU
            (relative error <= 1e-5 f32, 1e-12 f64; the int64 scalars
            bitwise), their launch counters; each kernel's device µs beside
            its HBM bound, the timed calls rotating among EPILOGUE_RING
            states so that they read HBM and not the 50 MB L2; and the
            device µs of one Jacobi iteration's update as eager PyTorch
            launches, rotated the same way

The last three lines are the card's name and power limit (nvidia-smi), the
record of the four kernels as JSON (K1's also with `launches_by_path`: its
launches in the main path's run and in each later path's, each counted from
0: the global_direct CG rhs, global_ops, the gmres phase's GMRES solves,
the cli phase's production run (a) and its -test kle solve (d), the
unstructured phase's gmsh parts (a)-(c) and (f), which must be 0, and its
box-mesh sumfact rhs (d), the ibm phase's (a)-(d), `ibm_static` 0, the
sharded phase's runs summed over their ranks, `sharded_overlap` and
`sharded_hex` 0 (the plain DSS route, a gmsh mesh), the validation
phase's `validation_cavity` and `validation_ibm_cd`, the analyses
phase's `analyses_fused_ab` and `analyses_ngl7`, the schwarz phase's
`schwarz` (the Schwarz step of (a)) and `schwarz_cli`;
and `dss_pass_launches_by_path`: its DSS pass
launched alone in (d)), then the CG epilogue's four kernels (`launches` in
the main path's run, `launches_by_path` in phase 9's and 19's solves too,
the largest relative error against the plain version, and phase 20's
device µs and HBM bound µs by dtype and preconditioner form), and the
result line {"ok": true, "device": {...}}.
A kernel's `bound_ms` is the larger of the
operations of its function over the card's peak rate for their type and its
bytes (each input read once, each output written once) over the memory rate,
from the H100 SXM data-sheet peaks below.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# the global_direct phase: one f64 Problem.rhs of the direct solve against
# rhs_local of the engine's CG at rtol 1e-12, relative max-norm
DIRECT_RHS_LIMIT = 1e-8
# the global_ops phase: the global Operators against the engine's (K1)
OPS_LIMIT = 1e-10
# the JAX package's diagnostics() at t = 0 and operators_errors(1.0) on the
# taylor-green3d case file (25^3 ngl=3), f64 on the CPU
# (`python tools/global_reference.py`); the port's diagnostics are held to
# them at DIAG_LIMIT, relative. The operator errors are printed beside the
# port's, not gated: at viscous time 1.0 (t = 12.5) the fields have decayed
# to ~1e-13 and the errors sit at round-off (the convective one at 5e-26)
TG3D_DIAG_REF = {"kinetic_energy": 0.1875000000000002,
                 "enstrophy": 44.413219804902134,
                 "div_l2": 0.02017817529489499}
TG3D_OPS_ERR_REF = (4.616403257094228e-26, 2.5647494785659055e-13,
                    3.947764263342739e-15)
DIAG_LIMIT = 1e-8
# the gmres phase: |error_cg - error_gmres| <= this times the norm of the
# exact velocity at that viscous time, or of the warm start the sweep hands
# the solve (the previous time's velocity) where that is larger: at
# tau = 1.0 the field has decayed to 2e-10 of tau = 0.5's, below the
# round-off of that start, and CG's and GMRES's errors there differ by
# 1.5e-5 of the field (both solves converged to rtol 1e-10)
KLE_AGREE_LIMIT = 1e-6
# the cli phase: taylor-green3d.yaml -test kle (25^3 ngl=3) through the
# port's run_case at float32, CG rtol 1e-6, held to the JAX package's |error|
# at the same config, f64 on the CPU at its default CG rtol 1e-12
# (`python tools/kle_reference_error.py`: 2.6233e-3; at rtol 1e-6 it reads
# 2.6834e-3, 2.3% higher). KLE_ERR_LIMIT, relative, allows that rtol effect
# and f32 round-off of the solve (~1e-7 of the 312.2 velocity norm, ~1% of
# the error) twice over
KLE_REF_ERR = 0.002623331854467238
KLE_ERR_LIMIT = 0.05
# the cli phase's production runs: cavity.yaml cut to CLI_STEPS accepted
# steps, the fields of the run through run_case within CLI_FIELD_LIMIT
# (relative max-norm) of Problem.setUp(); start_solver() on the same config
CLI_STEPS = 3
CLI_FIELD_LIMIT = 1e-6
# the unstructured phase: bench.py's hex section (10^3 hexes, interior
# vertices moved by up to 0.12 of an element, ngl=4) and cavity-2d.yaml's
# size as 50^2 distorted quads (ngl=3); 3 accepted steps of each
# Taylor-Green transient, 2 of the CLI run
HEX_N, QUAD_N, MESH_DISTORT = 10, 50, 0.12
UNSTRUCT_STEPS, UNSTRUCT_CLI_STEPS = 3, 2
# the JAX package's own relative max-norm vorticity errors on those meshes
# (taylor_green3d on the hexes, ngl=4, CG rtol 1e-6; taylor_green on the
# quads, ngl=3, the engine's CG at rtol 1e-12 standing in for the direct
# solve, whose 20,402^2 dense factor is kept off the CPU), f64 on the
# CPU from dt0 1e-3 at atol = rtol = 1e-4, as the phase runs them, to
# *_REF_T, the end times the phase's 3 f32 steps reached on an NVIDIA H100
# 80GB HBM3 (`python tools/unstructured_reference_error.py`); each gate is
# twice the error
HEX_TG3D_REF_ERR = 0.055305306882286326
HEX_TG3D_REF_T = 0.01695056634805064
# the sumfact kernel (csrc/sumfact_apply.cu) against apply_sumfact_k_ref:
# every instantiated (dim, ngl) at SUMFACT_SMALL_E random distorted
# elements, and exp/sumfact_roofline.py's distorted hexes at (E1d, ngl),
# relative max-norm within F32_LIMIT (f32) and SUMFACT_F64_LIMIT (f64); the
# timed calls rotate among SUMFACT_RING copies of the inputs (3 x 30 MB at
# 25^3 ngl=3 is past the H100's 50 MB L2)
SUMFACT_SMALL_E = 37
SUMFACT_TIMED = ((25, 3), (10, 3), (10, 4))
SUMFACT_F64_LIMIT = 1e-12
SUMFACT_RING = 3
QUAD_TG_REF_ERR = 0.0037709075973298566
QUAD_TG_REF_T = 0.012625623463579282
# the ibm phase: the three IBM case files at their own meshes, f32, depth
# cut to IBM_STEPS accepted steps from each uncut file's dt0 ((end-time -
# start-time) / (10 max-steps), which a cut max-steps would change)
IBM_STEPS = 3
IBM_CASES = (("ibm-static", 0.12), ("ibm-dynamic", 3e-4),
             ("ibm-sphere", 1e-3))
# the JAX package's float64 runs of those cuts on the CPU, at the adaptive
# stepper's defaults, the engine's CG at rtol 1e-12 (for ibm-static too,
# in place of its direct solve): accepted times, the controller's dt after
# each step, the force histories and max|H v - v_body| after the last
# correction (`python tools/ibm_reference.py --part ref`, 137 s). The phase
# replays these steps (ibm_replay), so both sides take the same dt
IBM_REF = {
    "ibm-static": {
        "times": [0.0969500980362956, 0.19215974006220407,
                  0.29872802545287575],
        "dt": [0.09520964202590847, 0.10656828539067166,
               0.11526139864209596],
        "cd": [-2657858.9443060607, -1974437.9067851948,
               -1621517.6148008755],
        "cl": [-21.665588573407597, -48.410383465824154,
               -36.990331891141324],
        "cd_phys": [-34.029822431723204, -25.27966035003635,
                    -20.761055292191976],
        "cl_phys": [-0.00027739475550857284, -0.0006198209866340579,
                    -0.00047360467666759265],
        "body_res": 4.133320233362866e-17},
    "ibm-dynamic": {
        "times": [0.0003, 0.0032999999999999995, 0.017280747524982692],
        "dt": [0.0029999999999999996, 0.013980747524982691,
               0.013463981586557976],
        "cd": [-16359897.66407506, -2985984.6630630298,
               -3220313.3562505147],
        "cl": [6167043.759734471, 1123210.357156314, 1179441.7799015958],
        "cd_phys": [-41.63737463488746, -7.599592896170636,
                    -8.195979975496694],
        "cl_phys": [15.6956673376799, 2.8586688862608582,
                    3.0017827897322347],
        "body_res": 6.893502696116122e-13},
    "ibm-sphere": {
        "times": [0.001, 0.011, 0.111],
        "dt": [0.01, 0.1, 0.6366812634999344],
        "cd": [-126079.8916354505, -5987.723926750888, -725.3725049596824],
        "cl": [-109.45769946216224, -8.537444014706281,
               -0.4780729097288652],
        "cd_phys": [-151.35975509281403, -7.188302713147065,
                    -0.8708145547841499],
        "cl_phys": [-0.13140470196087417, -0.010249258770945487,
                    -0.0005739297329212193],
        "body_res": 1.0965394477924893e-16},
}
# the card's f32 force histories against IBM_REF: each within
# IBM_FORCE_LIMIT of its force's scale (force_gaps). The limit comes from
# the port's own f32 (CG rtol 1e-6) vs f64 gap on the CPU, the same case
# files cut to smaller meshes replaying the f64 steps (`python
# tools/ibm_reference.py --part gap`): <= 5.5e-7 on ibm-static (12^2,
# 25^2) and <= 1.3e-5 on ibm-sphere (8x6x6, 12x9x9), and on ibm-dynamic
# growing with the mesh as (n/16)^2, 8.1e-6, 3.9e-5, 1.6e-4 at 16^2, 32^2,
# 64^2 (an f32 CG stopped at rtol 1e-6 leaves an error that grows with
# the system's condition), which reaches 3.2e-4 at the file's 100^2: the
# limit is 3x that, rounded up. The body residual max|H v - v_body| after
# the last correction (JAX f64: 1e-16 to 7e-13; the port's f32 on those
# cuts: <= 6.9e-7) is held to IBM_BODY_RES_LIMIT, 14x that, rounded up
IBM_FORCE_LIMIT = 1e-3
IBM_BODY_RES_LIMIT = 1e-5
# the sharded phase: ranks on the one card, and the flagship's f32 field gap
# between its sharded step and its one-device step (see SHARDED_F32_LIMIT)
SHARDED_NDEV = 2
# The sharded flagship step sums in another order than the one-device step
# (the slab exchange, the psums), so its f32 CG stops at other iterates
# within rtol 1e-6. `python -m pynama_tpu_torch.exp.sharded_f32_gap --nelem
# 6 8 --device cpu` (CPU, f32, the flagship's physics, 1 step from 2 steps' state on 2
# ranks) measured a max-norm gap of 5.1e-7 / 1.5e-6 (vorticity / velocity)
# at 6^3 and 4.8e-7 / 1.4e-6 at 8^3. The gap for a given residual grows at
# most with the condition number, ~h^-2: 9x from 8^3 to 24^3, ~1.3e-5. The
# limit keeps ~7x over that; a wrong plane exchange or psum is O(1).
SHARDED_F32_LIMIT = 1e-4
# the validation phase (a): tests/test_cavity_re100.py's coarse march of
# the Re=100 cavity (pynama_tpu_torch/exp/cavity_re100.py: 10x10 ngl=4,
# CG rtol 1e-9, maxiter 4000, one segment) in f64 on the card, cut to t=1:
# to the test's t=10 it took 788 s on an NVIDIA H100 80GB HBM3 at 700 W
# (284 steps at 2.77 s/step, the CG host-bound), more than this script's
# time limit leaves beside its other phases. That march to t=10 ran once
# through pynama_tpu_torch/exp/cavity_re100.py (its artifact
# cavity_re100_coarse_h100.json there is held against the TPU artifact's
# t=10 snapshot and the JAX package's march in
# tests/test_torch_cavity_re100.py)
CAVITY_COARSE = (10, 4, 1.0)
# the JAX package's own march to t=1, f64 on the CPU (`python
# tools/cavity_re100_reference.py --part jax --checkpoints 1`): its accepted
# steps and its centerline profiles, normalized by the lid velocity, at
# the coarse mesh's nodes (y for u, x for v, 31 each); 16 s
CAVITY_REF = {
    "steps": 34,
    "u_centerline": [0.0, -0.012347308939922674, -0.027386484896517998,
        -0.03792319294792617, -0.04208677257662269, -0.05565070434990612,
        -0.05680069831967959, -0.06963658640411312, -0.07622170718706095,
        -0.09204859810635133, -0.09080524331568719, -0.11111450755981067,
        -0.10965452993075846, -0.13053886972839487, -0.1380608855006352,
        -0.15864997873176362, -0.15239182327252246, -0.16623438276223854,
        -0.15144393788829622, -0.16015067345987705, -0.13160438234354782,
        -0.12629593260569524, -0.08639110321430694, -0.03416788961669713,
        0.026040069535811918, 0.08375036820969639, 0.22746411337820863,
        0.34789612635333683, 0.4945409949433467, 0.7990306277079527, 1.0],
    "v_centerline": [0.0, 0.027347679981035176, 0.06468224545610271,
        0.08013884255188905, 0.0897506830695825, 0.10142845462464213,
        0.10230553006871249, 0.10551738907918794, 0.10088467530205078,
        0.10089398102330713, 0.09245969295917726, 0.08527516716420071,
        0.07436748665482168, 0.0691388017203798, 0.05089926591040218,
        0.04100277762108146, 0.02558234757778953, 0.0002812427325007385,
        -0.018385010903175646, -0.038348481820937946, -0.07123201386492418,
        -0.09367450886440039, -0.11051534967272574, -0.13658058927286537,
        -0.14232456004744756, -0.14597742116730278, -0.1320620132557077,
        -0.11588062187194163, -0.08685516499679125, -0.03563479024527717, 0.0],
}
# The card's f64 march sums in another order than the CPU's (K1's GEMM and
# DSS, the CG's dots), and its CG stops at other iterates within rtol
# 1e-9. Two CPU runs that differ only so, the port against the JAX package
# (`python tools/cavity_re100_reference.py --part both --checkpoints 1`,
# one thread, 114 s), took the same 34 steps, and their profiles differ by
# 1.9e-11 (u) and 1.2e-10 (v) of their max-norms. The limit keeps ~100x
# over that and lies far below the stepper's tolerance (3e-4), the scale
# at which another step sequence or a wrong operator shows. The dt
# controller is continuous in the error norm away from an accept/reject
# decision, which no attempt meets within rounding, so the step count
# must be the JAX package's
CAVITY_PROFILE_LIMIT = 1e-8
CAVITY_STEP_SLACK = 0
# the validation phase (b): exp/ibm_cd.py's static cylinder at its
# coarsest resolution, f32, to t=30 (pynama_tpu_torch/exp/ibm_cd.py `run`:
# CG rtol 1e-6, maxiter 800, RK tolerances 1e-4; 61 s on the card), its
# drag tails held within the TPU run's tail std of the TPU's tail mean
# (exp/ibm_cd_r05.json). 50^2 (126 s) and 70^2 (246 s) ran once through
# pynama_tpu_torch/exp/ibm_cd.py (its artifact ibm_cd_h100.json there,
# tests/test_torch_ibm_cd.py)
IBM_CD_NELEM = (35,)
IBM_CD_T_END = 30.0
IBM_CD_TPU_ART = "exp/ibm_cd_r05.json"
# the analyses phase (18): the port's FS-stage analyses
# (pynama_tpu_torch/exp/fs_*.py) in float64 on the card at cut-down sizes,
# held against the JAX package's own numbers at those sizes, f64 on the
# CPU (`python tools/fs_reference.py`, 95 s on 4 threads): per size the
# fs_digest of each analysis. The card's eigensolvers (cuSOLVER) sum in
# another order than the CPU's LAPACK. Two CPU runs that differ only so,
# the port against the JAX package (the same command), differ by at most
# 1.8e-12 (spectrum at 4^3; 1.0e-12 at 3^3, walls 9.4e-13) in any kappa,
# k-drop kappa or walls variant's kappa, with equal census and CG counts;
# FS_LIMIT keeps ~100x over that. A census count may differ only where an
# eigenvalue lies within FS_LIMIT of its threshold (the record's margin:
# >= 4.5e-5 at these sizes). The woodbury CG counts follow the summation
# order: on the CPU the JAX package alone takes G/I 212 or 214 at 3^3 with
# 1 or 2 BLAS threads (DESIGN's 214), the port 212; at 2^3 the G counts of
# the pair differ by up to 1 and K/jacobi's by 3 (258 / 261). So the G
# counts (the ones the round-5 verdict reads) are held within FS_ITER_SLACK
# of the JAX package's, and the K counts are recorded beside its own
FS_ITER_SLACK = 2
FS_SPECTRUM_NE = (3, 4)
FS_WALLS_NE = 2
FS_WOODBURY_NE = 3
FS_REF = {
    'spectrum': {
        3: {
            'FS': {
                'jacobi': {
                    'kappa': 1689.5663263859833,
                    'kdrop': [1689.5663263859833, 1523.9874737457844,
                              1277.389010188945, 1015.6079601962456,
                              749.3170372079157, 433.56483396697683,
                              124.42064566343572, 61.40223995890048,
                              32.193268503084596],
                    'low': [6, 73, 108, 267],
                    'high': [570, 56],
                    'margin': 0.00037717162203643184},
                'fdm': {
                    'kappa': 1358.755040715516,
                    'kdrop': [1358.755040715516, 1140.6854418960381,
                              1037.4983307073235, 728.3875037643251,
                              383.24431731101447, 60.09745263600026,
                              40.040867873549104, 28.31341100976546,
                              20.15141612487593],
                    'low': [16, 38, 47, 223],
                    'high': [145, 0],
                    'margin': 0.0006517645936311434}},
            'MAIN': {
                'jacobi': {
                    'kappa': 119.43018582441447,
                    'kdrop': [119.43018582441447, 111.85959773728507,
                              97.21279520682987, 68.85293023892504,
                              54.35596706424407, 41.532717116157556,
                              31.86345963519139, 24.759062572474324,
                              16.645438685579574],
                    'low': [0, 0, 5, 60],
                    'high': [337, 1],
                    'margin': 0.0011282327812996984},
                'fdm': {
                    'kappa': 44.65936029232679,
                    'kdrop': [44.65936029232679, 42.06902266305341,
                              37.34212903156483, 27.95264535532528,
                              24.925776093198923, 23.12878781883829,
                              19.712762262077373, 15.29276596106573,
                              9.84747954765525],
                    'low': [0, 0, 0, 37],
                    'high': [38, 0],
                    'margin': 0.0004972623309569268}}},
        4: {
            'FS': {
                'jacobi': {
                    'kappa': 1680.4282361325445,
                    'kdrop': [1680.4282361325445, 1527.1057840692122,
                              1390.097145266266, 1112.0258125541145,
                              968.4523028708871, 563.2170914172433,
                              272.34005468269544, 132.82955904368606,
                              63.38004084322279],
                    'low': [7, 125, 254, 601],
                    'high': [1346, 110],
                    'margin': 0.00023474458839722878},
                'fdm': {
                    'kappa': 1221.4900897364817,
                    'kdrop': [1221.4900897364817, 1085.737810440143,
                              1018.1837185265514, 822.4207156605792,
                              573.6269991642837, 79.52724835201307,
                              54.673428456164274, 41.72926170339614,
                              27.862796020681337],
                    'low': [21, 50, 77, 494],
                    'high': [302, 0],
                    'margin': 4.5207331900387615e-05}},
            'MAIN': {
                'jacobi': {
                    'kappa': 237.12691771239201,
                    'kdrop': [237.12691771239201, 223.94274040945675,
                              181.72758470829262, 136.7791314386104,
                              106.29988648982673, 83.1404747572363,
                              60.93993234233374, 42.127243325236485,
                              31.404689339205216],
                    'low': [0, 0, 23, 198],
                    'high': [932, 10],
                    'margin': 0.0018174202354973579},
                'fdm': {
                    'kappa': 56.90160316088722,
                    'kdrop': [56.90160316088722, 54.27465523888948,
                              51.003412859326865, 48.15968110644199,
                              34.38920802066557, 32.302782223460454,
                              26.363298464381604, 22.318448444603458,
                              18.140432911914672],
                    'low': [0, 0, 0, 148],
                    'high': [120, 0],
                    'margin': 0.00029165677051046224}}}},
    'walls': {
        2: {
            'jac': 1800.1777207449088,
            'fdm': 1698.0463651942498,
            'jac+ww': 973.8108526034055,
            'fdm+ww': 771.8894042014173,
            'fdm+ww1': 6.20720249213158,
            'fdm+schur': 6148.461381158463,
            'jac+schur': 8146.2402707161145,
            'fdm+6sl(t3)': 8.594287150747453,
            'jac+6sl(t3)': 10.54482390425316,
            'fdm+6slF(t3)': 1558.7974811378608,
            'jac+6slF(t3)': 1501.5270294701804,
            'fdm+6sl(t6)': 1.8700919007850114,
            'jac+6sl(t6)': 1.9655082087834237,
            'fdm+6slF(t6)': 1698.0463651958612,
            'jac+6slF(t6)': 1608.3582139762666}},
    'woodbury': {
        3: {
            'K/jacobi': 273,
            'K/Sinv': 223,
            'G/I': 212,
            'G/diag': 109,
            'G/qp-block(4)': 129,
            'G/elem-block(108)': 132}}}
FS_LIMIT = 2e-10
# K = S + B^T B, relative to max|K|: round-off of one f64 product
FS_K_CHECK_LIMIT = 1e-13
# the five measurement drivers at cut-down sizes and chain lengths
# (pynama_tpu_torch/exp/), each with its own agreement check
# the Schwarz phase's CG cap, above phase_main's 1000: Schwarz takes more
# iterations than Jacobi, 2.7x in the JAX package's measurement and a
# ratio that grows with the mesh on the port's CPU runs at 4^3, 6^3, 10^3
# ngl=4 (FS stage 3.0x, 4.3x, 6.1x: 2,420 iterations a solve at 10^3)
SCHWARZ_MAXITER = 20000
ANALYSES_DRIVERS = (
    ("fused_ab", ["1", "--ne", "12", "--n1", "50", "--target-s", "0.2"]),
    ("ngl7_blocks", ["--ne", "4", "--nit", "200", "--rounds", "2"]),
    ("sumfact_chip", ["5", "--nit", "200", "20", "--rounds", "2"]),
    ("sumfact_roofline", ["5", "--n1", "20", "--target-s", "0.2",
                          "--rounds", "2"]),
    ("dss_gather_opt", ["5", "--n1", "20", "--target-s", "0.2",
                        "--rounds", "2"]),
)
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
# CG states the epilogue's timed calls rotate among: 4 × cg_p's 32 MB
# (f32, the smallest working set) is well past the H100's 50 MB L2
EPILOGUE_RING = 4
EPILOGUE_STEPS = ("cg_pap", "cg_xr", "cg_rz", "cg_p")
# the CG epilogue's launches by path, counted from 0 around each
# (_epilogue_check), for the kernel record
EPILOGUE_BY_PATH = {}
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
    # the validation phase's meshes: the coarse cavity march, and the IBM
    # drag runs' 35^2 and 70^2 (pynama_tpu_torch/exp/ibm_cd.py)
    ("2d-ngl4-10^2", (10, 10), 4, [(2, 2), (1, 2), (2, 1), (2, 3), (3, 2)]),
    ("2d-ngl3-35^2", (35, 35), 3, [(2, 2), (1, 2), (2, 1), (2, 3), (3, 2)]),
    ("2d-ngl3-70^2", (70, 70), 3, [(2, 2), (1, 2), (2, 1), (2, 3), (3, 2)]),
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
    """No-slip lid-driven cavity on [0,1]^dim (dim = len(nelem)), the lid
    velocity on "up", every other wall at rest, zero initial vorticity."""
    dim = len(nelem)
    zero = [0] * dim
    sides = ("up", "down", "left", "right") + (("back", "front") if dim == 3
                                               else ())
    return {
        "name": "cavity3d" if dim == 3 else "cavity-2d",
        "material-properties": {"rho": rho, "mu": mu},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": zero, "upper": [1] * len(nelem)}},
        "time-solver": {"start-time": 0, "end-time": end_time,
                        "max-steps": max_steps},
        "boundary-conditions": {"no-slip": {
            s: (lid if s == "up" else zero) for s in sides}},
        "initial-conditions": {"vorticity": [0] * (3 if dim == 3 else 1)},
    }


def cavity2d_config(max_steps):
    """pynama_tpu/cases/yaml/cavity-2d.yaml as it is (50^2 elements, ngl=3,
    rho 0.5, mu 0.01, lid [2, 0], no-slip walls, end time 2) with the step
    count given."""
    return cavity_config((50, 50), 3, 0.5, 0.01, [2, 0], max_steps, 2.0)


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


def write_hex_msh(path, nx, ny, nz, distort):
    """bench.py's hex mesh writer (pynama_tpu_torch.exp.write_hex_msh)."""
    from pynama_tpu_torch.exp import write_hex_msh as write
    return write(path, nx, ny, nz, distort)


def write_quad_msh(path, nx, ny, distort):
    """An nx x ny grid of quads on [0,1]^2 as MSH 2.2, by the rule of
    tests/msh_fixtures.py (grid_quad_mesh, write_msh22): interior vertices
    moved by uniform(-1, 1) * distort * (1/nx, 1/ny) from numpy's
    default_rng(0), counter-clockwise cells, boundary lines in the physical
    groups down/right/up/left."""
    X, Y = np.meshgrid(np.linspace(0, 1, nx + 1), np.linspace(0, 1, ny + 1),
                       indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)
    rng = np.random.default_rng(0)
    interior = ((verts[:, 0] > 0) & (verts[:, 0] < 1)
                & (verts[:, 1] > 0) & (verts[:, 1] < 1))
    verts[interior] += (rng.uniform(-1, 1, (int(interior.sum()), 2))
                        * distort * np.array([1.0 / nx, 1.0 / ny]))

    def vid(i, j):
        return i * (ny + 1) + j

    quads = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
             for i in range(nx) for j in range(ny)]
    lines = {
        "down": [[vid(i, 0), vid(i + 1, 0)] for i in range(nx)],
        "right": [[vid(nx, j), vid(nx, j + 1)] for j in range(ny)],
        "up": [[vid(i, ny), vid(i + 1, ny)] for i in range(nx)],
        "left": [[vid(0, j), vid(0, j + 1)] for j in range(ny)],
    }
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$PhysicalNames\n5\n")
        for t, name in enumerate(lines, start=1):
            f.write(f'1 {t} "{name}"\n')
        f.write('2 5 "fluid"\n$EndPhysicalNames\n')
        f.write(f"$Nodes\n{len(verts)}\n")
        for k, (x, y) in enumerate(verts, start=1):
            f.write(f"{k} {float(x)!r} {float(y)!r} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{sum(map(len, lines.values())) + len(quads)}\n")
        eid = 1
        for t, name in enumerate(lines, start=1):
            for u, v in lines[name]:
                f.write(f"{eid} 1 2 {t} {t} {u + 1} {v + 1}\n")
                eid += 1
        for q in quads:
            f.write(f"{eid} 3 2 5 1 " + " ".join(str(c + 1) for c in q)
                    + "\n")
            eid += 1
        f.write("$EndElements\n")
    return path


def hex_uniform_config(path):
    """bench.py's hex config on the gmsh file `path`: ngl=4, rho 1, mu
    0.01, uniform flow [1, 0, 0] on every side and as initial velocity."""
    return {"name": "bench-hex",
            "material-properties": {"rho": 1.0, "mu": 0.01},
            "domain": {"ngl": 4, "gmsh-file": path},
            "boundary-conditions": {"uniform": {"velocity": [1, 0, 0],
                                                "vorticity": [0, 0, 0]}},
            "initial-conditions": {"velocity": [1, 0, 0]}}


def gmsh_tg_config(path, lib, ngl, max_steps):
    """The taylor-green (2D) or taylor-green3d case file's physics (rho 0.5,
    mu 0.01; `lib` on every side, as initial condition and as the exact
    solution) on the gmsh file `path`, with the step count given."""
    cf = {"custom-func": {"name": lib,
                          "attributes": ["velocity", "vorticity", "alpha"]}}
    return {"name": lib.replace("_", "-"),
            "material-properties": {"rho": 0.5, "mu": 0.01},
            "domain": {"ngl": ngl, "gmsh-file": path},
            "time-solver": {"max-steps": max_steps, "start-time": 0,
                            "end-time": 10},
            "boundary-conditions": cf, "initial-conditions": cf, "tests": cf}


def ibm_cylinder_config(nelem, vel, max_steps):
    """tests/test_ibm.py's cylinder: rho 0.5, mu 0.01, [-3, 3]^2 at ngl=3,
    uniform flow [1, 0], a circle of radius 0.5 at the origin, `vel`
    "static" or "dynamic"; a force entry every step."""
    return {"name": "ibm-test", "save-n-steps": 10,
            "material-properties": {"rho": 0.5, "mu": 0.01},
            "domain": {"ngl": 3, "box-mesh": {
                "nelem": list(nelem), "lower": [-3, -3], "upper": [3, 3]}},
            "time-solver": {"start-time": 0, "end-time": 0.5,
                            "max-steps": max_steps},
            "boundary-conditions": {"uniform": {"velocity": [1.0, 0.0]}},
            "initial-conditions": {"vorticity": [0]},
            "bodies": [{"type": "circle", "vel": vel, "radius": 0.5,
                        "center": [0, 0]}]}


def ibm_config(run_case, name, nelem=None):
    """IBM case file `name` (run_case.load_case of either package), depth
    cut to IBM_STEPS accepted steps, with save-n-steps 10: a force entry
    every step (every save-n-steps // 10) and no snapshot due; `nelem`
    cuts the mesh."""
    cfg = run_case.load_case(name)
    cfg["time-solver"]["max-steps"] = IBM_STEPS
    cfg["save-n-steps"] = 10
    if nelem is not None:
        cfg["domain"]["box-mesh"]["nelem"] = list(nelem)
    return cfg


@contextlib.contextmanager
def ibm_replay(ibm_module, dts, next_dts):
    """Replay a step history in the IBM cases of `ibm_module` (the port's
    cases.ibm): its AdaptiveStepper is replaced by one whose k-th step
    takes dts[k] and leaves next_dts[k] as the controller's dt (which the
    force history divides by), whatever the error norm. Yields the error
    norm of each step taken, which the card's own controller would have
    held to <= 1."""
    base = ibm_module.AdaptiveStepper
    enorms = []

    class Replay(base):
        def step(self, t, y, aux, t_max=np.inf):
            k = len(enorms)
            res = self.attempt(t, dts[k], y, aux)
            enorms.append(float(res.enorm))
            self.dt = next_dts[k]
            return t + dts[k], res.y, res.aux

    ibm_module.AdaptiveStepper = Replay
    try:
        yield enorms
    finally:
        ibm_module.AdaptiveStepper = base


def ibm_schedule(ref):
    """(dts, next_dts) of a reference history from start time 0: the dt of
    each accepted step (between its accepted times: a rejected attempt
    shortens it) and the controller's dt after it."""
    times = [0.0] + list(ref["times"])
    return [b - a for a, b in zip(times, times[1:])], list(ref["dt"])


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


def parity_cases(tmp):
    """(label, config, Problem options, stepper tolerance) of the GPU-vs-CPU
    parity cases (the gmsh cases' meshes written into `tmp`). The stepper's
    tolerance is one at which every accepted step's size factor is clipped
    at 10 (dt 1e-3, 1e-2, 1e-1): a factor the error norm sets moves with
    the CG solves' last bits (at 1e-8 the 3D Taylor-Green case's third dt
    differs by ~1e-5 between the kernel and the plain version), and so
    would the end time. The direct case (4^2 ngl=3 cavity-2d) runs no
    kernel: the GPU side is cuSOLVER's factor and the global layout's torch
    ops; its solves agree to round-off, so its error norms do too, but at
    1e-8 the third dt still follows their last bits (t_end moved 7e-9),
    hence 1e-4. GMRES(30) runs at rtol 1e-10 with 1000 Arnoldi steps at
    most (its first free-slip solve has b = 0 from a nonzero start, the lid
    being tangential, where the reference's GMRES iterates to maxiter and
    CG returns x = 0), and its depth is cut to 1 accepted step: restarted
    GMRES takes ~15x CG's iterations on this cavity, and 3 steps took 75 s
    of GPU and CPU. The two gmsh cases (distorted quads and hexes, engine
    with the sumfact K and the gather DSS) run the Taylor-Green case files'
    physics on meshes cut to 4^2 and 3^3 elements. The two IBM cases
    (tests/test_ibm.py's cylinder, 8^2 ngl=3) take the IBM loop and its
    global rhs: the static body on the direct solve, the moving one on the
    engine's CG through Problem's device shuttles. The accepted steps each
    case must take are its config's max-steps."""
    opts = dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000)
    cavity = cavity_config((3, 3, 3), 3, 1.0, 0.02, [1.0, 0, 0], 3, 1.0)
    cavity2 = cavity_config((4, 4), 3, 0.5, 0.01, [2, 0], 3, 2.0)
    cavity_1 = cavity_config((3, 3, 3), 3, 1.0, 0.02, [1.0, 0, 0], 1, 1.0)
    return [
        ("cavity3d 3^3 ngl=3", cavity, opts, 1e-8),
        ("taylor-green3d 3^3 ngl=3", tg3d_config((3, 3, 3), 3, 3), opts,
         1e-4),
        # from t = 0.1: the flat plate's tau is 0 at t = 0
        ("flat-plate-FSNS 4^2 ngl=3 t0=0.1",
         fsns_config((4, 4), 3, 0.1, 3), opts, 1e-4),
        ("cavity3d 3^3 ngl=3 pc=fdm", cavity, dict(opts, pc="fdm"), 1e-8),
        ("cavity-2d 4^2 ngl=3 direct", cavity2, dict(solver="direct"), 1e-4),
        ("cavity3d 3^3 ngl=3 gmres, 1 step", cavity_1,
         dict(solver="gmres", cg_rtol=1e-10, cg_maxiter=1000), 1e-4),
        ("gmsh quads 4^2 distorted ngl=4 taylor-green, sumfact",
         gmsh_tg_config(write_quad_msh(os.path.join(tmp, "quad.msh"), 4, 4,
                                       MESH_DISTORT), "taylor_green", 4, 3),
         opts, 1e-4),
        ("gmsh hexes 3^3 distorted ngl=3 taylor-green3d, sumfact",
         gmsh_tg_config(write_hex_msh(os.path.join(tmp, "hex.msh"), 3, 3, 3,
                                      MESH_DISTORT), "taylor_green3d", 3, 3),
         opts, 1e-4),
        ("ibm static cylinder 8^2 ngl=3 direct",
         ibm_cylinder_config((8, 8), "static", 3), dict(solver="direct"),
         1e-4),
        ("ibm moving cylinder 8^2 ngl=3 cg",
         ibm_cylinder_config((8, 8), "dynamic", 3), opts, 1e-4),
    ]


def _parity_case(torch, dev, label, cfg, opts, tol):
    """One GPU-vs-CPU parity case (see parity_cases): one rhs and the
    transient in f64 on each device, checked and printed."""
    from pynama_tpu_torch.engine.local_engine import rhs_local
    from pynama_tpu_torch.run_case import make_problem

    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        p = make_problem(cfg, device=device, dtype=torch.float64, **opts)
        p.setUp()
        rng = np.random.default_rng(0)
        vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
        ops = p.engine_ops
        if ops is None or "bodies" in cfg:
            # the global layout (direct solve; the IBM cases' rhs)
            f, _ = p.rhs(p.start_time, vort, p.vel * 0.0)
        else:
            vel = torch.zeros(
                (p.mesh.n_cells, p.mesh.nnode_el * p.dim),
                dtype=torch.float64, device=device)
            f, _ = rhs_local(ops, p.start_time, p.to_local(vort), vel)
        t_end, steps = p.start_solver(atol=tol, rtol=tol, dt0=1e-3)
        out[name] = dict(f=f.cpu().numpy(), vort=p.vort.cpu().numpy(),
                         vel=p.vel.cpu().numpy(), t=t_end, steps=steps,
                         solver=p.solver_method,
                         pc=None if ops is None else ops.pc,
                         krylov=None if ops is None else ops.krylov,
                         sumfact=None if ops is None
                         else ops.sumfact is not None)
    rel = {k: float(np.abs(out["gpu"][k] - out["cpu"][k]).max()
                    / np.abs(out["cpu"][k]).max())
           for k in ("f", "vort", "vel")}
    emit("parity", case=label, rel_err=rel, limit=PARITY_LIMIT,
         stepper_tol=tol, solver=out["gpu"]["solver"],
         krylov=out["gpu"]["krylov"],
         pc=out["gpu"]["pc"], steps_gpu=out["gpu"]["steps"],
         steps_cpu=out["cpu"]["steps"], t_gpu=out["gpu"]["t"],
         t_cpu=out["cpu"]["t"])
    direct = opts["solver"] == "direct"
    want = dict(solver=opts["solver"],
                pc=None if direct else opts.get("pc", "jacobi"),
                krylov=None if direct else opts["solver"])
    if "gmsh-file" in cfg["domain"]:
        want["sumfact"] = True
    for k, v in want.items():
        check(out["gpu"][k] == out["cpu"][k] == v,
              f"parity {label}: {k} {out['gpu'][k]}, want {v}")
    want_steps = cfg["time-solver"]["max-steps"]
    check(out["gpu"]["steps"] == out["cpu"]["steps"] == want_steps,
          f"parity {label}: accepted steps gpu {out['gpu']['steps']} "
          f"cpu {out['cpu']['steps']} (want {want_steps})")
    check(all(v <= PARITY_LIMIT for v in rel.values()),
          f"parity {label}: GPU vs CPU relative error {rel} > "
          f"{PARITY_LIMIT}")
    return rel


def phase_parity(torch, dev):
    tmp = tempfile.mkdtemp(prefix="parity-")
    try:
        for case in parity_cases(tmp):
            _parity_case(torch, dev, *case)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_main(torch, dev):
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops import cg_epilogue as E
    from pynama_tpu_torch.ops.fused import fused_apply

    # bench.py's flagship: 3D no-slip lid-driven cavity, 24^3 ngl=4, f32
    cfg = cavity_config((24, 24, 24), 4, 0.5, 0.01, [2, 0, 0], 2, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = 0
    _epilogue_zero()
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
         expected_launches=expected, epilogue_launches={
             k: getattr(E, k).launches for k in EPILOGUE_STEPS},
         peak_mem_bytes=peak, kinetic_energy=ke, finite=finite)
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
    _epilogue_check("main", sum(applies), eager_pc=False)
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
            _epilogue_zero()
            vel = solve()
            launches = fused_apply.launches
            epi = _epilogue_check(f"fdm_{dname}_{pc}",
                                  sum(n for _, n in stats), pc == "fdm")
            # per stage: Rw, apply_K(vc) and the A0 residual; the curl
            # between the stages; plus every CG-loop application
            expected = 4 * len(stats) - 1 + sum(n for _, n in stats)
            row = dict(setup_s=setup_s, setup_phases_s=p.setup_phases,
                       iters_fs_main=[int(it) for it, _ in stats],
                       loop_applies=[n for _, n in stats],
                       fused_apply_launches=launches,
                       expected_launches=expected, epilogue_launches=epi)
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


def _direct_setup_s(p):
    """Problem p's setup phases with the direct systems' host assembly and
    device factor seconds apart (main, then the free-slip stage)."""
    out = dict(p.setup_phases)
    for name, sys in (("main", p.kle.main), ("fs", p.kle.fs)):
        for k, v in (sys.setup_s if sys is not None else {}).items():
            out[f"kle_{name}_{k}"] = v
    return out


def phase_global_direct(torch, dev):
    """The cavity-2d case file through the global layout with no solver
    option ("auto" resolves its 20,402 velocity dofs to the direct solve):
    setUp and 3 accepted steps through start_solver -> Problem.rhs, f32;
    then, in f64 from the state those steps reached, one Problem.rhs of the
    direct solve against rhs_local of the engine's CG (K1, rtol 1e-12)."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.engine.local_engine import rhs_local
    from pynama_tpu_torch.ops.fused import fused_apply

    cfg = cavity2d_config(3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = 0
    p = Problem(cfg, device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated(dev)
    check(p.solver_method == "direct" and p.engine_ops is None,
          f"global_direct: solver {p.solver_method}, engine built "
          f"{p.engine_ops is not None}; want direct and no engine")
    factors = [s.chol for s in (p.kle.main, p.kle.fs) if s is not None]
    check(len(factors) == 2 and all(f.dtype == torch.float32
                                    for f in factors),
          "global_direct: want two float32 factors (no-slip: two stages)")
    snaps = []

    def post(step, t, dt, vort, vel):
        snaps.append((step, t, dt, vort.clone(), vel.clone()))

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    t_end, steps = p.start_solver(post_step=post, dt0=1e-3)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_apply.launches
    peak_run = torch.cuda.max_memory_allocated(dev)
    diags = [dict(step=st, t=t, dt=dt, **p.diagnostics(vel=vel, vort=vort))
             for st, t, dt, vort, vel in snaps]
    # one warm rhs of the path (4 triangular solves), CUDA events
    rhs_ms = _median_ms(torch, lambda: p.rhs(t_end, p.vort, p.vel), reps=3,
                        warmup=1)
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all()) and all(
        np.isfinite(d[k]) for d in diags
        for k in ("kinetic_energy", "enstrophy", "div_l2"))
    row = dict(config="cavity-2d.yaml 50^2 ngl=3 f32, no solver option, "
               "depth cut to 3 accepted steps",
               n_nodes=p.mesh.n_nodes, velocity_dofs=p.mesh.n_nodes * p.dim,
               solver_method=p.solver_method, setup_s=setup_s,
               setup_phases_s=_direct_setup_s(p),
               factor_bytes=sum(f.numel() * f.element_size()
                                for f in factors),
               peak_mem_setup_bytes=peak_setup, accepted_steps=steps,
               t_end=t_end, run_s=run_s, s_per_step=run_s / max(steps, 1),
               rhs_ms=rhs_ms, peak_mem_run_bytes=peak_run,
               fused_apply_launches=launches, diagnostics=diags,
               finite=finite)
    vort64, vel64 = p.vort.double(), p.vel.double()
    del p, snaps, factors
    torch.cuda.empty_cache()
    check(steps == 3, f"global_direct: accepted {steps} steps, want 3")
    check(finite, "global_direct: non-finite fields or diagnostics")
    check(launches == 0, f"global_direct: the direct path launched K1 "
          f"{launches} times, want 0")

    # f64, from that state: the direct solve against the engine's CG
    torch.cuda.reset_peak_memory_stats(dev)
    pd = Problem(cfg, device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    pd.setUp()
    torch.cuda.synchronize()
    row["f64_setup_s"] = time.perf_counter() - t0
    row["f64_setup_phases_s"] = _direct_setup_s(pd)
    row["f64_peak_mem_setup_bytes"] = torch.cuda.max_memory_allocated(dev)
    f_d = pd.rhs(t_end, vort64, vel64)[0].cpu().numpy()
    del pd
    torch.cuda.empty_cache()
    pc = Problem(cfg, device=dev, dtype=torch.float64, solver="cg",
                 cg_rtol=1e-12, cg_maxiter=20000)
    pc.setUp()
    stats = []
    fused_apply.launches = 0
    f_l, _ = rhs_local(pc.engine_ops, t_end, pc.to_local(vort64),
                       pc.to_local(vel64), stats)
    torch.cuda.synchronize()
    k1 = fused_apply.launches
    # Rw, apply_K(vc) and the A0 residual per stage (2 stages), the curl
    # between them, then srt, div_srt, curl -> 10; plus the CG loops'
    k1_expected = 10 + sum(n for _, n in stats)
    f_c = pc.to_global(f_l, pc.dim_w)
    rel = float(np.abs(f_d - f_c).max() / np.abs(f_c).max())
    del pc
    torch.cuda.empty_cache()
    row.update(rhs_f64_rel_diff=rel, limit=DIRECT_RHS_LIMIT,
               cg_iters_fs_main=[int(it) for it, _ in stats],
               cg_k1_launches=k1, cg_k1_expected=k1_expected)
    emit("global_direct", **row)
    check(rel <= DIRECT_RHS_LIMIT, f"global_direct: f64 rhs, direct vs the "
          f"engine's CG, relative {rel:.3e} > {DIRECT_RHS_LIMIT}")
    check(k1 > 0 and k1 == k1_expected, f"global_direct: K1 launched {k1} "
          f"times in the CG rhs, the path made {k1_expected} applications")
    return k1


def phase_global_ops(torch, dev):
    """The taylor-green3d case file (25^3 ngl=3, f64): the global Operators
    (apply_op) against the engine's curl/srt/div_srt (K1) on the analytic
    velocity at t = 0; operators_errors(1.0) and diagnostics() at t = 0,
    the diagnostics against the JAX package's."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.engine import local_engine as LE
    from pynama_tpu_torch.ops.fused import fused_apply

    cfg = tg3d_config((25, 25, 25), 3, 3)
    p = Problem(cfg, device=dev, dtype=torch.float64, solver="cg")
    p.setUp()
    ops, op = p.engine_ops, p.operator
    v = p.vel
    s = op.srt(v)
    cases = (("curl", op.curl, LE.curl, v, p.dim_w),
             ("srt", op.srt, LE.srt, v, p.dim_s),
             ("div_srt", op.div_srt, LE.div_srt, s, p.dim))
    rel, ms = {}, {}
    fused_apply.launches = 0
    for name, glob, eng, x, c in cases:
        want = p.to_global(eng(ops, p.to_local(x)), c)
        got = glob(x).cpu().numpy()
        rel[name] = float(np.abs(got - want).max() / np.abs(want).max())
    torch.cuda.synchronize()
    k1 = fused_apply.launches
    for name, glob, eng, x, c in cases:
        xl = p.to_local(x)
        ms[name] = {"global_apply_op": _median_ms(torch, lambda: glob(x)),
                    "engine_k1": _median_ms(torch, lambda: eng(ops, xl))}
    t0 = time.perf_counter()
    oerr = p.operators_errors(1.0)
    diag = p.diagnostics()
    sweep_s = time.perf_counter() - t0
    diag_rel = {k: abs(diag[k] - TG3D_DIAG_REF[k]) / abs(TG3D_DIAG_REF[k])
                for k in diag}
    emit("global_ops", config="taylor-green3d.yaml 25^3 ngl=3 f64, t=0",
         n_nodes=p.mesh.n_nodes, rel_err=rel, limit=OPS_LIMIT,
         k1_launches=k1, k1_expected=3, ms=ms,
         operators_errors=list(oerr), jax_operators_errors=list(
             TG3D_OPS_ERR_REF), diagnostics=diag,
         jax_diagnostics=TG3D_DIAG_REF, diagnostics_rel_diff=diag_rel,
         diagnostics_limit=DIAG_LIMIT, sweeps_s=sweep_s)
    check(all(e <= OPS_LIMIT for e in rel.values()),
          f"global_ops: Operators vs the engine {rel} > {OPS_LIMIT}")
    check(k1 == 3, f"global_ops: K1 launched {k1} times, want 3")
    check(all(np.isfinite(e) for e in oerr), f"global_ops: errors {oerr}")
    check(all(e <= DIAG_LIMIT for e in diag_rel.values()),
          f"global_ops: diagnostics {diag} vs the JAX package's "
          f"{TG3D_DIAG_REF}: {diag_rel} > {DIAG_LIMIT}")
    return k1


def phase_gmres(torch, dev):
    """The taylor-green3d case file (25^3 ngl=3, f64, rtol 1e-10):
    kle_errors([0.5, 1.0]) with the engine's CG and with its GMRES (Jacobi),
    then kle_errors([0.5]) with GMRES under pc="fdm"; K1's launches in each
    against the applications the solvers report."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops.fused import fused_apply

    cfg = tg3d_config((25, 25, 25), 3, 3)
    taus = {"cg": [0.5, 1.0], "gmres": [0.5, 1.0], "gmres_fdm": [0.5]}
    out, launches = {}, 0
    for name, opts in (("cg", dict(solver="cg")),
                       ("gmres", dict(solver="gmres")),
                       ("gmres_fdm", dict(solver="gmres", pc="fdm"))):
        p = Problem(cfg, device=dev, dtype=torch.float64, cg_rtol=1e-10,
                    cg_maxiter=20000, **opts)
        p.setUp()
        check(p.engine_ops.krylov == opts["solver"] and p.engine_ops.pc ==
              opts.get("pc", "jacobi"), f"gmres: {name} built "
              f"{p.engine_ops.krylov}/{p.engine_ops.pc}")
        p.cg_log = []
        torch.cuda.synchronize()
        fused_apply.launches = 0
        t0 = time.perf_counter()
        errs = p.kle_errors(taus[name])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1 = fused_apply.launches
        iters = [int(it) for it, _ in p.cg_log]
        applies = [n for _, n in p.cg_log]
        # per solve (free-slip sides only): Rw and apply_K(vc) for b, plus
        # what the solver reports: CG its loop applies and its A0 residual,
        # GMRES every application (residuals included)
        fixed = 3 if name == "cg" else 2
        expected = fixed * len(iters) + sum(applies)
        norms = [float(torch.linalg.norm(p.exact_fields(
            t**2 / (4 * p.nu))[0])) for t in taus[name]]
        out[name] = dict(errors=errs, exact_vel_norms=norms, iters=iters,
                         applies=applies, k1_launches=k1,
                         k1_expected=expected, seconds=secs,
                         ms_per_solve=1e3 * secs / len(iters),
                         us_per_iter=1e6 * secs / max(sum(iters), 1))
        if name != "cg":
            launches += k1
        check(len(iters) == len(taus[name]) and k1 == expected,
              f"gmres {name}: K1 launched {k1} times, the solves made "
              f"{expected} applications")
        del p
        torch.cuda.empty_cache()
    norms = out["cg"]["exact_vel_norms"]
    scale = [max(norms[: i + 1][-2:]) for i in range(len(norms))]
    for name in ("gmres", "gmres_fdm"):
        diff = [abs(a - b) / n for a, b, n in zip(
            out[name]["errors"], out["cg"]["errors"], scale)]
        out[name]["err_diff_over_scale"] = diff
        out[name]["err_rel_diff"] = [abs(a - b) / abs(b) for a, b in zip(
            out[name]["errors"], out["cg"]["errors"])]
    emit("gmres", config="taylor-green3d.yaml 25^3 ngl=3 f64, rtol 1e-10, "
         "kle_errors", limit=KLE_AGREE_LIMIT, **out)
    for name in ("gmres", "gmres_fdm"):
        check(all(d <= KLE_AGREE_LIMIT for d in out[name][
            "err_diff_over_scale"]), f"gmres {name}: KLE errors "
              f"{out[name]['errors']} vs CG's {out['cg']['errors']}")
    return launches


def _importable(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


@contextlib.contextmanager
def _cli_probe(torch, run_case):
    """Instrument the run_case calls made inside: every Problem that
    run_case.make_problem builds records its CG solves (cg_log), the
    fields and time its production run starts from and the seconds the
    run takes (synchronized); every BinarySnapshotWriter records the fields
    handed to it (references; the writer copies them). Yields the list of
    writers."""
    from pynama_tpu_torch.io import binary

    writers = []
    make_problem, writer_cls = run_case.make_problem, \
        binary.BinarySnapshotWriter

    class Recorder(writer_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.saved = []
            # run() closes the writer at its end, and is_async then reads
            # False: keep what it read while open
            self.async_at_open = self.is_async
            writers.append(self)

        def save(self, step, t, **fields):
            self.saved.append((step, t, fields))
            super().save(step, t, **fields)

    def probed(cfg, **kw):
        p = make_problem(cfg, **kw)
        p.cg_log = []
        run = p.run

        def timed_run(*a, **k):
            p.run_start = (p.start_time, p.vort.clone(), p.vel.clone())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(*a, **k)
            torch.cuda.synchronize()
            p.run_s = time.perf_counter() - t0
            return out

        p.run = timed_run
        return p

    run_case.make_problem, binary.BinarySnapshotWriter = probed, Recorder
    try:
        yield writers
    finally:
        run_case.make_problem = make_problem
        binary.BinarySnapshotWriter = writer_cls


def _cli_production(run_case, argv, hdf5):
    """run_case's production run of argv: through main() where h5py can
    write the viewer's HDF5/XDMF; without h5py, the steps main takes with
    -fast-io and no viewer (Problem.run(fast_io=True) with viewer None, the
    JAX package's own path): returns (problem, t, steps)."""
    if hdf5:
        return run_case.main(argv)
    args = run_case.build_parser().parse_args(argv + ["-fast-io"])
    p = run_case._set_up(run_case.load_case(args.case), args)
    t, steps = p.run(fast_io=True, dt0=args.dt0)
    return p, t, steps


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _snapshot(hdf5, save_dir, step, name):
    """Field `name` of snapshot `step` as run_case wrote it: the viewer's
    HDF5 (flat) or the fast-io binary file."""
    if hdf5:
        import h5py
        with h5py.File(os.path.join(save_dir,
                                    f"vec-data-{step:05d}.h5")) as f:
            return f[f"/fields/{name}"][()]
    from pynama_tpu_torch.io.binary import load_snapshot
    return load_snapshot(save_dir + "-fast", step, name)


def phase_cli(torch, dev):
    """The port's CLI (pynama_tpu_torch.run_case) on the card, in process:
    (a) cavity.yaml at its own size, cut to CLI_STEPS accepted steps,
    through run_case against Problem.setUp(); start_solver() on the same
    config; (b) the same run under -fast-io; (c) -checkpoint then -resume
    (h5py only); (d) taylor-green3d.yaml -test kle at 25^3 ngl=3 against the
    JAX package's error; (e) -trace around a 1-step cavity run. Each run in
    a directory of its own, K1's launches counted from 0 around each."""
    from pynama_tpu_torch import run_case
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.cases.problem import host_array
    from pynama_tpu_torch.ops.fused import fused_apply
    from pynama_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    from pynama_tpu_torch import native

    check(_importable("yaml"), "cli: PyYAML is missing (case files)")
    hdf5 = _importable("h5py")
    row = dict(io_route="hdf5" if hdf5 else "binary", config_route="yaml")
    # the async writer's g++ build, once per checkout, outside the timed
    # runs (inside them it reads as ~0.5 s per step of a 3-step run)
    t0 = time.perf_counter()
    row["native_available"] = native.available()
    row["native_build_s"] = time.perf_counter() - t0
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="cli-")
    t_phase = time.perf_counter()
    try:
        # the case file cut to CLI_STEPS steps (JSON is YAML); dt0 stays the
        # uncut file's default, (end - start) / (10 max-steps)
        cfg = run_case.load_case("cavity")
        ts = cfg["time-solver"]
        dt0 = (ts["end-time"] - ts.get("start-time", 0)) / (
            10 * ts["max-steps"])
        case = {}
        for steps in (CLI_STEPS, 1):
            c = json.loads(json.dumps(cfg))
            c["time-solver"]["max-steps"] = steps
            case[steps] = os.path.join(tmp, f"cavity-{steps}.yaml")
            with open(case[steps], "w") as f:
                json.dump(c, f)
        flags = ["-log", "WARNING", "-device", "cuda", "-dtype", "float32",
                 "-cg-rtol", "1e-6", "-maxiter", "1000", "-dt0", str(dt0)]
        argv = ["-case", case[CLI_STEPS]] + flags

        def rundir(name):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            os.chdir(d)
            return d

        # the same config through Problem directly, no writer: once before
        # the runs through run_case and once after them, so that a drift
        # of the host over the phase shows beside the writer's cost
        c3 = run_case.load_case(case[CLI_STEPS])

        def direct_run():
            torch.cuda.synchronize()
            fused_apply.launches = 0
            t0 = time.perf_counter()
            p0 = Problem(c3, device=dev, dtype=torch.float32, cg_rtol=1e-6,
                         cg_maxiter=1000)
            p0.setUp()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            p0.cg_log = []
            t0 = time.perf_counter()
            t_ref, steps_ref = p0.start_solver(dt0=dt0)
            torch.cuda.synchronize()
            return p0, dict(setup_s=setup_s, run_s=time.perf_counter() - t0,
                            t=t_ref, steps=steps_ref,
                            launches=fused_apply.launches,
                            iters=[int(it) for it, _ in p0.cg_log])

        rundir("direct")
        p0, direct = direct_run()
        t_ref, steps_ref, ref_iters = direct["t"], direct["steps"], \
            direct["iters"]
        ref = (p0.vort.cpu().numpy(), p0.vel.cpu().numpy())
        yl, vl = p0.to_local(p0.vort), p0.to_local(p0.vel)
        del p0

        # (a) and (b): run_case's production run, with a writer attached
        runs = {}
        for name, extra in (("a", ["-checkpoint", "ck.h5"] if hdf5 else []),
                            ("b", ["-fast-io"])):
            if name == "b" and not hdf5:
                break             # (a) already ran with -fast-io
            d = rundir(name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fused_apply.launches = 0
            t0 = time.perf_counter()
            with _cli_probe(torch, run_case) as writers:
                p, t_end, steps = _cli_production(run_case, argv + extra,
                                                  hdf5)
            torch.cuda.synchronize()
            runs[name] = dict(p=p, t=t_end, steps=steps, dir=d,
                              wall=time.perf_counter() - t0,
                              launches=fused_apply.launches,
                              peak=torch.cuda.max_memory_allocated(dev),
                              writers=writers)
        rundir("direct-after")
        p0, direct_after = direct_run()
        del p0
        run_direct = 0.5 * (direct["run_s"] + direct_after["run_s"])
        ra = runs["a"]
        p = ra["p"]
        iters = [int(it) for it, _ in p.cg_log]
        applies = [n for _, n in p.cg_log]
        # per rhs_local of the no-slip case: 10 applications outside CG
        expected = 10 * (len(p.cg_log) // 2) + sum(applies)
        vort, vel = p.vort.cpu().numpy(), p.vel.cpu().numpy()
        save_dir = os.path.join(ra["dir"], cfg["save-dir"])
        snap = _snapshot(hdf5, save_dir, ra["steps"], "vorticity")
        row["a"] = dict(
            config="cavity.yaml 30x10x10 ngl=3 f32 (auto -> cg), "
            f"-cg-rtol 1e-6 -maxiter 1000 -dt0 {dt0}, depth cut to "
            f"{CLI_STEPS} steps", velocity_dofs=p.mesh.n_nodes * p.dim,
            solver=p.solver_method, fused=p.engine_ops.fused,
            setup_phases_s=p.setup_phases,
            setup_s_direct=[direct["setup_s"], direct_after["setup_s"]],
            accepted_steps=ra["steps"], t_end=ra["t"], t_end_direct=t_ref,
            wall_s=ra["wall"],
            run_s_with_writer=p.run_s,
            run_s_without=[direct["run_s"], direct_after["run_s"]],
            s_per_step_with_writer=p.run_s / max(ra["steps"], 1),
            s_per_step_without=run_direct / max(steps_ref, 1),
            save_cost_s_per_step_diff=(p.run_s - run_direct)
            / max(ra["steps"], 1),
            cg_iters=iters, cg_iters_direct=ref_iters,
            k1_launches=ra["launches"], k1_expected=expected,
            k1_launches_direct=[direct["launches"], direct_after["launches"]],
            peak_mem_bytes=ra["peak"],
            vort_rel_diff=_rel(vort, ref[0]), vel_rel_diff=_rel(vel, ref[1]),
            files=sorted(os.listdir(save_dir + ("" if hdf5 else "-fast"))))

        # the per-step save alone: to_global of both fields, then the write
        # (the fast-io writer's save, or the viewer's HDF5 save_data)
        os.chdir(ra["dir"])           # the viewer's save-dir is relative
        def timed(fn, reps=3):
            out = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                out.append(time.perf_counter() - t0)
            return float(np.median(out))

        to_global = timed(lambda: (host_array(p.to_global(yl, p.dim_w)),
                                   host_array(p.to_global(vl, p.dim))))
        w, u = host_array(p.to_global(yl, p.dim_w)), host_array(
            p.to_global(vl, p.dim))
        from pynama_tpu_torch.io.binary import BinarySnapshotWriter
        bw = BinarySnapshotWriter(os.path.join(tmp, "save-alone"))
        row["save_alone_s"] = dict(
            to_global=to_global,
            binary_submit=timed(lambda: bw.save(0, 0.0, vorticity=w,
                                                velocity=u)),
            binary_submit_and_flush=timed(lambda: (
                bw.save(0, 0.0, vorticity=w, velocity=u), bw.flush())))
        bw.close()
        if hdf5:
            row["save_alone_s"]["hdf5_save_data"] = timed(
                lambda: p.viewer.save_data(0, 0.0, vorticity=w, velocity=u))
        emit("cli", **row)
        check(ra["steps"] == CLI_STEPS == steps_ref,
              f"cli (a): accepted {ra['steps']} / {steps_ref} steps, want "
              f"{CLI_STEPS}")
        check(p.solver_method == "cg" and p.engine_ops.fused,
              "cli (a): want the engine's CG through K1")
        check(ra["launches"] > 0 and ra["launches"] == expected,
              f"cli (a): K1 launched {ra['launches']} times, the run made "
              f"{expected} operator applications")
        check(iters == ref_iters == direct_after["iters"], "cli (a): CG "
              "iterations differ from the direct runs'")
        check(max(row["a"]["vort_rel_diff"], row["a"]["vel_rel_diff"])
              <= CLI_FIELD_LIMIT, "cli (a): fields differ from the direct "
              f"run's by {row['a']['vort_rel_diff']:.3e} / "
              f"{row['a']['vel_rel_diff']:.3e}")
        check(np.array_equal(snap.ravel(), vort.ravel()),
              "cli (a): the last snapshot's vorticity is not the final "
              "p.vort")
        if hdf5:
            check(os.path.exists(os.path.join(save_dir, "mesh.h5"))
                  and os.path.exists(os.path.join(
                      save_dir, f"{cfg['name']}.xmf")),
                  "cli (a): mesh.h5 or the .xmf index is missing")

        # (b) the fast-io run (on the binary route: (a) itself)
        rb = runs["b" if hdf5 else "a"]
        wr = rb["writers"]
        check(len(wr) == 1 and wr[0].async_at_open,
              "cli (b): the fast-io writer is not the native async one")
        fast = os.path.join(rb["dir"], cfg["save-dir"] + "-fast")
        from pynama_tpu_torch.io.binary import load_snapshot
        for step, _, fields in wr[0].saved:
            for name, arr in fields.items():
                check(np.array_equal(load_snapshot(fast, step, name), arr),
                      f"cli (b): snapshot {step} {name} read back differs")
        rp = rb["p"]
        row_b = dict(run=("b" if hdf5 else "a"),
                     is_async=wr[0].async_at_open,
                     snapshots=len(wr[0].saved), accepted_steps=rb["steps"],
                     s_per_step=rp.run_s / max(rb["steps"], 1),
                     save_cost_s_per_step_diff=(rp.run_s - run_direct)
                     / max(rb["steps"], 1), k1_launches=rb["launches"])
        check(len(wr[0].saved) == rb["steps"] == CLI_STEPS,
              f"cli (b): {len(wr[0].saved)} snapshots for {rb['steps']} "
              "steps")

        # (c) -checkpoint (written by (a)) then -resume, one more step
        row_c = "not run: h5py is missing on this machine"
        if hdf5:
            rundir("c")
            ck = os.path.join(runs["a"]["dir"], "ck.h5")
            with open(case[1]) as f:
                c1 = json.load(f)
            c1["time-solver"]["end-time"] = runs["a"]["t"] + 1.0
            path = os.path.join(tmp, "cavity-resume.yaml")
            with open(path, "w") as f:
                json.dump(c1, f)
            with _cli_probe(torch, run_case):
                pr, t_r, steps_r = run_case.main(
                    ["-case", path, "-resume", ck] + flags)
            t_ck, w0, v0 = pr.run_start
            check(t_ck == runs["a"]["t"] and steps_r == 1,
                  f"cli (c): resumed at t={t_ck}, {steps_r} steps")
            check(torch.equal(w0.cpu(), torch.as_tensor(vort))
                  and torch.equal(v0.cpu(), torch.as_tensor(vel)),
                  "cli (c): the resumed fields are not the checkpoint's")
            row_c = dict(start_t=t_ck, steps=steps_r, t_end=t_r)

        # (d) taylor-green3d -test kle at its own size
        rundir("d")
        kle_argv = ["-case", "taylor-green3d", "-test", "kle", "-log",
                    "WARNING", "-device", "cuda", "-dtype", "float32",
                    "-cg-rtol", "1e-6", "-maxiter", "1000"]
        torch.cuda.synchronize()
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with _cli_probe(torch, run_case):
            if hdf5:
                pk, fields = run_case.main(kle_argv)
            else:
                args = run_case.build_parser().parse_args(kle_argv)
                pk = run_case._set_up(run_case.load_case(args.case), args)
                fields = run_case.kle_test_fields(pk)
        torch.cuda.synchronize()
        kle_s = time.perf_counter() - t0
        k1_kle = fused_apply.launches
        kle_expected = 3 * len(pk.cg_log) + sum(n for _, n in pk.cg_log)
        err = float(np.linalg.norm(fields["error"]))
        row_d = dict(config="taylor-green3d.yaml 25^3 ngl=3 f32 (auto -> "
                     "cg), -cg-rtol 1e-6 -maxiter 1000",
                     velocity_dofs=pk.mesh.n_nodes * pk.dim,
                     solver=pk.solver_method, setup_phases_s=pk.setup_phases,
                     seconds=kle_s, kle_error=err, jax_ref=KLE_REF_ERR,
                     rel_diff=abs(err - KLE_REF_ERR) / KLE_REF_ERR,
                     limit=KLE_ERR_LIMIT,
                     cg_iters=[int(it) for it, _ in pk.cg_log],
                     k1_launches=k1_kle, k1_expected=kle_expected)
        del pk, fields

        # (e) -trace around a 1-step cavity run, on a 3x1x1 mesh of the
        # case's box under CG (at this size "auto" would take the direct
        # solve): the trace records every host op and kernel (~120 events
        # per CG iteration), and the full mesh's step would write ~1 GB
        d = rundir("e")
        trace_dir = os.path.join(d, "trace")
        tr_argv = ["-case", case[1], "-nelem", "3", "1", "1", "-solver",
                   "cg"] + flags
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with _cli_probe(torch, run_case):
            if hdf5:
                run_case.main(tr_argv + ["-trace", trace_dir])
            else:
                with device_trace(trace_dir):
                    _cli_production(run_case, tr_argv, hdf5)
        trace_s = time.perf_counter() - t0
        path = os.path.join(trace_dir, TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        k1_records = sum(1 for e in events if e.get("cat") == "kernel" and (
            "gemm_kernel" in e.get("name", "")
            or "dss_kernel" in e.get("name", "")))
        row_e = dict(config="cavity.yaml, -nelem 3 1 1 -solver cg, 1 step",
                     phase_seconds=time.perf_counter() - t_phase,
                     seconds=trace_s, trace_bytes=os.path.getsize(path),
                     events=len(events), k1_kernel_records=k1_records,
                     k1_launches=fused_apply.launches)
        emit("cli_more", b=row_b, c=row_c, d=row_d, e=row_e)
        check(k1_kle > 0 and k1_kle == kle_expected,
              f"cli (d): K1 launched {k1_kle} times, the solve made "
              f"{kle_expected} applications")
        check(row_d["rel_diff"] <= KLE_ERR_LIMIT, f"cli (d): KLE |error| "
              f"{err:.6e} vs the JAX package's {KLE_REF_ERR:.6e}")
        check(k1_records >= 1, "cli (e): the trace holds no K1 kernel")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"cli": runs["a"]["launches"], "cli_kle": k1_kle}


def _sumfact_cost(sf, E):
    """(operations, bytes) of one apply_sumfact_k: the four flat matmuls and
    the three dim x dim geometry contractions; the element vector read
    once and written once, every SumFactK tensor read once."""
    dim, nn = sf.dim, sf.ngl ** sf.dim
    nq = sf.nqf + sf.nqr
    flops = 2 * (2 * E * dim * nn * dim * nq) + 2 * dim * dim * E * dim * (
        sf.nqf + 2 * sf.nqr)
    tensors = (sf.Gt, sf.Jrt, sf.wr, sf.Df_flat, sf.Dr_flat, sf.v2cm,
               sf.cm2v)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + 2 * E * dim * nn * sf.Gt.element_size()
    return flops, nbytes


def _distorted_elements(rng, dim, n):
    """(n, 2**dim, dim) corners of n unit elements (the mesh's corner
    order), each corner moved by uniform(-0.15, 0.15) per axis."""
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float) if dim == 2 \
        else np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    return unit[None] + rng.uniform(-0.15, 0.15, (n,) + unit.shape)


def _sumfact_kernel(torch, dev):
    """(g): csrc/sumfact_apply.cu against apply_sumfact_k_ref, the first
    launch synchronized: every instantiated (dim, ngl) at SUMFACT_SMALL_E
    distorted elements, then exp/sumfact_roofline.py's hexes at
    SUMFACT_TIMED, each with the kernel's and the plain chain's device µs
    (calls rotating among SUMFACT_RING copies) beside the bound
    (_sumfact_cost, benchmark/counts_hex.py's count); f32 and f64."""
    import dataclasses
    import itertools
    from pynama_tpu_torch.basis import make_tensor_basis
    from pynama_tpu_torch.exp import sumfact_roofline as R
    from pynama_tpu_torch.ops import sumfact as S

    kinds = ((torch.float32, F32_LIMIT), (torch.float64, SUMFACT_F64_LIMIT))
    rng = np.random.default_rng(7)
    small, first = [], True
    for dim in S.KERNEL_DIMS:
        for ngl in S.KERNEL_NGL:
            corners = _distorted_elements(rng, dim, SUMFACT_SMALL_E)
            t64 = rng.standard_normal((SUMFACT_SMALL_E, dim * ngl ** dim))
            for dtype, limit in kinds:
                sf = S.build_sumfact(make_tensor_basis(ngl, dim), corners,
                                     device=dev, dtype=dtype)
                t = torch.as_tensor(t64, dtype=dtype, device=dev)
                y = S.apply_sumfact_k(sf, t)
                if first:
                    torch.cuda.synchronize()
                    first = False
                small.append(dict(
                    dim=dim, ngl=ngl, dtype=str(dtype)[6:], limit=limit,
                    rel=_rel(y.cpu().numpy(),
                             S.apply_sumfact_k_ref(sf, t).cpu().numpy())))
    timed = []
    for e1d, ngl in SUMFACT_TIMED:
        for dtype, limit in kinds:
            sf, t = R.inputs(e1d, ngl, dev, dtype)
            E = t.shape[0]
            ring = [(sf, t)] + [(dataclasses.replace(
                sf, Gt=sf.Gt.clone(), Jrt=sf.Jrt.clone(), wr=sf.wr.clone()),
                t.clone()) for _ in range(SUMFACT_RING - 1)]
            rel = _rel(S.apply_sumfact_k(sf, t).cpu().numpy(),
                       S.apply_sumfact_k_ref(sf, t).cpu().numpy())
            nxt = itertools.cycle(ring).__next__
            us, _ = _device_us(torch, lambda: S.apply_sumfact_k(*nxt()))
            plain_us, plain = _device_us(
                torch, lambda: S.apply_sumfact_k_ref(*nxt()))
            flops, nbytes = _sumfact_cost(sf, E)
            bound = _bound(flops, PEAK_FLOPS[str(dtype)[6:]], nbytes)
            timed.append(dict(
                mesh=f"{e1d}^3 ngl={ngl}", E=E, dtype=str(dtype)[6:],
                rel=rel, limit=limit, device_us=us,
                bound_us=bound[0] * 1e3, bound_by=bound[1],
                roofline_pct=100 * bound[0] * 1e3 / us,
                plain_device_us=plain_us, plain_kernels=len(plain)))
            del ring, sf, t
    torch.cuda.empty_cache()
    return small, timed


def _index_bytes(lay):
    """Bytes of the gather DSS's two index tables."""
    return (lay.incidence.numel() * lay.incidence.element_size()
            + lay.cell_nodes.numel() * lay.cell_nodes.element_size())


def _f32_bound(flops, nbytes):
    return _bound(flops, PEAK_FLOPS["float32"], nbytes)


def _apply_row(torch, fn, bound, cell_nodes):
    """Device µs per call (profiler, every kernel fn launches), the kernels
    and launches per call, the CUDA-event wall ms per call and the bound
    (bound_ms, bound_by); and fn's output (three components per node) with
    its duplicate-slot spread."""
    y = fn()
    torch.cuda.synchronize()
    per, counts = _profile(torch, fn)
    return y, dict(device_us=sum(per.values()), kernels=len(per),
                   launches_per_call=sum(counts.values()),
                   wall_ms=_median_ms(torch, fn), bound_us=bound[0] * 1e3,
                   bound_by=bound[1],
                   dup_spread=_dup_spread(torch, y, cell_nodes, 3),
                   top_kernels=sorted(per.items(),
                                      key=lambda kv: -kv[1])[:6])


def _unstructured_hex_apply(torch, dev, path):
    """(a): bench.py's hex config through Problem with sumfact on and off;
    each route's apply_K, and the gather DSS alone."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.engine.local_engine import apply_K
    from pynama_tpu_torch.ops import local as L
    from pynama_tpu_torch.ops.sumfact import apply_sumfact_k

    rows, ys = {}, {}
    for name, sf in (("sumfact", True), ("dense", False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p = Problem(hex_uniform_config(path), device=dev,
                    dtype=torch.float32, solver="cg", cg_rtol=1e-6,
                    cg_maxiter=500, sumfact=sf)
        p.setUp()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ops, mesh = p.engine_ops, p.mesh
        check((ops.sumfact is not None) == sf and not ops.lay_v.structured,
              f"unstructured (a) {name}: sumfact {ops.sumfact is not None}")
        check(sf == (ops.KT.numel() == 0),
              f"unstructured (a) {name}: KT has {ops.KT.numel()} elements")
        v = p.to_local(np.random.default_rng(1).standard_normal(
            (mesh.n_nodes, 3)))
        # apply_K = the gather DSS of the element product: its bytes are
        # v, the product's operands (KT, or the SumFactK tensors), y and
        # the DSS's index tables
        E, nnc = mesh.n_cells, mesh.nnode_el * 3
        if sf:
            flops, nbytes = _sumfact_cost(ops.sumfact, E)
        else:
            flops = 2 * E * nnc * nnc
            nbytes = (ops.KT.numel() + 2 * E * nnc) * 4
        ys[name], row = _apply_row(
            torch, lambda: apply_K(ops, v),
            _f32_bound(flops, nbytes + _index_bytes(ops.lay_v)),
            mesh.cell_nodes)
        row.update(setup_s=setup_s, setup_phases_s=p.setup_phases,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   kt_numel=ops.KT.numel())
        if sf:
            z = apply_sumfact_k(ops.sumfact, v)
            _, dss = _apply_row(
                torch, lambda: L.dss(ops.lay_v, z),
                _f32_bound(mesh.n_nodes * ops.lay_v.incidence.shape[1] * 3,
                           2 * E * nnc * 4 + _index_bytes(ops.lay_v)),
                mesh.cell_nodes)
            row["gather_dss"] = dss
            row["gather_dss_share"] = dss["device_us"] / row["device_us"]
        rows[name] = row
        del p, ops
    rel = _rel(ys["sumfact"].cpu().numpy(), ys["dense"].cpu().numpy())
    return rows, rel, mesh


def _unstructured_transient(torch, dev, cfg, ref_err, **opts):
    """setUp and UNSTRUCT_STEPS accepted steps of cfg in f32, with K1's and
    its DSS pass's launches counted from 0; the fields after each step."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.cases.problem import host_array
    from pynama_tpu_torch.ops.fused import dss_pass, fused_apply

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = dss_pass.launches = 0
    p = Problem(cfg, device=dev, dtype=torch.float32, **opts)
    t0 = time.perf_counter()
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p.cg_log = []
    snaps = []

    def post(step, t, dt, vort, vel):
        snaps.append((step, t, np.array(host_array(vort)),
                      np.array(host_array(vel))))

    t0 = time.perf_counter()
    t_end, steps = p.start_solver(post_step=post, dt0=1e-3, atol=1e-4,
                                  rtol=1e-4)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    w_exact = p.exact_fields(t_end)[1].double()
    err = float((p.vort.double() - w_exact).abs().max()
                / w_exact.abs().max())
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all())
    row = dict(n_nodes=p.mesh.n_nodes, velocity_dofs=p.mesh.n_nodes * p.dim,
               solver=p.solver_method, setup_s=setup_s,
               setup_phases_s=_direct_setup_s(p) if p.engine_ops is None
               else p.setup_phases, accepted_steps=steps, t_end=t_end,
               run_s=run_s, s_per_step=run_s / max(steps, 1),
               rhs_evals=len(p.cg_log) if p.engine_ops is not None else None,
               cg_iters=[int(it) for it, _ in p.cg_log],
               k1_launches=fused_apply.launches,
               dss_pass_launches=dss_pass.launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               vort_rel_max_err=err, jax_ref_err=ref_err,
               err_limit=2 * ref_err, finite=finite)
    return p, row, snaps


def phase_unstructured(torch, dev, flagship, t_flagship):
    """gmsh meshes through the port's entry points on the card: (g) first,
    the sumfact kernel against its plain version; (a) bench.py's hex K
    apply, sumfact against dense; (b) the 3D Taylor-Green
    transient on those hexes; (c) 50^2 distorted quads under "auto" (the
    direct solve); (d) sumfact=True on the flagship box mesh against K1;
    (f) a gmsh case file through run_case. Returns K1's launches in (a)-(c)
    and (f) and in (d)'s rhs, and the DSS pass's in (d)'s rhs."""
    from pynama_tpu_torch import run_case
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.cases.problem import host_array
    from pynama_tpu_torch.engine.local_engine import apply_K, rhs_local
    from pynama_tpu_torch.ops.fused import dss_pass, fused_apply
    from pynama_tpu_torch.ops.sumfact import apply_sumfact_k

    from pynama_tpu_torch.utils.profiling import tracing

    t_phase = time.perf_counter()
    # (g) the sumfact kernel against its plain version
    small, timed = _sumfact_kernel(torch, dev)
    emit("unstructured_sumfact_kernel", small=small, timed=timed)
    for r in small + timed:
        check(r["rel"] <= r["limit"], f"unstructured (g): sumfact kernel "
              f"vs plain {r} relative {r['rel']:.3e} > {r['limit']}")
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="unstructured-")
    k1_unstructured = 0
    try:
        # (a) the hex K apply, sumfact and dense
        hex_path = write_hex_msh(os.path.join(tmp, "hex.msh"), HEX_N, HEX_N,
                                 HEX_N, MESH_DISTORT)
        fused_apply.launches = 0
        rows, rel, mesh = _unstructured_hex_apply(torch, dev, hex_path)
        k1_unstructured += fused_apply.launches
        emit("unstructured_apply", config=f"bench.py hex: {HEX_N}^3 hexes "
             f"distorted {MESH_DISTORT}, ngl=4, f32", n_nodes=mesh.n_nodes,
             velocity_dofs=mesh.n_nodes * 3, rel_diff=rel, limit=F32_LIMIT,
             k1_launches=fused_apply.launches, **rows)
        check(rel <= F32_LIMIT, f"unstructured (a): sumfact vs dense apply_K "
              f"relative {rel:.3e} > {F32_LIMIT}")
        for name, row in rows.items():
            check(row["dup_spread"] == 0.0, f"unstructured (a) {name}: "
                  f"duplicate slots differ by {row['dup_spread']}")
        check(rows["sumfact"]["gather_dss"]["dup_spread"] == 0.0,
              "unstructured (a): the gather DSS left duplicates unequal")
        check(fused_apply.launches == 0, "unstructured (a): K1 launched")

        # (b) the 3D Taylor-Green transient on the hexes, the program's
        # spans on: one sumfact launch per apply_k.element span
        launches0 = apply_sumfact_k.launches
        trace = tracing()
        try:
            p, row, _ = _unstructured_transient(
                torch, dev, gmsh_tg_config(hex_path, "taylor_green3d", 4,
                                           UNSTRUCT_STEPS), HEX_TG3D_REF_ERR,
                solver="cg", cg_rtol=1e-6, cg_maxiter=1000)
        finally:
            trace.stop()
        k1_unstructured += row["k1_launches"]
        ops = p.engine_ops
        row.update(sumfact=ops.sumfact is not None, func_sides=len(
            ops.func_sides), jax_ref_t_end=HEX_TG3D_REF_T,
            sumfact_launches=apply_sumfact_k.launches - launches0,
            apply_k_spans=trace.names.count("apply_k.element"))
        del p, ops
        emit("unstructured_hex_tg3d", config=f"taylor_green3d on the "
             f"{HEX_N}^3 hexes, ngl=4 f32 cg_rtol=1e-6", **row)
        check(row["accepted_steps"] == UNSTRUCT_STEPS and row["finite"],
              f"unstructured (b): {row['accepted_steps']} steps, finite "
              f"{row['finite']}")
        check(row["solver"] == "cg" and row["sumfact"],
              "unstructured (b): want the engine's CG with sumfact K")
        check(row["k1_launches"] == 0 and row["dss_pass_launches"] == 0,
              "unstructured (b): K1 or its DSS pass launched")
        check(row["sumfact_launches"] == row["apply_k_spans"] > 0,
              f"unstructured (b): {row['sumfact_launches']} sumfact "
              f"launches, {row['apply_k_spans']} apply_k.element spans")
        check(row["vort_rel_max_err"] <= row["err_limit"],
              f"unstructured (b): vorticity error "
              f"{row['vort_rel_max_err']:.3e} > {row['err_limit']:.3e}")

        # (c) 50^2 distorted quads, "auto" -> the direct solve
        quad_path = write_quad_msh(os.path.join(tmp, "quad.msh"), QUAD_N,
                                   QUAD_N, MESH_DISTORT)
        qcfg = gmsh_tg_config(quad_path, "taylor_green", 3, UNSTRUCT_STEPS)
        p, row, snaps = _unstructured_transient(torch, dev, qcfg,
                                                QUAD_TG_REF_ERR)
        k1_unstructured += row["k1_launches"]
        row.update(engine=p.engine_ops is not None,
                   jax_ref_t_end=QUAD_TG_REF_T)
        del p
        emit("unstructured_quad_direct", config=f"taylor_green on "
             f"{QUAD_N}^2 quads distorted {MESH_DISTORT}, ngl=3 f32, no "
             "solver option", **row)
        check(row["solver"] == "direct" and not row["engine"],
              f"unstructured (c): solver {row['solver']}, want direct and "
              "no engine")
        check(row["accepted_steps"] == UNSTRUCT_STEPS and row["finite"],
              f"unstructured (c): {row['accepted_steps']} steps")
        check(row["k1_launches"] == 0, "unstructured (c): K1 launched")
        check(row["vort_rel_max_err"] <= row["err_limit"],
              f"unstructured (c): vorticity error "
              f"{row['vort_rel_max_err']:.3e} > {row['err_limit']:.3e}")

        # (f) the quads' case file through run_case, 2 steps, against (c)
        step, t_ref, vort_ref, vel_ref = snaps[UNSTRUCT_CLI_STEPS - 1]
        case = json.loads(json.dumps(qcfg))
        case["time-solver"]["max-steps"] = UNSTRUCT_CLI_STEPS
        case["save-dir"] = "gmsh-out"
        case_path = os.path.join(tmp, "gmsh-case.yaml")
        with open(case_path, "w") as f:
            json.dump(case, f)
        hdf5 = _importable("h5py")
        os.chdir(tmp)
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with _cli_probe(torch, run_case):
            pc, t_cli, steps_cli = _cli_production(
                run_case, ["-case", case_path, "-log", "WARNING", "-device",
                           "cuda", "-dtype", "float32", "-dt0", "1e-3"],
                hdf5)
        torch.cuda.synchronize()
        k1_unstructured += fused_apply.launches
        row_f = dict(io_route="hdf5" if hdf5 else "binary",
                     solver=pc.solver_method, seconds=time.perf_counter()
                     - t0, accepted_steps=steps_cli, t_end=t_cli,
                     t_problem=t_ref, k1_launches=fused_apply.launches,
                     vort_rel_diff=_rel(host_array(pc.vort), vort_ref),
                     vel_rel_diff=_rel(host_array(pc.vel), vel_ref),
                     limit=CLI_FIELD_LIMIT)
        del pc
        emit("unstructured_cli", config="the (c) case file with max-steps "
             f"{UNSTRUCT_CLI_STEPS} through run_case", **row_f)
        check(steps_cli == step == UNSTRUCT_CLI_STEPS and t_cli == t_ref,
              f"unstructured (f): {steps_cli} steps to t={t_cli}, Problem "
              f"{step} to t={t_ref}")
        check(max(row_f["vort_rel_diff"], row_f["vel_rel_diff"])
              <= CLI_FIELD_LIMIT, "unstructured (f): run_case's fields "
              f"differ from Problem's by {row_f['vort_rel_diff']:.3e} / "
              f"{row_f['vel_rel_diff']:.3e}")
        check(fused_apply.launches == 0, "unstructured (f): K1 launched")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) sumfact=True on the flagship box mesh, against K1's apply_K
    cfg = cavity_config((24, 24, 24), 4, 0.5, 0.01, [2, 0, 0], 2, 1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ps = Problem(cfg, device=dev, dtype=torch.float32, solver="cg",
                 cg_rtol=1e-6, cg_maxiter=1000, sumfact=True)
    ps.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ops_s, ops_k = ps.engine_ops, flagship.engine_ops
    check(ops_s.sumfact is not None and ops_s.KT.numel() == 0
          and ops_s.fused and ops_s.lay_v.structured,
          "unstructured (d): sumfact=True did not reach the box engine")
    E = ps.mesh.n_cells
    v = ps.to_local(np.random.default_rng(2).standard_normal(
        (ps.mesh.n_nodes, 3)))
    z = apply_sumfact_k(ops_s.sumfact, v)
    bound = _f32_bound(*_sumfact_cost(ops_s.sumfact, E))
    cn = ps.mesh.cell_nodes
    y_s, row_s = _apply_row(torch, lambda: apply_K(ops_s, v), bound, cn)
    _, row_p = _apply_row(torch, lambda: apply_sumfact_k(ops_s.sumfact, v),
                          bound, cn)
    _, row_d = _apply_row(torch, lambda: dss_pass(
        z, ops_s.nelem, ops_s.ngl, 3)[0], _f32_bound(0, 2 * z.nbytes), cn)
    y_k, row_k = _apply_row(torch, lambda: apply_K(ops_k, v),
                            _gemm_bound(E, 192, 192, "float32"), cn)
    rel = _rel(y_s.cpu().numpy(), y_k.cpu().numpy())
    # one rhs_local of the flagship's state after phase_main's steps
    vort_l, vel_l = ps.to_local(flagship.vort), ps.to_local(flagship.vel)
    stats = []
    torch.cuda.synchronize()
    fused_apply.launches = dss_pass.launches = 0
    t0 = time.perf_counter()
    rhs_local(ops_s, t_flagship, vort_l, vel_l, stats)
    torch.cuda.synchronize()
    rhs_s = time.perf_counter() - t0
    k1_box, dss_box = fused_apply.launches, dss_pass.launches
    applies = sum(n for _, n in stats)
    # K1: Rw per stage, the curl between the stages, srt, div_srt, curl;
    # the DSS pass: apply_K(vc) and the A0 residual per stage, and every
    # application of the CG loops
    row = dict(config="cavity3d 24^3 ngl=4 f32 cg_rtol=1e-6, sumfact=True",
               setup_s=setup_s, setup_phases_s=ps.setup_phases,
               rel_diff=rel, limit=F32_LIMIT, sumfact_apply_K=row_s,
               sumfact_product=row_p, dss_pass=row_d, k1_apply_K=row_k,
               rhs_s=rhs_s, cg_iters_fs_main=[int(it) for it, _ in stats],
               cg_loop_applies=applies, k1_launches=k1_box,
               k1_expected=6, dss_pass_launches=dss_box,
               dss_pass_expected=4 + applies,
               phase_seconds=time.perf_counter() - t_phase)
    del ps, ops_s, z
    torch.cuda.empty_cache()
    emit("unstructured_box_sumfact", **row)
    check(rel <= F32_LIMIT, f"unstructured (d): sumfact + DSS pass vs K1 "
          f"relative {rel:.3e} > {F32_LIMIT}")
    check(row_s["dup_spread"] == 0.0, "unstructured (d): duplicates differ")
    check(k1_box == 6 and dss_box == 4 + applies and applies > 0,
          f"unstructured (d): K1 {k1_box} launches (want 6), DSS pass "
          f"{dss_box} (want {4 + applies})")
    return {"unstructured": k1_unstructured, "box_sumfact": k1_box}, \
        {"box_sumfact": dss_box}



def force_gaps(a, b):
    """max|a_k - b_k| of each force history k over the scale of b's force
    it belongs to: max(|cd|, |cl|) for cd and cl, max(|cd_phys|,
    |cl_phys|) for the other two (the static cylinder's cl is round-off of
    a symmetric flow, and a gap relative to it alone would read its
    noise)."""
    out = {}
    for pair in (("cd", "cl"), ("cd_phys", "cl_phys")):
        scale = max(np.abs(np.asarray(b[k], dtype=np.float64)).max()
                    for k in pair)
        for k in pair:
            out[k] = float(np.abs(np.asarray(a[k], dtype=np.float64)
                                  - np.asarray(b[k], dtype=np.float64)).max()
                           / scale)
    return out


def _flat(history):
    """A force history as floats (cd and cl hold one list per body)."""
    return [float(np.ravel(v)[0]) for v in history]


def _memcpy_record(torch, fn):
    """The host<->device copies fn makes, from a torch.profiler trace
    (CUDA activity) exported as Chrome JSON: [(name, bytes), ...]."""
    act = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[act]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    cps = [e for e in events if e.get("cat") == "gpu_memcpy"]
    check(all("bytes" in e.get("args", {}) for e in cps),
          f"memcpy trace events without a byte count: {cps[:2]}")
    return [(e["name"], int(e["args"]["bytes"])) for e in cps]


def _ibm_run(torch, dev, run_case, name, dt0, part):
    """One IBM case file at its own mesh in f32 (CG rtol 1e-6 where "auto"
    takes CG), replaying IBM_REF's steps: setup, the run, the correction's
    device time, the body residual, the forces against the JAX package's,
    K1's launches against the engine's applications, and one traced RK
    stage's copies, printed as phase ibm_<part> before the gates. Returns
    (row, problem)."""
    from pynama_tpu_torch.cases import ibm as tibm
    from pynama_tpu_torch.ibm import interpolation as I
    from pynama_tpu_torch.ops.fused import fused_apply

    ref = IBM_REF[name]
    cfg = ibm_config(run_case, name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_apply.launches = 0
    p = run_case.make_problem(cfg, device=dev, dtype=torch.float32,
                              cg_rtol=1e-6, cg_maxiter=1000)
    t0 = time.perf_counter()
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated(dev)
    cond = float(np.linalg.cond(p.core.double().cpu().numpy()))
    p.cg_log = []
    stages, corr_calls = [], []
    rhs, per_step = p.rhs, p._per_step_correction
    p.rhs = lambda t, y, aux: stages.append(t) or rhs(t, y, aux)

    def probed(vel, t):
        corr_calls.append((vel, t, getattr(p, "_flux", None)))
        return per_step(vel, t)

    p._per_step_correction = probed
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with ibm_replay(tibm, *ibm_schedule(ref)) as enorms:
        t_end, steps = p.start_solver(dt0=dt0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k1 = fused_apply.launches
    peak_run = torch.cuda.max_memory_allocated(dev)
    ops = p.engine_ops
    # per solve_kle on the engine: Rw, apply_K(vc) and the A0 residual per
    # stage, the curl between the stages, plus the CG loops' applications
    n_solves = len(p.cg_log)
    cg_iters = [int(it) for it, _ in p.cg_log]
    ns = ops is not None and ops.is_ns
    k1_expected = 0 if ops is None else (
        3 * n_solves + (n_solves // 2 if ns else 0)
        + sum(n for _, n in p.cg_log))
    corr_log = list(getattr(p, "corr_log", []))
    xy = getattr(p, "_xy", None)
    nodes, w = (p.nodes_tab, p.w_tab) if xy is None \
        else I.support_tables(p.ibm_ops, xy)
    body_res = float((I.interp_H(p.ibm_ops, nodes, w, p.vel)
                      - p._field(p.body.velocities())).abs().max())
    hist = {k: _flat(p.history[k]) for k in ("cd", "cl", "cd_phys",
                                              "cl_phys")}
    gaps = force_gaps(hist, ref)
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all())
    # the correction of the last step again, from the same inputs (the
    # moving body's CG from the same warm start): device µs per step
    vel_c, t_c, flux0 = corr_calls[-1]

    def corr():
        if flux0 is not None:
            p._flux = flux0
        per_step(vel_c, t_c)

    corr_us, corr_kernels = _device_us(torch, corr, calls=5)
    if flux0 is not None:
        p._flux = flux0
    corr_ms = _median_ms(torch, corr, reps=5, warmup=1)
    # one RK stage (Problem.rhs) traced: its host<->device copies
    vort_s, vel_s = p.vort.clone(), p.vel.clone()
    copies = {}
    for cname, nbytes in _memcpy_record(
            torch, lambda: rhs(t_end, vort_s, vel_s)):
        n, most = copies.get(cname, (0, 0))
        copies[cname] = (n + 1, max(most, nbytes))
    host_copy = max([b for k, (_, b) in copies.items()
                     if "HtoD" in k or "DtoH" in k], default=0)
    field_bytes = p.mesh.n_nodes * min(p.dim, p.dim_w) * 4
    row = dict(
        case=f"{name}.yaml {'x'.join(map(str, p.mesh.nelem))} ngl={p.ngl} "
        f"f32, {IBM_STEPS} steps replayed from tools/ibm_reference.py",
        n_nodes=p.mesh.n_nodes, velocity_dofs=p.mesh.n_nodes * p.dim,
        lag_points=p.body.n_nodes, solver=p.solver_method,
        core_route="eq-tensor" if p.nodes_tab.shape[0] ** 2
        * p.nodes_tab.shape[1] ** 2 <= 2 ** 27 else "spgemm",
        core_cond_f64=cond, setup_s=setup_s,
        setup_phases_s=_direct_setup_s(p) if p.engine_ops is None
        else p.setup_phases,
        ibm_setup_s={k: v for k, v in p.setup_phases.items()
                     if k.startswith("ibm_")},
        peak_mem_setup_bytes=peak_setup, accepted_steps=steps,
        attempts=len(enorms), card_enorms=enorms, t_end=t_end,
        ref_t_end=ref["times"][-1], run_s=run_s,
        s_per_step=run_s / max(steps, 1), rhs_evals=len(stages),
        cg_iters=cg_iters,
        cg_loop_applies=sum(n for _, n in p.cg_log[:n_solves]),
        corr_cg=[it for it, _ in corr_log],
        corr_cg_relres=[rr for _, rr in corr_log],
        corr_device_us=corr_us, corr_ms=corr_ms,
        corr_kernels=len(corr_kernels),
        body_res=body_res, ref_body_res=ref["body_res"],
        body_res_limit=IBM_BODY_RES_LIMIT, forces=hist,
        force_gaps=gaps, force_limit=IBM_FORCE_LIMIT,
        stage_memcpys={k: {"count": n, "max_bytes": b}
                       for k, (n, b) in copies.items()},
        stage_host_copy_max_bytes=host_copy, field_bytes=field_bytes,
        k1_launches=k1, k1_expected=k1_expected,
        peak_mem_run_bytes=peak_run, finite=finite)
    emit(f"ibm_{part}", **row)
    check(finite, f"ibm {name}: non-finite fields")
    check(steps == IBM_STEPS and abs(t_end - ref["times"][-1]) <= 1e-12,
          f"ibm {name}: {steps} steps to t={t_end}, want {IBM_STEPS} to "
          f"{ref['times'][-1]}")
    check(body_res <= IBM_BODY_RES_LIMIT, f"ibm {name}: max|H v - v_body| "
          f"{body_res:.3e} > {IBM_BODY_RES_LIMIT}")
    check(all(g <= IBM_FORCE_LIMIT for g in gaps.values()),
          f"ibm {name}: forces vs the JAX package's {gaps} > "
          f"{IBM_FORCE_LIMIT}")
    check(k1 == k1_expected, f"ibm {name}: K1 launched {k1} times, the "
          f"engine made {k1_expected} applications")
    check(host_copy < field_bytes, f"ibm {name}: an RK stage copied "
          f"{host_copy} bytes between host and device (a field is "
          f"{field_bytes}): {copies}")
    return row, p


def phase_ibm(torch, dev):
    """The three IBM case files at their own meshes through Problem (a)-(c);
    (d) ibm-dynamic.yaml through run_case against (b); (e) spread_S twice
    on (b)'s last tables, bitwise. Returns K1's launches by path."""
    from pynama_tpu_torch import run_case
    from pynama_tpu_torch.cases import ibm as tibm
    from pynama_tpu_torch.ibm import interpolation as I
    from pynama_tpu_torch.ops.fused import fused_apply

    t_phase = time.perf_counter()
    k1, probs = {}, {}
    for (name, dt0), part in zip(IBM_CASES, "abc"):
        row, p = _ibm_run(torch, dev, run_case, name, dt0, part)
        k1[name.replace("-", "_")] = row["k1_launches"]
        if name == "ibm-dynamic":
            probs[name] = (p, row)
        del p
    check(k1["ibm_static"] == 0, f"ibm (a): the direct path launched K1 "
          f"{k1['ibm_static']} times")
    pb, row_b = probs.pop("ibm-dynamic")

    # (d) the same case file through run_case, cut to IBM_STEPS steps in a
    # JSON copy (the file's save-n-steps, 100: no snapshot due)
    hdf5 = _importable("h5py")
    tmp = tempfile.mkdtemp(prefix="ibm-cli-")
    try:
        cfg = run_case.load_case("ibm-dynamic")
        cfg["time-solver"]["max-steps"] = IBM_STEPS
        cfg["save-dir"] = os.path.join(tmp, "out")
        path = os.path.join(tmp, "ibm-dynamic-cut.yaml")
        with open(path, "w") as f:
            json.dump(cfg, f)
        argv = ["-case", path, "-device", "cuda", "-dtype", "float32",
                "-cg-rtol", "1e-6", "-maxiter", "1000", "-dt0",
                repr(dict(IBM_CASES)["ibm-dynamic"]), "-log", "WARNING"]
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with _cli_probe(torch, run_case), ibm_replay(
                tibm, *ibm_schedule(IBM_REF["ibm-dynamic"])):
            pd, t_d, steps_d = _cli_production(run_case, argv, hdf5)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        k1_cli = fused_apply.launches
        n = len(pd.cg_log)
        k1_cli_expected = 3 * n + (n // 2 if pd.engine_ops.is_ns else 0) \
            + sum(a for _, a in pd.cg_log)
        rel = {k: _rel(getattr(pd, k).cpu().numpy(),
                       getattr(pb, k).cpu().numpy()) for k in ("vort", "vel")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("ibm_d", case="ibm-dynamic.yaml through run_case -device cuda, "
         f"max-steps {IBM_STEPS}", route="hdf5" if hdf5 else "binary",
         problem=type(pd).__name__, accepted_steps=steps_d, t_end=t_d,
         t_b=row_b["t_end"], seconds=cli_s, rel_vs_b=rel,
         limit=CLI_FIELD_LIMIT, k1_launches=k1_cli,
         k1_expected=k1_cli_expected)
    check(type(pd).__name__ == "ImmersedBoundaryDynamic",
          f"ibm (d): run_case built {type(pd).__name__}")
    check(steps_d == IBM_STEPS and t_d == row_b["t_end"],
          f"ibm (d): {steps_d} steps to {t_d}, (b) {row_b['t_end']}")
    check(all(v <= CLI_FIELD_LIMIT for v in rel.values()),
          f"ibm (d): fields vs (b) {rel} > {CLI_FIELD_LIMIT}")
    check(k1_cli == k1_cli_expected, f"ibm (d): K1 launched {k1_cli} "
          f"times, the engine made {k1_cli_expected} applications")
    k1["ibm_cli"] = k1_cli
    del pd

    # (e) spread_S twice on (b)'s last tables
    nodes, w = I.support_tables(pb.ibm_ops, pb._xy)
    flux = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (pb.body.n_nodes, pb.dim)), dtype=torch.float32, device=dev)
    s1 = I.spread_S(pb.ibm_ops, nodes, w, flux, pb.mesh.n_nodes)
    s2 = I.spread_S(pb.ibm_ops, nodes, w, flux, pb.mesh.n_nodes)
    plan = I.spread_plan(nodes)
    bitwise = bool(torch.equal(s1, s2))
    emit("ibm_e", case="spread_S twice on (b)'s last tables",
         bitwise=bitwise, touched_nodes=int(plan.uniq.numel()),
         max_fanin=int(plan.slots.shape[1]),
         spread_device_us=_device_us(torch, lambda: I.spread_S(
             pb.ibm_ops, nodes, w, flux, pb.mesh.n_nodes, plan))[0],
         phase_s=time.perf_counter() - t_phase)
    check(bitwise, "ibm (e): two spread_S calls differ")
    return k1

def _k1_expected(stats, is_ns, accepts=0, fused=True, pc="jacobi"):
    """K1's launches on one rank, from its CG log: per masked solve Rw,
    apply_K(vc) and the A0 residual (3) plus its loop applications; per
    KLE solve of a no-slip problem the curl between the stages; per rhs
    srt, div_srt and curl (3); per IBM accept (`accepts`) the curl after
    the correction (1); under pc="schwarz" one preconditioner application
    per loop application and one before the loop (CG's z0, GMRES's
    M_inv(b)). 0 on the plain route (fused=False)."""
    if not fused:
        return 0
    n = len(stats["cg_iters"])
    n_kle = n // 2 if is_ns else n
    loops = sum(stats["cg_applies"])
    schwarz = n + loops if pc == "schwarz" else 0
    return (3 * n + (n_kle if is_ns else 0) + 3 * (n_kle - accepts)
            + accepts + loops + schwarz)


def _cg_stats(cg_log):
    """A Problem's cg_log as _k1_expected's stats."""
    return {"cg_iters": [int(it) for it, _ in cg_log],
            "cg_applies": [n for _, n in cg_log]}


def _epilogue_zero():
    """Set the CG epilogue's launch counters to 0."""
    from pynama_tpu_torch.ops import cg_epilogue as E
    for k in EPILOGUE_STEPS:
        getattr(E, k).launches = 0


def _epilogue_check(path, applies, eager_pc):
    """The CG epilogue's launches since _epilogue_zero, checked against a
    run's CG-loop applications: cg_pap, cg_xr and cg_p once per
    application, cg_rz as often where the preconditioner is an eager call
    (FDM, Schwarz), else never. Kept in EPILOGUE_BY_PATH[path]; returned."""
    from pynama_tpu_torch.ops import cg_epilogue as E
    got = {k: getattr(E, k).launches for k in EPILOGUE_STEPS}
    want = {"cg_pap": applies, "cg_xr": applies,
            "cg_rz": applies if eager_pc else 0, "cg_p": applies}
    check(applies > 0 and got == want, f"{path}: CG epilogue launches "
          f"{got}, the run made {applies} CG-loop applications: want {want}")
    EPILOGUE_BY_PATH[path] = got
    return got


def _rank_rows(stats, expected):
    """Per-rank record of a sharded run, K1 against `expected`(stats)."""
    return [{"rank": s["rank"], "backend": s["backend"],
             "accepted": len(s["accepted"]), "solves": len(s["cg_iters"]),
             "cg_iters": sum(s["cg_iters"]), "k1_launches": s["k1_launches"],
             "k1_expected": expected(s), "staged_bytes": s["staged_bytes"],
             "peak_mem_bytes": s["peak_mem_bytes"]} for s in stats]


def _check_ranks(label, rows, stats):
    check(len(rows) == SHARDED_NDEV, f"sharded {label}: {len(rows)} ranks")
    check(all(r["backend"] == "gloo staged through host" for r in rows),
          f"sharded {label}: backend {[r['backend'] for r in rows]}")
    check(all(s["cg_iters"] == stats[0]["cg_iters"]
              and s["accepted"] == stats[0]["accepted"] for s in stats),
          f"sharded {label}: the ranks left lockstep")
    check(all(r["k1_launches"] == r["k1_expected"] for r in rows),
          f"sharded {label}: K1 launches {[r['k1_launches'] for r in rows]}"
          f", the ranks made {[r['k1_expected'] for r in rows]} "
          "applications")


def phase_sharded(torch, dev, flagship, t_flagship):
    """(a) f64 parity of 2 ranks on the card (gloo staged through host
    buffers) against one device on the card; (b) the flagship split into
    2 slabs, 1 step from phase 5's state; (c) each rank's K1 launches
    against its applications. Returns K1's launches by path, summed over
    the ranks.

    Two ranks share the one card by time-slicing it, and every staged
    collective waits for its rank's queue: a sharded CG iteration took ~8
    ms on an H100 80GB HBM3 at 700 W against ~0.5 ms on one device, so
    the cases are sized by their CG iterations: the cavity 2x2x2 at CG
    rtol 1e-10 (3 steps, ~4,800 iterations; 1 step under FDM), the
    overlapped DSS one rhs, the cylinder at rtol 1e-10 (~2,000)."""
    from pynama_tpu_torch.engine.local_engine import rhs_local
    from pynama_tpu_torch.parallel.sharded_engine import (
        job_rhs, job_rhs_overlap_pair, run_sharded)
    from pynama_tpu_torch.run_case import make_problem

    t_phase = time.perf_counter()
    k1 = {}
    opts = dict(solver="cg", cg_rtol=1e-10, cg_maxiter=4000)
    cavity = cavity_config((2, 2, 2), 3, 1.0, 0.02, [1.0, 0, 0], 3, 1.0)
    cases = [
        ("cavity", "cavity3d 2^3 ngl=3", cavity, opts),
        ("fdm", "cavity3d 2^3 ngl=3 pc=fdm, 1 step",
         dict(cavity, **{"time-solver": dict(cavity["time-solver"],
                                             **{"max-steps": 1})}),
         dict(opts, pc="fdm")),
        ("ibm_dynamic", "moving cylinder 8^2 ngl=3, _start_solver_sharded_ibm",
         ibm_cylinder_config((8, 8), "dynamic", 3), opts)]
    for key, label, cfg, o in cases:
        out = {}
        for ndev in (1, SHARDED_NDEV):
            p = make_problem(cfg, device=dev, dtype=torch.float64,
                             ndev=ndev, **o)
            p.setUp()
            t0 = time.perf_counter()
            t_end, steps = p.start_solver(atol=1e-4, rtol=1e-4, dt0=1e-3)
            torch.cuda.synchronize()
            out[ndev] = dict(vort=p.vort.cpu().numpy(),
                             vel=p.vel.cpu().numpy(), t=t_end, steps=steps,
                             seconds=time.perf_counter() - t0,
                             stats=getattr(p, "rank_stats", None),
                             cd=list(getattr(p, "history", {}).get("cd",
                                                                   [])))
            is_ns = p.engine_ops.is_ns
            del p
        ref, two = out[1], out[SHARDED_NDEV]
        stats = two["stats"]
        ibm = "bodies" in cfg
        rows = _rank_rows(stats, lambda s: _k1_expected(
            s, is_ns, len(s["accepted"]) + 1 if ibm else 0))
        rel = {k: _rel(two[k], ref[k]) for k in ("vort", "vel")}
        extra = {"cd_rel": _rel(np.asarray(two["cd"]), np.asarray(ref["cd"]))
                 } if ibm else {}
        emit("sharded_a", case=label, ndev=SHARDED_NDEV, rel_err=rel,
             limit=PARITY_LIMIT, steps=[ref["steps"], two["steps"]],
             t=[ref["t"], two["t"]],
             seconds=[ref["seconds"], two["seconds"]], ranks=rows, **extra)
        check(two["steps"] == ref["steps"] == cfg["time-solver"][
            "max-steps"] and two["t"] == ref["t"],
            f"sharded {label}: steps/t {two['steps']} {two['t']}, "
            f"one device {ref['steps']} {ref['t']}")
        check(all(v <= PARITY_LIMIT for v in rel.values()),
              f"sharded {label}: {rel} > {PARITY_LIMIT}")
        check(not ibm or extra["cd_rel"] <= PARITY_LIMIT,
              f"sharded {label}: cd {extra.get('cd_rel')}")
        _check_ranks(label, rows, stats)
        k1[f"sharded_{key}"] = sum(r["k1_launches"] for r in rows)

    # the overlapped DSS (plain route): one rhs with overlap_dss off and
    # on, against one device's K1 rhs
    p = make_problem(cavity, device=dev, dtype=torch.float64, fused=False,
                     **opts)
    p.setUp()
    rng = np.random.default_rng(7)
    vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
    vel = np.zeros((p.mesh.n_nodes, p.dim))
    ref = make_problem(cavity, device=dev, dtype=torch.float64, **opts)
    ref.setUp()
    f_ref, _ = rhs_local(ref.engine_ops, 0.1, ref.to_local(vort),
                         ref.to_local(vel))
    f_ref = ref.to_global(f_ref, ref.dim_w)
    res = run_sharded(p, SHARDED_NDEV, job_rhs_overlap_pair,
                      (0.1, vort, vel))
    got = res[0]["fields"]
    stats = [r["stats"] for r in res]
    rows = _rank_rows(stats, lambda s: 0)
    rel = {"overlapped_vs_plain": _rel(got["overlapped"]["f"],
                                       got["plain"]["f"]),
           "overlapped_vs_one_device": _rel(got["overlapped"]["f"], f_ref)}
    emit("sharded_a", case="cavity3d 2^3 ngl=3 overlap_dss, one rhs (plain "
         "DSS route)", ndev=SHARDED_NDEV, rel_err=rel, limit=PARITY_LIMIT,
         bitwise=bool(np.array_equal(got["overlapped"]["f"],
                                     got["plain"]["f"])), ranks=rows)
    check(all(v <= PARITY_LIMIT for v in rel.values()),
          f"sharded overlap: {rel} > {PARITY_LIMIT}")
    _check_ranks("overlap", rows, stats)
    k1["sharded_overlap"] = sum(r["k1_launches"] for r in rows)
    del p, ref

    # 3D Taylor-Green on 4x3x3 distorted hexes: one rhs on the gather DSS
    tmp = tempfile.mkdtemp(prefix="sharded-")
    try:
        cfg = gmsh_tg_config(write_hex_msh(os.path.join(tmp, "hex.msh"), 4,
                                           3, 3, MESH_DISTORT),
                             "taylor_green3d", 3, 1)
        p = make_problem(cfg, device=dev, dtype=torch.float64,
                         **dict(opts, cg_rtol=1e-13))
        p.setUp()
        rng = np.random.default_rng(0)
        vort = rng.standard_normal((p.mesh.n_nodes, p.dim_w))
        vel = np.zeros((p.mesh.n_nodes, p.dim))
        f_ref, _ = rhs_local(p.engine_ops, p.start_time, p.to_local(vort),
                             p.to_local(vel))
        f_ref = p.to_global(f_ref, p.dim_w)
        res = run_sharded(p, SHARDED_NDEV, job_rhs, (p.start_time, vort, vel))
        stats = [r["stats"] for r in res]
        rows = _rank_rows(stats, lambda s: 0)
        rel = _rel(res[0]["fields"]["f"], f_ref)
        emit("sharded_a", case="taylor-green3d 4x3x3 distorted hexes ngl=3, "
             "gather DSS, one rhs", ndev=SHARDED_NDEV, rel_err=rel,
             limit=PARITY_LIMIT, ranks=rows,
             dss_pass_launches=[s["dss_pass_launches"] for s in stats])
        check(rel <= PARITY_LIMIT, f"sharded hexes: {rel} > {PARITY_LIMIT}")
        check(all(s["dss_pass_launches"] == 0 for s in stats),
              "sharded hexes: the DSS pass ran on a gmsh mesh")
        _check_ranks("hexes", rows, stats)
        k1["sharded_hex"] = sum(r["k1_launches"] for r in rows)
        del p
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) the flagship in 2 slabs of 12x24x24, 1 step from phase 5's state
    p = flagship
    state = (p.vort, p.vel, p.start_time, p.max_steps)
    out = {}
    for ndev in (1, SHARDED_NDEV):
        p.vort, p.vel = state[:2]
        p.start_time, p.max_steps = t_flagship, 1
        p.opts["ndev"] = ndev
        p.cg_log = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        t_end, steps = p.start_solver(dt0=1e-3)
        torch.cuda.synchronize()
        out[ndev] = dict(s=time.perf_counter() - t0, t=t_end, steps=steps,
                         vort=p.vort.cpu().numpy(), vel=p.vel.cpu().numpy(),
                         attempts=len(p.cg_log) // 16,
                         iters=[int(i) for i, _ in p.cg_log],
                         stats=getattr(p, "rank_stats", None))
    p.vort, p.vel, p.start_time, p.max_steps = state
    p.opts.pop("ndev")
    one, two = out[1], out[SHARDED_NDEV]
    stats = two["stats"]
    rows = _rank_rows(stats, lambda s: _k1_expected(s, True))
    ops = p.engine_ops
    plane_bytes = 4 * int(np.prod(ops.nelem[1:])) * ops.lay_v.plane_cols * 4
    gap = {k: _rel(two[k], one[k]) for k in ("vort", "vel")}
    emit("sharded_b", config="cavity3d 24^3 ngl=4 f32 cg_rtol=1e-6, 2 slabs "
         "of 12x24x24 on one card", t_start=t_flagship,
         s_per_step=[one["s"], two["s"]], steps=[one["steps"], two["steps"]],
         t=[one["t"], two["t"]], attempts=[one["attempts"], two["attempts"]],
         cg_iters_single=one["iters"],
         cg_iters_by_rank=[s["cg_iters"] for s in stats],
         gap=gap, limit=SHARDED_F32_LIMIT, ranks=rows,
         staged_bytes_per_apply=[r["staged_bytes"] / max(r["k1_launches"], 1)
                                 for r in rows],
         plane_bytes_per_apply=plane_bytes,
         phase_s=time.perf_counter() - t_phase)
    check(one["steps"] == two["steps"] == 1,
          f"sharded flagship: steps {one['steps']} {two['steps']}")
    check(one["attempts"] == two["attempts"],
          f"sharded flagship: attempts {one['attempts']} one device, "
          f"{two['attempts']} sharded")
    check(all(v <= SHARDED_F32_LIMIT for v in gap.values()),
          f"sharded flagship: gap {gap} > {SHARDED_F32_LIMIT}")
    _check_ranks("flagship", rows, stats)
    k1["sharded_flagship"] = sum(r["k1_launches"] for r in rows)
    return k1


def _validation_cavity(torch, dev):
    """(a) The coarse Re=100 cavity march in f64 on the card, against the
    JAX package's own march. Returns K1's launches."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.exp import cavity_re100 as cav
    from pynama_tpu_torch.ops.fused import fused_apply

    ne, ngl, t_end = CAVITY_COARSE
    fused_apply.launches = 0
    p = Problem(cav.cavity_cfg(ne, ngl, t_end), device=dev,
                dtype=torch.float64, solver="cg", cg_rtol=1e-9,
                cg_maxiter=4000)
    t0 = time.perf_counter()
    p.setUp()
    setup_s = time.perf_counter() - t0
    p.cg_log = []
    t0 = time.perf_counter()
    t, steps, _, _ = cav.march_segments(p, [t_end])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fused_apply.launches
    applications = cav.k1_applications(p.cg_log)
    prof = cav.centerline_profiles(p)
    ref_gap = {}
    for name in ("u_centerline", "v_centerline"):
        ref = np.asarray(CAVITY_REF[name])
        ref_gap[name] = float(np.abs(np.asarray(prof[name]) - ref).max()
                              / np.abs(ref).max())
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all())
    emit("validation_cavity",
         case=f"cavity Re=100 {ne}x{ne} ngl={ngl} f64 cg_rtol=1e-9 to "
         f"t={t_end} (tests/test_cavity_re100.py's coarse march, cut)",
         setup_s=setup_s, t=t, accepted_steps=steps,
         ref_steps=CAVITY_REF["steps"], step_slack=CAVITY_STEP_SLACK,
         wall_s=wall, s_per_step=wall / max(steps, 1),
         rhs_evals=len(p.cg_log) // 2,
         cg_iters=sum(int(i) for i, _ in p.cg_log), ref_gap=ref_gap,
         ref_limit=CAVITY_PROFILE_LIMIT, summary=cav.summarize(prof),
         k1_launches=k1, k1_applications=applications, finite=finite)
    check(finite, "validation cavity: non-finite fields")
    check(abs(t - t_end) < 1e-9, f"validation cavity: stopped at t={t}")
    check(all(v <= CAVITY_PROFILE_LIMIT for v in ref_gap.values()),
          f"validation cavity: profiles vs the JAX package's {ref_gap} > "
          f"{CAVITY_PROFILE_LIMIT}")
    check(abs(steps - CAVITY_REF["steps"]) <= CAVITY_STEP_SLACK,
          f"validation cavity: {steps} accepted steps, the JAX package "
          f"took {CAVITY_REF['steps']} (slack {CAVITY_STEP_SLACK})")
    check(k1 == applications > 0, f"validation cavity: K1 launched {k1} "
          f"times, the engine made {applications} applications")
    return k1


def _validation_ibm_cd(torch, dev):
    """(b) The static cylinder's drag to t=30 at IBM_CD_NELEM, f32, against
    the TPU artifact's tails. Returns K1's launches, summed."""
    from pynama_tpu_torch.exp import ibm_cd
    from pynama_tpu_torch.ibm import interpolation as I

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           IBM_CD_TPU_ART)) as f:
        tpu = json.load(f)["runs"]
    k1 = 0
    for nelem in IBM_CD_NELEM:
        ref = tpu[str(nelem)]
        torch.cuda.synchronize()
        p, rec = ibm_cd.run(nelem, IBM_CD_T_END, dev, torch.float32)
        body_res = float((I.interp_H(p.ibm_ops, p.nodes_tab, p.w_tab, p.vel)
                          - p._field(p.body.velocities())).abs().max())
        ref_tail = ibm_cd.tail(ref["times"], ref["cd_reference_definition"],
                               ref["t_reached"])
        tails = {
            "cd_phys": (rec["cd_phys_tail_mean"], ref["cd_phys_tail_mean"],
                        ref["cd_phys_tail_std"]),
            "cd_reference_definition": (
                rec["cd_reference_definition_tail_mean"],
                float(ref_tail.mean()), float(ref_tail.std()))}
        finite = bool(torch.isfinite(p.vort).all()) and bool(
            torch.isfinite(p.vel).all())
        emit("validation_ibm_cd",
             case=f"static cylinder {nelem}^2 ngl=3 f32 cg_rtol=1e-6 to "
             f"t={IBM_CD_T_END} (exp/ibm_cd.py)",
             **{k: rec[k] for k in ("h", "lag_points", "t_reached", "steps",
                                    "setup_s", "wall_s", "s_per_step",
                                    "cg_solves", "cg_iters", "k1_launches",
                                    "k1_applications")},
             tpu_steps=ref["steps"],
             tails={k: {"card": a, "tpu_mean": b, "tpu_std": s}
                    for k, (a, b, s) in tails.items()},
             body_res=body_res, body_res_limit=IBM_BODY_RES_LIMIT,
             finite=finite)
        what = f"validation ibm_cd {nelem}^2"
        check(finite, f"{what}: non-finite fields")
        check(abs(rec["t_reached"] - IBM_CD_T_END) < 1e-9,
              f"{what}: stopped at t={rec['t_reached']}")
        for k, (a, b, s) in tails.items():
            check(abs(a - b) <= s, f"{what}: {k} tail mean {a:.6g}, the "
                  f"TPU's {b:.6g} +- {s:.3g}")
        check(body_res <= IBM_BODY_RES_LIMIT, f"{what}: max|H v - v_body| "
              f"{body_res:.3e} > {IBM_BODY_RES_LIMIT}")
        check(rec["k1_launches"] == rec["k1_applications"] > 0,
              f"{what}: K1 launched {rec['k1_launches']} times, the engine "
              f"made {rec['k1_applications']} applications")
        k1 += rec["k1_launches"]
        del p
    return k1


def fs_digest(part, rec):
    """The numbers of an FS-stage analysis that the analyses phase holds
    against the JAX package's (FS_REF), from a record of
    pynama_tpu_torch.exp.fs_spectrum / fs_walls / fs_woodbury `analyze`:
    spectrum, per stage and preconditioner, kappa, the k-drop table's
    kappas, the low- and high-mode census and its margin; walls, each
    variant's kappa; woodbury, the CG iteration counts."""
    if part == "spectrum":
        return {stage: {pc: {"kappa": r["kappa"],
                             "kdrop": [v[0] for v in r["kdrop"].values()],
                             "low": list(r["low"].values()),
                             "high": list(r["high"].values()),
                             "margin": r["margin"]}
                        for pc, r in ((pc, rec[stage][pc])
                                      for pc in ("jacobi", "fdm"))}
                for stage in ("FS", "MAIN")}
    if part == "walls":
        return {tag: v["kappa"] for tag, v in rec["variants"].items()}
    return dict(rec["iters"])


def phase_validation(torch, dev):
    """(a) the coarse cavity march, (b) the cylinder drag; returns K1's
    launches by path."""
    t_phase = time.perf_counter()
    k1 = {"validation_cavity": _validation_cavity(torch, dev),
          "validation_ibm_cd": _validation_ibm_cd(torch, dev)}
    emit("validation", phase_s=time.perf_counter() - t_phase, **k1)
    return k1


def _fs_check(part, ne, card):
    """Hold an analysis's fs_digest on the card against FS_REF."""
    from pynama_tpu_torch.exp.fs_spectrum import record_gap
    ref = FS_REF[part][ne]
    gap, differ = record_gap(card, ref)
    what = f"analyses {part} {ne}^3"
    if part == "woodbury":
        check(all(abs(card[k] - ref[k]) <= FS_ITER_SLACK
                  for k in ref if k.startswith("G/")),
              f"{what}: CG iterations {card} against the JAX package's "
              f"{ref} (slack {FS_ITER_SLACK} on G's)")
        return gap, differ
    check(gap <= FS_LIMIT, f"{what}: relative gap {gap:.3e} to the JAX "
          f"package's > {FS_LIMIT}")
    if part == "spectrum":
        margin = min(card[s][pc]["margin"] for s in card for pc in card[s])
        check(not differ or margin <= FS_LIMIT,
              f"{what}: census {differ} differs with every eigenvalue "
              f"{margin:.3e} from its threshold")
    return gap, differ


def phase_analyses(torch, dev):
    """(a)-(c) the FS-stage analyses in f64 against the JAX package's
    numbers, K1 never launched; (d) the measurement drivers at cut-down
    sizes, each with its agreement check. Returns K1's launches in
    fused_ab and ngl7_blocks."""
    import io
    from pynama_tpu_torch.exp import (dss_gather_opt, fs_spectrum, fs_walls,
                                      fs_woodbury, fused_ab, ngl7_blocks,
                                      sumfact_chip, sumfact_roofline)
    from pynama_tpu_torch.ops.fused import fused_apply

    t_phase = time.perf_counter()
    runs = [("spectrum", ne, fs_spectrum) for ne in FS_SPECTRUM_NE] + [
        ("woodbury", FS_WOODBURY_NE, fs_woodbury),
        ("walls", FS_WALLS_NE, fs_walls)]
    for part, ne, analysis in runs:
        fused_apply.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = analysis.analyze(ne, 4, device=dev, dtype=torch.float64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gap, differ = _fs_check(part, ne, fs_digest(part, rec))
        extra = {"k_check": rec["k_check"], "iters": rec["iters"],
                 "ref_iters": FS_REF[part][ne],
                 "iter_slack": FS_ITER_SLACK} if part == "woodbury" else {}
        emit(f"analyses_{part}", ne=ne, ngl=4, dtype="float64", wall_s=wall,
             peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
             ref_gap=gap, limit=FS_LIMIT, counts_differ=differ,
             k1_launches=fused_apply.launches, **extra)
        check(fused_apply.launches == 0, f"analyses {part}: K1 launched "
              f"{fused_apply.launches} times")
        if part == "woodbury":
            check(rec["k_check"] <= FS_K_CHECK_LIMIT, f"analyses woodbury: "
                  f"K = S + B^T B to {rec['k_check']:.3e} > "
                  f"{FS_K_CHECK_LIMIT}")
    k1 = {}
    drivers = {"fused_ab": fused_ab, "ngl7_blocks": ngl7_blocks,
               "sumfact_chip": sumfact_chip,
               "sumfact_roofline": sumfact_roofline,
               "dss_gather_opt": dss_gather_opt}
    for name, argv in ANALYSES_DRIVERS:
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = drivers[name].main(argv)
        emit(f"analyses_{name}", argv=argv, wall_s=time.perf_counter() - t0,
             k1_launches=fused_apply.launches, **out)
        # the gmsh drivers run no box-mesh operator: K1 stays at 0
        expected = out.get("k1_applications", 0)
        check(fused_apply.launches == expected, f"analyses {name}: K1 "
              f"launched {fused_apply.launches} times, the driver made "
              f"{expected} applications")
        key = {"fused_ab": "analyses_fused_ab",
               "ngl7_blocks": "analyses_ngl7"}.get(name)
        if key:
            check(expected > 0, f"analyses {name}: no K1 application")
            k1[key] = expected
    emit("analyses", phase_s=time.perf_counter() - t_phase, **k1)
    return k1


def _schwarz_step(torch, dev, pc):
    """The flagship config (24^3 ngl=4, f32, CG rtol 1e-6) set up under
    `pc` and stepped once, K1's launches counted from 0 around the step
    and checked against the CG log. Returns (row, problem)."""
    from pynama_tpu_torch.cases import Problem
    from pynama_tpu_torch.ops.fused import fused_apply

    cfg = cavity_config((24, 24, 24), 4, 0.5, 0.01, [2, 0, 0], 1, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    p = Problem(cfg, device=dev, dtype=torch.float32, solver="cg",
                cg_rtol=1e-6, cg_maxiter=SCHWARZ_MAXITER, pc=pc)
    p.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(p.engine_ops.pc == pc and p.engine_ops.fused,
          f"schwarz: built pc={p.engine_ops.pc}, asked {pc} on K1")
    p.cg_log = []
    fused_apply.launches = 0
    _epilogue_zero()
    t0 = time.perf_counter()
    t_end, steps = p.start_solver(dt0=1e-3)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_apply.launches
    stats = _cg_stats(p.cg_log)
    expected = _k1_expected(stats, True, pc=pc)
    epi = _epilogue_check(f"schwarz_step_{pc}", sum(stats["cg_applies"]),
                          pc == "schwarz")
    iters = stats["cg_iters"]
    finite = bool(torch.isfinite(p.vort).all()) and bool(
        torch.isfinite(p.vel).all())
    row = dict(setup_s=setup_s, setup_phases_s=p.setup_phases,
               accepted_steps=steps, t_end=t_end, s_per_step=run_s / max(
                   steps, 1), rhs_evals=len(iters) // 2,
               cg_iters_fs=sum(iters[0::2]), cg_iters_main=sum(iters[1::2]),
               cg_iters_fs_main=[iters[i:i + 2]
                                 for i in range(0, len(iters), 2)],
               cg_loop_applies=sum(stats["cg_applies"]),
               fused_apply_launches=launches, expected_launches=expected,
               epilogue_launches=epi,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               finite=finite)
    check(steps == 1, f"schwarz {pc}: accepted {steps} steps, want 1")
    check(finite, f"schwarz {pc}: non-finite vort/vel")
    check(max(iters) < SCHWARZ_MAXITER, f"schwarz {pc}: a CG solve ran to "
          f"maxiter {SCHWARZ_MAXITER}")
    check(launches > 0 and launches == expected,
          f"schwarz {pc}: fused_apply launched {launches} times, the step "
          f"made {expected} operator applications")
    return row, p


def _schwarz_kernel(torch, p):
    """K1 with the Schwarz matrix KinvT in place of K^T at the flagship
    shape, on the input the preconditioner gives it (free·r·inv_mult),
    against its plain version: f32 with the engine's KinvT, f64 with the
    host pseudo-inverse in f64; event times of both in f32 beside the
    bound."""
    from pynama_tpu_torch.engine.local_engine import element_pinv_T
    from pynama_tpu_torch.ops.fused import fused_apply, fused_apply_ref

    ops = p.engine_ops
    nelem, ngl, dim = ops.nelem, ops.ngl, ops.dim
    rng = np.random.default_rng(0)
    r = p.to_local(rng.standard_normal((p.mesh.n_nodes, dim)))
    out = {}
    for dtype, limit, matT in (
            (torch.float32, F32_LIMIT, ops.KinvT),
            (torch.float64, F64_LIMIT, torch.as_tensor(
                element_pinv_T(p._em.K), dtype=torch.float64,
                device=r.device).contiguous())):
        dname = str(dtype).split(".")[-1]
        t = (ops.free_fs * r * ops.lay_v.inv_mult).to(dtype).contiguous()
        y, bnd = fused_apply(t, matT, nelem, ngl, dim)
        yr, br = fused_apply_ref(t, matT, nelem, ngl, dim)
        torch.cuda.synchronize()
        scale = float(yr.abs().max())
        row = dict(max_abs_err=float((y - yr).abs().max()),
                   bnd_abs_err=float((bnd - br).abs().max()),
                   limit=limit,
                   dup_spread=_dup_spread(torch, y, p.mesh.cell_nodes, dim))
        row["rel_err"] = row["max_abs_err"] / scale
        row["bnd_rel_err"] = row["bnd_abs_err"] / scale
        what = f"schwarz: K1 with KinvT {dname} {matT.shape[0]}->" \
            f"{matT.shape[1]}"
        check(row["rel_err"] <= limit, f"{what}: rel err "
              f"{row['rel_err']:.3e} > {limit}")
        check(row["bnd_rel_err"] <= limit, f"{what}: bnd rel err "
              f"{row['bnd_rel_err']:.3e} > {limit}")
        check(row["dup_spread"] == 0.0, f"{what}: duplicate slots differ "
              f"by {row['dup_spread']:.3e}")
        if dtype == torch.float32:
            E, N = t.shape[0], matT.shape[1]
            row["ms"] = _median_ms(torch, lambda: fused_apply(
                t, matT, nelem, ngl, dim))
            row["plain_ms"] = _median_ms(torch, lambda: fused_apply_ref(
                t, matT, nelem, ngl, dim))
            row["k1_K_ms"] = _median_ms(torch, lambda: fused_apply(
                t, ops.KT, nelem, ngl, dim))
            row["bound_ms"], row["bound_by"] = _gemm_bound(
                E, t.shape[1], N, dname,
                2 * (E // nelem[0]) * (N // ngl) * t.element_size())
        out[dname] = row
    return out


def _schwarz_cli(torch, dev):
    """run_case -pc schwarz on the card: cavity.yaml at its own size cut to
    1 step (a JSON copy), f32 CG rtol 1e-6, in a directory of its own; K1
    launches against its CG log."""
    from pynama_tpu_torch import run_case
    from pynama_tpu_torch.ops.fused import fused_apply

    hdf5 = _importable("h5py")
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="schwarz-cli-")
    try:
        os.chdir(tmp)
        cfg = run_case.load_case("cavity")
        cfg["time-solver"]["max-steps"] = 1
        with open("cavity-1.yaml", "w") as f:
            json.dump(cfg, f)
        argv = ["-case", "cavity-1.yaml", "-log", "WARNING", "-device",
                "cuda", "-dtype", "float32", "-solver", "cg", "-cg-rtol",
                "1e-6", "-maxiter", str(SCHWARZ_MAXITER), "-pc", "schwarz"]
        torch.cuda.synchronize()
        fused_apply.launches = 0
        t0 = time.perf_counter()
        with _cli_probe(torch, run_case):
            p, t_end, steps = _cli_production(run_case, argv, hdf5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_apply.launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    stats = _cg_stats(p.cg_log)
    expected = _k1_expected(stats, True, pc="schwarz")
    finite = bool(torch.isfinite(p.vort).all())
    row = dict(config="cavity.yaml 30x10x10 ngl=3 f32 -solver cg -pc "
               "schwarz -cg-rtol 1e-6, depth cut to 1 step",
               io_route="hdf5" if hdf5 else "binary", pc=p.engine_ops.pc,
               accepted_steps=steps,
               t_end=t_end, wall_s=wall, run_s=p.run_s,
               cg_iters=stats["cg_iters"], k1_launches=launches,
               k1_expected=expected, finite=finite)
    check(p.engine_ops.pc == "schwarz",
          f"schwarz cli: pc {p.engine_ops.pc}")
    check(steps == 1 and finite, f"schwarz cli: {steps} steps, finite "
          f"{finite}")
    check(max(stats["cg_iters"]) < SCHWARZ_MAXITER,
          "schwarz cli: a CG solve ran to maxiter")
    check(launches == expected > 0, f"schwarz cli: K1 launched {launches} "
          f"times, the run made {expected} applications")
    return row, launches


def phase_schwarz(torch, dev):
    """(a) the flagship config stepped once under pc="jacobi" and under
    pc="schwarz" (K1 launches == applications, the preconditioner's
    included); (b) K1 with KinvT against its plain version; (c) run_case
    -pc schwarz; (d) f64 GPU-vs-CPU parity of the 3^3 cavity under
    Schwarz. Returns K1's launches on the Schwarz paths."""
    t_phase = time.perf_counter()
    j, p = _schwarz_step(torch, dev, "jacobi")
    vort_j = p.vort.cpu().numpy()
    del p
    torch.cuda.empty_cache()
    s, p = _schwarz_step(torch, dev, "schwarz")
    kernel = _schwarz_kernel(torch, p)
    vort_gap = _rel(p.vort.cpu().numpy(), vort_j)
    del p
    torch.cuda.empty_cache()
    cli, cli_launches = _schwarz_cli(torch, dev)
    cavity = cavity_config((3, 3, 3), 3, 1.0, 0.02, [1.0, 0, 0], 3, 1.0)
    parity = _parity_case(
        torch, dev, "cavity3d 3^3 ngl=3 pc=schwarz", cavity,
        dict(solver="cg", cg_rtol=1e-13, cg_maxiter=4000, pc="schwarz"),
        1e-8)
    emit("schwarz", config="cavity3d 24^3 ngl=4 f32 cg_rtol=1e-6, 1 step "
         "from rest, dt0 1e-3", jacobi=j, schwarz=s,
         iter_ratio_fs=s["cg_iters_fs"] / j["cg_iters_fs"],
         iter_ratio_main=s["cg_iters_main"] / j["cg_iters_main"],
         s_per_step_ratio=s["s_per_step"] / j["s_per_step"],
         vort_rel_diff=vort_gap, k1_kinv=kernel, cli=cli,
         parity_rel_err=parity, phase_s=time.perf_counter() - t_phase)
    return {"schwarz": s["fused_apply_launches"],
            "schwarz_cli": cli_launches}


def _cg_state(torch, dev, dtype, n, jacobi, seed):
    """A CGState of a masked system on random vectors of length n on dev
    (run and live true, k = 3; the same values on every device for a seed)
    and a maker of more such vectors."""
    from pynama_tpu_torch.ops import cg_epilogue as E
    g = torch.Generator(device="cpu").manual_seed(seed)

    def vec():
        return (torch.rand(n, generator=g, dtype=torch.float64)
                + 0.5).to(dtype).to(dev)

    free = (torch.rand(n, generator=g) > 0.05).to(dtype).to(dev)
    system = E.MaskedSystem(apply=None, free=free, inv_mult=vec(),
                            precond=vec() if jacobi else (lambda v: v))
    s = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    st = E.CGState(system, vec(), vec(), vec(), s(2.5), s(3.0), s(1e-30),
                   torch.tensor(True, device=dev),
                   torch.tensor(True, device=dev),
                   torch.tensor(3, device=dev), 1000)
    return st, vec


def _rotating(ring, fn):
    """A call of fn(state, y, z) on the next of ring's (state, y, z), in
    turn: timed back to back, the calls then read HBM, not L2."""
    turn = [0]

    def call():
        fn(*ring[turn[0] % len(ring)])
        turn[0] += 1
    return call


def _eager_update(torch, st, y, c):
    """One Jacobi iteration's update as eager PyTorch launches on a
    CGState's vectors, Ap = free * y included, for the yardstick; c holds the state's run flag and the constants one and zero,
    made once as pcg's prologue makes them."""
    inv, free, dmask, run = st.inv, st.free, st.dmask, c["run"]
    one, zero = c["one"], c["zero"]
    gamma, rr, tol2 = st.sf[0], st.sf[1], st.sf[5]
    ap = free * y
    pap = (st.p * ap * inv).sum()
    ok = run & (pap > 0)
    alpha = torch.where(ok, gamma / torch.where(ok, pap, one), zero)
    x = st.x + alpha * st.p
    r = st.r - alpha * ap
    zz = r / dmask
    gn, rn = (r * zz * inv).sum(), (r * r * inv).sum()
    beta = torch.where(run, gn / torch.where(run, gamma, one), zero)
    p = zz + beta * st.p
    g2 = torch.where(run, gn, gamma)
    r2 = torch.where(run, rn, rr)
    k2 = st.si[0] + run.to(torch.int64)
    return x, p, (r2 > tol2) & (k2 < 1000) & (g2 > 0)


def _epilogue_rows(record):
    """The CG epilogue's kernels in the kernel record, from
    phase_cg_epilogue's `record` and EPILOGUE_BY_PATH: launches in the main
    path and by path, the largest relative error against the plain version,
    device µs and HBM bound µs by dtype and preconditioner form."""
    err = max(max(v["rel_err"].values()) for v in record.values()
              if "rel_err" in v)
    return [{
        "name": k, "route": "cuda",
        "source": "pynama_tpu_torch/csrc/cg_epilogue.cu",
        "replaces": "pynama_tpu/solver/cg.py:69 (the while_loop body)",
        "launches": EPILOGUE_BY_PATH["main"][k],
        "launches_by_path": {p: c[k] for p, c in EPILOGUE_BY_PATH.items()},
        "max_rel_err": err, "bound_by": "hbm",
        **{f"{form}_{q}": v["kernels"][k][q]
           for form, v in record.items() if k in v.get("kernels", {})
           for q in ("device_us", "bound_us")}}
        for k in EPILOGUE_STEPS]


def phase_cg_epilogue(torch, dev):
    """The fused CG epilogue (ops/cg_epilogue.py) at the flagship's local
    velocity length (24^3 ngl=4: 2,654,208 values), f32 and f64: one
    iteration's steps, Jacobi (cg_pap, cg_xr, cg_p) and with an eager
    preconditioner (cg_pap, cg_xr, cg_rz, cg_p), against the plain steps
    on the same values on the CPU; the launch counters; each kernel's device µs
    beside its HBM bound, and the eager update's device µs, each timed on
    calls that rotate among EPILOGUE_RING states. Returns the record."""
    from pynama_tpu_torch.ops import cg_epilogue as E
    steps = {k: getattr(E, k) for k in EPILOGUE_STEPS}
    n = 13824 * 192
    # vectors read and written once per call, by kernel and form
    passes = {True: {"cg_pap": 5, "cg_xr": 8, "cg_p": 4},
              False: {"cg_pap": 5, "cg_xr": 6, "cg_rz": 3, "cg_p": 3}}
    calls = {"cg_pap": lambda st, y, z: E.cg_pap(st, y),
             "cg_xr": lambda st, y, z: E.cg_xr(st, y),
             "cg_rz": lambda st, y, z: E.cg_rz(st, z),
             "cg_p": lambda st, y, z: E.cg_p(st, None if st.dmask is not None
                                            else z)}
    out = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        eb = torch.empty((), dtype=dtype).element_size()
        for jac in (True, False):
            st, vec = _cg_state(torch, dev, dtype, n, jac, 11)
            ref, vec_ref = _cg_state(torch, "cpu", dtype, n, jac, 11)
            y, z = vec(), vec()
            y_ref, z_ref = vec_ref(), vec_ref()
            before = {k: f.launches for k, f in steps.items()}
            ap = E.cg_pap(st, y)
            E.cg_xr(st, ap)
            if not jac:
                E.cg_rz(st, z)
            E.cg_p(st, None if jac else z)
            ap_r = E.cg_pap(ref, y_ref)
            E.cg_xr(ref, ap_r)
            if not jac:
                E.cg_rz(ref, z_ref)
            E.cg_p(ref, None if jac else z_ref)
            torch.cuda.synchronize()
            launched = {k: f.launches - before[k] for k, f in steps.items()}
            want = {"cg_pap": 1, "cg_xr": 1, "cg_rz": 0 if jac else 1,
                    "cg_p": 1}
            check(launched == want, f"cg_epilogue launches {launched}, "
                  f"want {want}")
            errs = {k: _rel(getattr(st, k).double().cpu().numpy(),
                            getattr(ref, k).double().numpy())
                    for k in ("x", "r", "p")}
            errs["sf"] = _rel(st.sf.double().cpu().numpy(),
                              torch.stack(ref.sf).double().numpy())
            errs["ap"] = _rel(ap.double().cpu().numpy(),
                              ap_r.double().numpy())
            si_ref = [int(v) for v in ref.si]
            check(max(errs.values()) <= tol and st.si.tolist() == si_ref,
                  f"cg_epilogue {dn} jacobi={jac}: {errs}, si "
                  f"{st.si.tolist()} vs {si_ref}")
            del st, ref, y, z, y_ref, z_ref, ap, ap_r
            ring = []
            for i in range(EPILOGUE_RING):
                s_i, v_i = _cg_state(torch, dev, dtype, n, jac, 20 + i)
                ring.append((s_i, v_i(), v_i()))
            times = {}
            for k, nb in passes[jac].items():
                us, _ = _device_us(torch, _rotating(ring, calls[k]))
                times[k] = dict(device_us=us,
                                bound_us=1e6 * nb * n * eb / HBM_BPS)
            out[f"{dn}_{'jacobi' if jac else 'eager_pc'}"] = dict(
                rel_err=errs, launches=launched, kernels=times)
            if jac:
                # one Jacobi iteration's update as eager launches
                eager = [(s_i, y_i, dict(
                    run=s_i.si[1] != 0, one=s_i.sf.new_ones(()),
                    zero=s_i.sf.new_zeros(()))) for s_i, y_i, _ in ring]
                us, per = _device_us(torch, _rotating(
                    eager, lambda *a: _eager_update(torch, *a)))
                out[f"{dn}_eager_update"] = dict(device_us=us,
                                                 kernel_names=len(per))
            del ring
            torch.cuda.empty_cache()
    emit("cg_epilogue", n=n, ring=EPILOGUE_RING, **out)
    return out


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
    k1_paths = {"main": launches,
                "global_direct_cg_rhs": phase_global_direct(torch, dev),
                "global_ops": phase_global_ops(torch, dev),
                "gmres": phase_gmres(torch, dev)}
    k1_paths.update(phase_cli(torch, dev))
    k1_more, dss_paths = phase_unstructured(torch, dev, problem, t_main)
    k1_paths.update(k1_more)
    k1_paths.update(phase_ibm(torch, dev))
    k1_paths.update(phase_sharded(torch, dev, problem, t_main))
    k1_paths.update(phase_validation(torch, dev))
    k1_paths.update(phase_analyses(torch, dev))
    k1_paths.update(phase_schwarz(torch, dev))
    epilogue = phase_cg_epilogue(torch, dev)

    record["launches"] = launches
    record["launches_by_path"] = k1_paths
    record["dss_pass_launches_by_path"] = dss_paths
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
        **{k: r[k] for k in ("gemm3x_device_us", "gemm3x_bound_us",
                             "launches_by_path", "dss_pass_launches_by_path")
           if k in r}}
        for name, src, replaces, r in kernels] + _epilogue_rows(epilogue)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
