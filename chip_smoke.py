#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_mpc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases fd_kernels,fixture,id_sim_kernels
    python3 chip_smoke.py --phases talos_id_sim_kernels,talos_closed_loop

The second form runs the device and build phases and then only the named
ones of `PHASES` (kernel checks and times, no launch counts and no kernel
summary), for holding two trees against each other in one call: run it
from each tree's root in turn.

Phases, each printing one line; any failure raises and exits non-zero:
  1. device  — requires a CUDA card; prints its name and power limit.
  2. build   — compiles the CUDA kernels (csrc/*.cu, nvcc, sm_90a).
  3. kernels — every kernel against its plain PyTorch twin on the card, at
               the main path's shapes (Go2 kinodynamics T=100, B=128, from
               a perturbed standing problem), f32 and f64: K1+K2
               stage_linearize, K5 term_linearize, K3 riccati_backward, K6
               parallel_riccati_backward (also at B=1, its three device
               kernels' times read from a profiler trace), K4
               linear_rollout, K1 stage_eval on the candidates, and K9
               tick_refs on 128 fused-tick carries with perturbed
               measurements; times as CUDA-event medians (the slow twins of
               K1+K2, K3 and K5 on 3 repetitions).  Then the full-dynamics
               kernels (K7 inside): fd_stage_linearize (u_scale None and
               "auto"), fd_stage_eval and fd_dynamics, on a perturbed Go2
               full-dynamics T=100, B=128 problem with all 68 inequality
               rows, f32 (gated against the twin in f64) and f64.
  4. batched — 30 warm-started one-iteration solves of B=128 Go2 T=100
               problems in f32 (the bench configuration); feasibility gate
               max prim_res < 5e-4.
  5. fixture — f32 re-solve of Go2 T=100 on the card against the committed
               float64 fixture: max|us - us*| <= 1e-4, max|xs - xs*| <= 1e-3.
  6. mpc     — the receding-horizon MPC (Go2 T=100 trot at 0.2 m/s), 30
               ticks fed back their own planned next state: finite plans, no
               divergence; per-tick wall time.
  7. fused   — the fused tick (FusedMPC, the bench's configuration: trot
               10/30/10/30 at 0.2 m/s, apex 0.15 m, mu_init 1e-6, f32):
               step_batched at B=128 for 20 self-fed ticks (finite, no
               divergence, max prim_res < 5e-3; ticks/s), one tick under
               torch.cuda.set_sync_debug_mode("error") (no host sync), and
               20 B=1 `step` ticks (p50/p99).
  8. latency — the B=1 latency path: the same engine with the
               associative-scan Riccati (SolverSettings(parallel=True), K6),
               f32: `step_donated` 20 times with one synchronize per
               repetition (per-call mean, 10 repetitions, p50/p99), 20 eager
               `step` ticks (p50/p99) and a 20-tick `self_rollout` from the
               pristine carry, gated at max prim_res < 5e-3 and median
               < 5e-4 (the JAX bench's gate).
  9. fd_batched — Go2 full dynamics without the friction pyramids (a cut
               of the configuration: at the standing posture no force inside
               them holds the robot at rest), B=128, T=100, f32, the batched
               recipe from the quasistatic warm start: last call's max
               prim_res < 1e-3; solves/s.  Then 4 calls of the same recipe
               with all 68 rows: finite, no divergence, prim printed.
 10. fd_mpc  — the host MPC on full dynamics (examples/go2_fulldynamics.py:
               T=50 trot, pyramids cut as in 9), f32, 30 ticks: finite, no
               divergence, stage-0 forces unilateral and within 35 % of
               m g; tick p50/p99 and one tick's trace.  Then 4 ticks of the
               same MPC with all 68 rows: finite, no divergence, prim and
               stage-0 force sum printed.
 11. id_sim_kernels — (in phase 3's place in the order, after the
               full-dynamics kernels) K8's qp_admm and id_assemble and
               K10's sim_step against their twins at B=1 and B=128, f32 and
               f64, on perturbed Go2 states with the contact sets {all,
               diagonal pair} and the simulator standing, in free fall and
               with one foot lifted (phase_id_sim_kernels states the gates);
               times, bounds, registers and stack from the ptxas log.
 12. closed_loop — the port's examples/go2_kinodynamics.py on the card,
               f32, uncut (T=50 trot at 0.2 m/s, the example's ID with 60
               ADMM steps, simulator dt 1e-3, 10 inner steps a tick), 160
               MPC ticks: the four walking gates of tests/test_walking.py;
               p50/p99 of the tick, of its references (the two state
               derivatives through K11 state_derivative, with the ten inner
               steps' interpolated targets), of the inner step (ID and
               simulator) and of the inner step with a tenth of the
               references; the four kernels' times and a trace of 10
               inner steps (loop_readings).
 13. talos_kernels — (after phase 11) the wide stage kernels of
               csrc/linearize_wide.cu (K1+K2, K1 on the candidates, K5 for
               6D contacts and 23 joints) against their twins on a
               perturbed Talos kinodynamics T=100, B=128 problem with the
               feet lifted in turns, f32 (gated against the twin in f64 at
               F32_WIDE_TOL) and f64, and on a B=2, T=10 one with the
               wrench cones; K3 and K4 at Talos widths (nx=56, nu=34);
               times, bounds, registers and stack (phase_talos_kernels).
 14. talos_batched — 30 one-iteration solves of B=128 Talos T=100 problems,
               f32, from the committed fixture's point perturbed: last max
               prim_res < 5e-4; solves/s.
 15. talos_fixture — f32 re-solve of Talos T=100 against
               talos_kinodynamics_T100.npz to the f32 floor: max|Δu| <=
               3e-3, max|Δx| <= 1e-3; the fixture generator's f64 solve on
               the card: max|Δu| <= 1e-4 (phase_talos_fixture).
 16. talos_mpc — the host MPC on Talos T=100 (examples/talos_kinodynamics.py's
               biped gait and MPC settings), f32, 30 self-fed ticks: finite,
               no divergence; tick p50/p99 and one tick's trace.
 17. talos_id_sim_kernels — (after phase 13) the Talos closed loop's
               kernels against their twins at B=1 and B=128, f32 and f64:
               wide_id_assemble (csrc/id_wide.cu: 6D wrenches, wrench
               cones), qp_admm at n=40, m=98 and 110, wide_sim_step
               (csrc/sim_wide.cu, 23 joints), on perturbed Talos states with
               one foot lifted and with the pulling contacts dropped, and
               K11 state_derivative (csrc/acc.cu, Go2) and
               wide_state_derivative (csrc/acc_wide.cu, Talos) on perturbed
               lanes; f32 gated against the twin in f64 at F32_TALOS_TOL.
 18. talos_closed_loop — the port's examples/talos_kinodynamics.py on the
               card, f32, uncut (T=100, the biped gait at 0.1 m/s, the
               example's ID with 6D feet and 60 ADMM steps, simulator dt
               1e-3, 10 inner steps a tick), 30 MPC ticks: the JAX
               package's smoke gate (finite, base z within 0.1 m of its
               start); loop_readings as phase 12.
 19. line_search_kernels — (after phase 17) the rest of K4
               (csrc/linesearch.cu and its wide instance):
               candidate_integrate, line_search_select and
               state_difference against their twins on one iteration's
               real candidates of Go2 kinodynamics, Go2 full dynamics and
               Talos at B=128, T=100, f32 and f64 (f64 within 1e-10 and the
               same step sizes; f32 within F32_LS_TOL of the f64 twin on the
               same inputs, another step size than the f64 twin's only at
               a merit tie within f32 roundoff); then the device kernels
               one solver iteration launches at B=1 (at most 16), from a
               profiler trace.
 20. tick_traces — (with --phases only) profiler readings of one tick of
               each B=1 path, for holding two trees against each other.
Phases 4-10, 12, 14-16 and 18 drive the main paths; every solver call
launches state_difference once and candidate_integrate and
line_search_select once an iteration (its wide instance on Talos).  The
kernels' launch counters are zeroed just before each of them (after the
latency engine's and the closed loop's set-up, whose first solves run
before the path) and read just after (a `<phase>_launches` line): each
must have launched every kernel it runs (phase 7 the nine of the serial
tick; phase 8 the same with K6 in place of K3, and K3 never; phases 9-10
the full-dynamics stage kernels and never the kinodynamics ones; phases 12
and 18 the eight solver kernels exactly once a tick, the three inner
kernels exactly once an inner step and the state derivative exactly twice
a tick, phase 18 the wide ones of each and never the Go2 ones; phases
14-16 the four wide kernels, K3 and K4's rollout, integrate and initial
gap, and never the Go2 stage kernels; no Go2 phase a wide kernel).  The kernel
summary's `launches` is the sum over those twelve runs; the launches of
phases 3, 11, 13, 17 and 19 and of phases 12's and 18's timings are not
counted.  Its `bound_ms` is the larger of the bytes each
kernel moves (inputs read once, outputs written once, at the summary's
shape) over 3.35 TB/s and its counted FLOPs over 67 TFLOP/s (H100 SXM,
FP32 outside the tensor cores); FLOPs of the rigid-body arithmetic of K1,
K2, K5 and K9 are not counted, so their bounds are lower bounds; K6's
count holds the combines a work-efficient scan needs, not the 3.0 times as
many of its own Hillis-Steele schedule.  No single PyTorch call computes
any of these functions (`library_ms` null).  The second-to-last lines are
the kernel summary (JSON) and nvidia-smi's name/power limit; the last line
is {"ok": true, "device": {...}}.  The full-dynamics kernels' bounds count
the Gauss-Newton products and K7's factorizations and solves (once in
primal and once along each tangent direction), not the kinematics, CRBA or
bias torques.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T = 100
B = 128
ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.1)
# f32 full-dynamics kernels vs their twin in f64 (see phase_fd_kernels)
F32_FD_TOL = 3e-4
PYRAMID_CALLS = 4  # calls (ticks) of the fd phases' 68-row runs (prim printed, not gated)
REPS = 20
SLOW_REPS = 3  # the torch.func twins of K1+K2 and K5 and the f64 twin of K3
# the kernels each path of the main path must launch, and must not
# K4 after the rollout: once a solve before its iterations
# (state_difference) and once an iteration (the other two)
LS_KERNELS = ("candidate_integrate", "line_search_select", "state_difference")
SOLVER_KERNELS = ("stage_linearize", "stage_eval", "riccati_backward", "linear_rollout",
                  "term_linearize") + LS_KERNELS
LATENCY_KERNELS = ("stage_linearize", "stage_eval", "parallel_riccati_backward",
                   "linear_rollout", "term_linearize", "tick_refs") + LS_KERNELS
FD_SOLVER_KERNELS = ("fd_stage_linearize", "fd_stage_eval", "riccati_backward",
                     "linear_rollout", "term_linearize") + LS_KERNELS
# the Lie integrate and the difference read nq and nv alone: one kernel
# each serves every model; the line search's terminal cost reads the model
WIDE_KERNELS = ("wide_stage_linearize", "wide_stage_eval", "wide_term_linearize",
                "wide_line_search_select")
TALOS_SOLVER_KERNELS = WIDE_KERNELS + ("riccati_backward", "linear_rollout",
                                       "candidate_integrate", "state_difference")
GO2_STAGE_KERNELS = ("stage_linearize", "stage_eval", "term_linearize", "line_search_select")
PATH_KERNELS = dict(batched=SOLVER_KERNELS, fixture=SOLVER_KERNELS, mpc=SOLVER_KERNELS,
                    fused=SOLVER_KERNELS + ("tick_refs",), latency=LATENCY_KERNELS,
                    fd_batched=FD_SOLVER_KERNELS,
                    fd_mpc=FD_SOLVER_KERNELS + ("fd_dynamics",),
                    talos_batched=TALOS_SOLVER_KERNELS, talos_fixture=TALOS_SOLVER_KERNELS,
                    talos_mpc=TALOS_SOLVER_KERNELS)
CLOSED_LOOP_T = 50  # examples/go2_kinodynamics.py's horizon
CLOSED_LOOP_TICKS = 160  # tests/test_walking.py:181
TALOS_LOOP_T = 100  # examples/talos_kinodynamics.py's horizon
TALOS_LOOP_TICKS = 30  # tests/test_examples_smoke.py:36-40 runs 25
# the closed loops' kernels: the inner step's ID and simulator (10 a tick)
# and the tick's two state derivatives
INNER_KERNELS = ("id_assemble", "qp_admm", "sim_step")
TALOS_INNER_KERNELS = ("wide_id_assemble", "qp_admm", "wide_sim_step")
WIDE_LOOP_KERNELS = ("wide_id_assemble", "wide_sim_step", "wide_state_derivative")
PATH_KERNELS["closed_loop"] = SOLVER_KERNELS + INNER_KERNELS + ("state_derivative",)
PATH_KERNELS["talos_closed_loop"] = (TALOS_SOLVER_KERNELS + TALOS_INNER_KERNELS
                                     + ("wide_state_derivative",))


def loop_launches(solver, inner, refs, ticks):
    """Launches of a closed-loop run: each tick's MPC iteration launches
    each solver kernel once, each inner step each inner kernel once, and
    each tick's references the state derivative twice."""
    return {**dict.fromkeys(solver, ticks), **dict.fromkeys(inner, 10 * ticks),
            refs: 2 * ticks}


PATH_EXACT = dict(
    closed_loop=loop_launches(SOLVER_KERNELS, INNER_KERNELS, "state_derivative",
                              CLOSED_LOOP_TICKS),
    talos_closed_loop=loop_launches(TALOS_SOLVER_KERNELS, TALOS_INNER_KERNELS,
                                    "wide_state_derivative", TALOS_LOOP_TICKS))
_LOOP_ABSENT = ("parallel_riccati_backward", "tick_refs", "fd_stage_linearize", "fd_stage_eval",
                "fd_dynamics")
PATH_ABSENT = dict(latency=("riccati_backward",),
                   fd_batched=("stage_linearize", "stage_eval"),
                   fd_mpc=("stage_linearize", "stage_eval"),
                   closed_loop=_LOOP_ABSENT,
                   talos_batched=GO2_STAGE_KERNELS, talos_fixture=GO2_STAGE_KERNELS,
                   talos_mpc=GO2_STAGE_KERNELS,
                   talos_closed_loop=GO2_STAGE_KERNELS + _LOOP_ABSENT
                   + ("id_assemble", "sim_step", "state_derivative"))
# no Go2 path launches a wide kernel
for _path in ("batched", "fixture", "mpc", "fused", "latency", "fd_batched", "fd_mpc",
              "closed_loop"):
    PATH_ABSENT[_path] = PATH_ABSENT.get(_path, ()) + WIDE_KERNELS + WIDE_LOOP_KERNELS
FD_MPC_T = 50  # examples/go2_fulldynamics.py's horizon
TALOS_CONE_B, TALOS_CONE_T = 2, 10  # the wrench-cone case of phase_talos_kernels
# most multiplier rounds of the Talos f32 fixture re-solve: two
# (phase_fixture's recipe) leave the f32 iterate short of its floor
# (max|us - us*| 4.18e-3 after two rounds, 1.28e-3 at its fixed point after
# five, on an NVIDIA H100 80GB HBM3 at 700 W; JAX's own f32 pass on a CPU
# 4.6e-3 after two, tests/test_torch_talos_fixture.py)
TALOS_F32_ROUNDS = 8
# f32 line-search kernels vs their twin in f64 on the same inputs (see
# phase_line_search_kernels): ten times the f32 twin's own distance from
# the f64 twin in that phase's recipe (ls_f32_readings with the twins on the
# CPU, ls_case at B=128, T=100: candidate_integrate 4.25e-8, 3.97e-8 and
# 7.26e-8, state_difference 1.11e-7, 1.01e-7 and 9.41e-8,
# line_search_select 1.09e-7, 8.15e-8 and 1.32e-7 for Go2, full dynamics
# and Talos), and "tie" ten times the f32 twin's largest relative merit
# distance there (2.61e-7, 2.07e-7 and 1.79e-7): the kernel may pick another
# step size than the f64 twin only where their merits lie that close
F32_LS_TOL = dict(go2=dict(candidate_integrate=4.3e-7, state_difference=1.2e-6,
                           line_search_select=1.1e-6, tie=2.7e-6),
                  fd=dict(candidate_integrate=4.0e-7, state_difference=1.1e-6,
                          line_search_select=8.2e-7, tie=2.1e-6),
                  talos=dict(candidate_integrate=7.3e-7, state_difference=9.5e-7,
                             line_search_select=1.4e-6, tie=1.8e-6))
# f32 wide stage kernels vs their twin in f64 (see phase_talos_kernels): about
# ten times the f32 twin's own distance from the f64 twin in that phase's
# recipe (CPU, B=4, T=100 and the cone case: 5.4e-6, 1.9e-7 and 4.5e-5, the
# candidates' gaps and costs losing most)
F32_WIDE_TOL = dict(wide_stage_linearize=5e-5, wide_term_linearize=2e-6,
                    wide_stage_eval=5e-4)
# f32 closed-loop kernels vs their twin in f64 (see phase_id_sim_kernels)
F32_ID_TOL = 1e-6
F32_QP_TOL = 2e-2
F32_SIM_TOL = 1e-5
# f32 Talos closed-loop kernels and K11 vs their twin in f64 (see
# phase_id_sim_kernels): ten times the f32 twin's own distance from the
# f64 twin in that phase's recipe
# (CPU, B=1 and 128: 6.5e-7, 6.4e-2 on z and y, 4.5e-5, 2.4e-6 and 1.6e-6;
# the f32 ADMM at Talos's 40 variables and forces of ~450 N keeps little)
F32_TALOS_TOL = dict(wide_id_assemble=6.5e-6, qp_admm=6.4e-1, wide_sim_step=4.5e-4,
                     state_derivative=2.4e-5, wide_state_derivative=1.6e-5)
# H100 SXM peaks from NVIDIA's datasheet: FP32 outside the tensor
# cores, and HBM
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(a, b):
    """max|a - b| / max|b| (float64 on the host)."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def cuda_ms(fn, reps):
    """Median over `reps` launches of fn, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nbytes(x):
    """Bytes of every tensor in x (a tensor, dict, tuple or NamedTuple)."""
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(nbytes(v) for v in x)
    return 0


def roofline(flops, moved):
    """(bound_ms, bound_by): the least time for `flops` FP32 operations and
    `moved` bytes of device memory traffic."""
    t_ops, t_mem = flops / F32_FLOPS, moved / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops > t_mem else "bytes"


def scan_combines(n):
    """Combines a work-efficient scan of n elements needs, counted as
    `lax.associative_scan` recurses: 191 at n = T+1 = 101.  K6's
    Hillis-Steele schedule does 580 there, 3.0 times as many; the bound
    counts only what the function needs."""
    if n < 2:
        return 0
    return n // 2 + scan_combines(n // 2) + (n // 2 - 1 if n % 2 == 0 else n // 2)


def riccati_flops(nb, nT, nx, nu):
    """K3: gap folding, Q = stage + [A B]' V [A B], the 24x24 Cholesky and
    solve, the explicit value update."""
    nz, nr = nx + nu, nx + 1
    stage = (2 * nx * nx + 2 * nx * nx * nz + 2 * nx * nz * nz + 2 * nx * nz
             + nu ** 3 / 3 + 4 * nu * nu * nr + 4 * nu * nx * nr + 2 * nu * nx)
    return nb * nT * stage


def parallel_riccati_flops(nb, nT, nx, nu):
    """K6: elimination and gains a stage, and each combine's two 36x36 LU
    solves and seven 36x36x36 products, over the combines of a
    work-efficient scan of the T+1 elements."""
    n = nx
    elim = (nu ** 3 / 3 + 2 * nu * nu * (2 * nx + 1) + 6 * nu * nx * nx
            + 4 * nu * nx)
    gains = (2 * nx * nx + 2 * nx * nu + 4 * nu * nx * nx + 2 * nu * nu * nx
             + nu ** 3 / 3 + 2 * nu * nu * (nx + 1))
    comb = (14 * n ** 3 + 4 * n ** 3 / 3 + 2 * n * n * (2 * n + 1)
            + 2 * n * n * (n + 1) + 8 * n * n)
    return nb * (nT * (elim + gains) + scan_combines(nT + 1) * comb)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def phase(name, t0, **fields):
    line = {"phase": name, "seconds": round(time.perf_counter() - t0, 3), **fields}
    print(json.dumps(line), flush=True)


def profile_kernels(fn, n):
    """(device kernel events, wall ms a call) of n calls of fn() under
    torch.profiler, read back from its chrome trace (written under
    simple_mpc_tpu_torch/_build/)."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(ROOT, "simple_mpc_tpu_torch", "_build", "trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
    prof.export_chrome_trace(path)
    with open(path) as fh:
        ev = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"]
    return ev, wall


def call_kernels(fn, warm=2):
    """The device kernels one call of fn() launches, from a profiler trace:
    the kernel events whose launch (a runtime or driver API event with the
    same correlation id) lies inside a record_function window around the
    call, made after `warm` calls under the same profiler (a trace may miss
    kernel events, at its start most of all; it adds none)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path = os.path.join(ROOT, "simple_mpc_tpu_torch", "_build", "trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with record_function("counted_call"):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    win = [e for e in ev if e.get("name") == "counted_call" and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    check(len(win) == 1, f"call_kernels: {len(win)} counted_call windows in the trace")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    launched = {e["args"]["correlation"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and lo <= e["ts"] <= hi
                and "correlation" in e.get("args", {})}
    return sum(1 for e in ev if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched)


def k6_kernel_ms(ev, nT, n):
    """Medians of the device ms of K6's eliminate, its scan levels (summed)
    and gains, over the calls of n whose launches the trace holds in full
    (the profiler may drop a few events), and how many those were."""
    levels = nT.bit_length()  # ceil(log2(T+1))
    seq = sorted((e for e in ev if any(f"{k}_kernel" in e["name"] for k in
                                       ("eliminate", "combine", "gains"))),
                 key=lambda e: e["ts"])
    calls = []
    for i in range(len(seq) - levels - 1):
        w = [e["name"] for e in seq[i:i + levels + 2]]
        if ("eliminate_kernel" in w[0] and "gains_kernel" in w[-1]
                and all("combine_kernel" in x for x in w[1:-1])):
            d = [e["dur"] for e in seq[i:i + levels + 2]]
            calls.append((d[0], sum(d[1:-1]), d[-1]))
    check(2 * len(calls) >= n, f"the trace holds {len(calls)} of {n} K6 calls in full")
    med = np.median(np.asarray(calls), axis=0) / 1e3
    return dict(eliminate=float(med[0]), combine=float(med[1]), gains=float(med[2]),
                calls=len(calls))


def trace_calls(fn, n=5):
    """Device work of n calls of fn() from a torch.profiler trace: kernels,
    device-busy ms and wall ms a call, the idle share, and the ms a call of
    K3's and K6's device kernels.  The profiler slows the host, so the idle
    share is an upper bound."""
    ev, wall = profile_kernels(fn, n)

    def ms(*parts):
        return sum(e["dur"] for e in ev if any(p in e["name"] for p in parts)) / 1e3 / n

    busy = ms("")
    return dict(kernels_per_call=len(ev) / n, device_busy_ms=busy, wall_ms=wall,
                idle_share=1.0 - busy / wall, k3_ms=ms("riccati_backward_kernel"),
                k6_ms=ms("eliminate_kernel", "combine_kernel", "gains_kernel"))


def standing_case(device, dtype, seed):
    """Go2 T=100 standing problem batched B times, with a perturbed warm
    start made from numpy with a fixed seed."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None, None], B, 0).repeat(T + 1, 1)
    xs = xs + 0.01 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = ocp.get_reference_control(0).double().cpu().numpy()
    us = np.repeat(u0[None, None], B, 0).repeat(T, 1) + rng.normal(size=(B, T, ocp.nu))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return ocp, tile_problem(ocp.problem, B), t(xs), t(us)


def fused_engine(device, dtype=torch.float32, parallel=False):
    """The bench's fused-tick configuration (bench.py:277-311) on the card:
    Go2 T=100, trot 10/30/10/30 at 0.2 m/s, apex 0.15 m, one iteration a
    tick with mu_init 1e-6; serial Riccati, or K6 with `parallel`.  Returns
    (fused, carry)."""
    from simple_mpc_tpu_torch.configs import make_go2_fused

    return make_go2_fused(T, device=device, dtype=dtype, parallel=parallel)


def phase_kernels(device):
    """Every kernel against its twin on the card; f32 and f64.  Returns,
    per dtype, each kernel's errors, times (kernel, twin) and roofline bound
    at the shape the summary reports (K6: the latency path's B=1)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings
    from simple_mpc_tpu_torch.testing import random_lq

    out = {}
    fused, carry1 = fused_engine(device)
    for dtype, tol_lin, tol_k3, tol_k4, tol_eval, tol_tick, tol_k6 in (
            (torch.float32, 1e-4, 1e-4, 1e-5, 1e-5, 1e-6, 1e-3),
            (torch.float64, 1e-10, 1e-10, 1e-10, 1e-10, 1e-12, 1e-10)):
        t0 = time.perf_counter()
        ocp, probs, xs, us = standing_case(device, dtype, seed=3)
        solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, alphas=ALPHAS))
        eps = torch.finfo(dtype).eps
        mu = torch.full((B,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
        lam_eq = torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device)
        lam_in = torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device)
        lam_term = torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device)
        sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
        tp = tree_map(torch.Tensor.contiguous, probs.term_params)
        xT = xs[:, -1]
        reg = max(solver.settings.reg_init, 50 * eps)
        nx, nu = solver.space.ndx, ocp.nu
        dx0 = solver.space.difference(xs[:, 0], probs.x0)
        alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=device)
        errs, abs_err, times = {}, {}, {}

        def compare(name, got, want, tol):
            e = [rel_err(a, b) for a, b in zip(got, want)]
            check(all(np.isfinite(e)) and max(e) <= tol,
                  f"{name} {dtype}: rel err {max(e):.3e} > {tol}")
            check(all(torch.isfinite(a).all() for a in got), f"{name} {dtype}: non-finite")
            errs[name] = max(e)
            abs_err[name] = max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(got, want))

        # K1+K2 and K5
        lin = kernels.stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
        lin0 = kernels._linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
        compare("stage_linearize", [lin[k] for k in kernels.LIN_KEYS],
                [lin0[k] for k in kernels.LIN_KEYS], tol_lin)
        term = kernels.term_linearize(solver, xT, tp, lam_term, mu)
        Vx, Vxx = kernels._linearize_term_plain(solver, xT, tp, lam_term, mu)
        compare("term_linearize", term, (Vx, Vxx), tol_lin)
        # K3 and K4 on the twins' linearization
        ks, Ks, dual = kernels.riccati_backward(lin0, Vx, Vxx, reg)
        ks0, Ks0, Qus0 = kernels.riccati_backward_plain(lin0, Vx, Vxx, reg)
        compare("riccati_backward", (ks, Ks, dual),
                (ks0, Ks0, Qus0.abs().amax(dim=(1, 2))), tol_k3)
        roll_args = (lin0["A"], lin0["B"], lin0["d"], ks0, Ks0, dx0, alphas)
        dxs, dus = kernels.linear_rollout(*roll_args)
        compare("linear_rollout", (dxs, dus), kernels.linear_rollout_plain(*roll_args), tol_k4)
        # K1 on the candidates of that step
        xs_c, us_c = solver._candidates(xs, us, lin0, ks0, Ks0, dx0, alphas)
        eval_args = (solver, sp, xs_c, us_c, lam_eq, lam_in, mu)
        compare("stage_eval", kernels.stage_eval(*eval_args),
                kernels._eval_traj_plain(*eval_args), tol_eval)
        # K9 on B carries of the fused engine, perturbed measurements
        cb = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                      fused.tile_carry(carry1, B))
        rng = np.random.default_rng(7)
        x_meas = cb.xs[:, 0] + torch.as_tensor(0.01 * rng.normal(size=(B, cb.xs.shape[-1])),
                                               dtype=dtype, device=device)
        x_meas[:, 3:7] /= x_meas[:, 3:7].norm(dim=-1, keepdim=True)
        cb = cb._replace(velocity_base=cb.velocity_base + torch.as_tensor(
            0.1 * rng.normal(size=(B, 6)), dtype=dtype, device=device))
        got = kernels.tick_refs(fused, cb, x_meas)
        want = kernels.tick_refs_plain(fused, cb, x_meas)
        for k in ("walking", "takeoff", "land"):
            check(torch.equal(getattr(got, k), getattr(want, k)),
                  f"tick_refs {dtype}: {k} differs from the twin")
        compare("tick_refs", got[3:], want[3:], tol_tick)

        # K6 at B=128 and at the latency path's B=1.  Its arithmetic is held
        # to the twin on LQ data of the main path's shapes and structure,
        # where the function is well conditioned (ks and Ks within tol_k6).
        # On the Go2 linearization the function itself is ill conditioned
        # (Quu + reg I without Jacobi scaling; AL weights 1/mu): in f64 the
        # kernel must agree with the twin within 10x the twin's own response
        # to a 1e-15 relative perturbation of its inputs; in f32 the kernel's
        # and the twin's distances to the twin in f64 on the same inputs are
        # printed and not gated (JAX's own f32 `parallel_backward` is 10-13 %
        # off there, tests/test_torch_parallel_riccati.py).
        k6 = {}
        lin1 = {k: v[:1].contiguous() for k, v in lin0.items()}
        g64 = torch.Generator(device=device).manual_seed(0)
        for nb, args in ((B, (lin0, Vx, Vxx)), (1, (lin1, Vx[:1].contiguous(),
                                                    Vxx[:1].contiguous()))):
            lq = random_lq(nb, T, nx, nu, dtype, device, seed=nb)[:3]
            got6 = kernels.parallel_riccati_backward(*lq, reg)
            ks6, Ks6, Qus6 = kernels.parallel_riccati_backward_plain(*lq, reg)
            want6 = (ks6, Ks6, Qus6.abs().amax(dim=(1, 2)))
            e6 = dict(zip(("ks", "Ks", "dual"), (rel_err(a, b) for a, b in zip(got6, want6))))
            check(all(torch.isfinite(a).all() for a in got6),
                  f"parallel_riccati_backward B={nb} {dtype}: non-finite")
            check(max(e6["ks"], e6["Ks"]) <= tol_k6,
                  f"parallel_riccati_backward B={nb} {dtype}: rel err {e6} > {tol_k6}")

            go2_k = kernels.parallel_riccati_backward(*args, reg)[:2]
            go2_t = kernels.parallel_riccati_backward_plain(*args, reg)[:2]
            check(all(torch.isfinite(a).all() for a in go2_k),
                  f"parallel_riccati_backward B={nb} {dtype}: non-finite on the Go2 data")
            if dtype == torch.float32:
                lin64 = {k: v.double() for k, v in args[0].items()}
                ref = kernels.parallel_riccati_backward_plain(
                    lin64, args[1].double(), args[2].double(), reg)[:2]
                go2 = dict(kernel_vs_f64=max(rel_err(a, b) for a, b in zip(go2_k, ref)),
                           twin_vs_f64=max(rel_err(a, b) for a, b in zip(go2_t, ref)),
                           kernel_vs_twin=max(rel_err(a, b) for a, b in zip(go2_k, go2_t)))
            else:
                noisy = {k: v * (1 + 1e-15 * torch.randn(v.shape, generator=g64, dtype=dtype,
                                                         device=device))
                         for k, v in args[0].items()}
                spread = kernels.parallel_riccati_backward_plain(noisy, *args[1:], reg)[:2]
                go2 = dict(kernel_vs_twin=max(rel_err(a, b) for a, b in zip(go2_k, go2_t)),
                           twin_spread=max(rel_err(a, b) for a, b in zip(spread, go2_t)))
                check(go2["kernel_vs_twin"] <= 10 * go2["twin_spread"] + 1e-12,
                      f"parallel_riccati_backward B={nb} f64 on the Go2 data: {go2}")
            ev, _ = profile_kernels(lambda: kernels.parallel_riccati_backward(*args, reg),
                                    REPS)
            k6[nb] = dict(
                rel_err=e6, max_abs_err=max(float((a.double() - b.double()).abs().max())
                                            for a, b in zip(got6, want6)),
                go2=go2,
                ms=cuda_ms(lambda: kernels.parallel_riccati_backward(*args, reg), REPS),
                plain_ms=cuda_ms(lambda: kernels.parallel_riccati_backward_plain(*args, reg),
                                 REPS),
                # profiler medians of its three device kernels (the scan's
                # levels summed)
                device_ms=k6_kernel_ms(ev, T, REPS))
        errs["parallel_riccati_backward"] = max(k6[1]["rel_err"].values())
        abs_err["parallel_riccati_backward"] = k6[1]["max_abs_err"]

        slow = SLOW_REPS
        times = dict(
            stage_linearize=(
                cuda_ms(lambda: kernels.stage_linearize(solver, sp, xs, us, lam_eq,
                                                        lam_in, mu), REPS),
                cuda_ms(lambda: kernels._linearize_traj_plain(solver, sp, xs, us, lam_eq,
                                                              lam_in, mu), slow)),
            term_linearize=(
                cuda_ms(lambda: kernels.term_linearize(solver, xT, tp, lam_term, mu), REPS),
                cuda_ms(lambda: kernels._linearize_term_plain(solver, xT, tp, lam_term,
                                                              mu), slow)),
            riccati_backward=(
                cuda_ms(lambda: kernels.riccati_backward(lin0, Vx, Vxx, reg), REPS),
                cuda_ms(lambda: kernels.riccati_backward_plain(lin0, Vx, Vxx, reg), slow)),
            linear_rollout=(cuda_ms(lambda: kernels.linear_rollout(*roll_args), REPS),
                            cuda_ms(lambda: kernels.linear_rollout_plain(*roll_args), REPS)),
            stage_eval=(cuda_ms(lambda: kernels.stage_eval(*eval_args), REPS),
                        cuda_ms(lambda: kernels._eval_traj_plain(*eval_args), REPS)),
            tick_refs=(cuda_ms(lambda: kernels.tick_refs(fused, cb, x_meas), REPS),
                       cuda_ms(lambda: kernels.tick_refs_plain(fused, cb, x_meas), REPS)),
        )
        times["parallel_riccati_backward"] = (k6[1]["ms"], k6[1]["plain_ms"])
        n_rows = ocp._const(xs)["w"].shape[0] + ocp.n_eq + ocp.n_in
        n_term = ocp._const(xs)["w_term"].shape[0] + ocp.n_term_eq
        na = alphas.shape[0]
        # per scenario: (counted FLOPs, bytes read and written) of each kernel
        # at this run's shapes; every input and output leads with the
        # scenario axis but K4's step sizes (40 bytes)
        per = dict(
            stage_linearize=(T * 2 * n_rows * (nx * nx + nu * nu + nu * nx + nx + nu),
                             nbytes((sp, xs, us, lam_eq, lam_in, mu, lin))),
            term_linearize=(2 * n_term * (nx * nx + nx), nbytes((xT, tp, lam_term, mu, term))),
            riccati_backward=(riccati_flops(1, T, nx, nu),
                              nbytes((lin0, Vx, Vxx, ks0, Ks0, Qus0))),
            parallel_riccati_backward=(parallel_riccati_flops(1, T, nx, nu),
                                       nbytes((lin0, Vx, Vxx, ks0, Ks0, Qus0))),
            linear_rollout=(na * T * (4 * nu * nx + 2 * nx * nx + 2 * nu + 2 * nx),
                            nbytes((roll_args, dxs, dus))),
            stage_eval=(0, nbytes((sp, xs_c, us_c, lam_eq, lam_in, mu,
                                   kernels.stage_eval(*eval_args)))),
            tick_refs=(0, nbytes((x_meas, cb.stage_params.contact_active[:, T - 1], cb.now,
                                  cb.plan, cb.takeoff, cb.land, cb.p_init, cb.p_final,
                                  cb.velocity_base, cb.com0_z, got))),
        )
        per = {k: (f, m / B) for k, (f, m) in per.items()}
        bounds = {nb: {k: roofline(f * nb, m * nb) for k, (f, m) in per.items()}
                  for nb in (B, 1)}
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times,
                         bounds={k: bounds[1 if k == "parallel_riccati_backward" else B][k]
                                 for k in per})
        phase(f"kernels_{name}", t0, B=B, T=T, rel_err=errs, max_abs_err=abs_err,
              ms_kernel_vs_plain=times,
              # the peaks are the FP32 ones
              bound_ms={f"B{nb}": b for nb, b in bounds.items()} if dtype == torch.float32
              else None,
              parallel_riccati_backward={f"B{nb}": r for nb, r in k6.items()})
    return out


def fd_case(device, dtype, seed):
    """Go2 full-dynamics T=100 standing problem (all 68 inequality rows)
    batched B times, with a perturbed warm start (states and torques) and
    positive inequality multipliers, made from numpy with a fixed seed."""
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = make_go2_fulldynamics(T, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None, None], B, 0).repeat(T + 1, 1)
    xs = xs + 0.01 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = rng.normal(size=(B, T, ocp.nu))
    lam_in = 0.1 * np.abs(rng.normal(size=(B, T, ocp.n_in)))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return ocp, tile_problem(ocp.problem, B), t(xs), t(us), t(lam_in)


def standing_torques(ocp, x0):
    """Joint torques that hold the configuration x0 at rest on all its feet
    (numpy, float64), the quasistatic warm start of the JAX package's
    full-dynamics fixture (`tools/make_parity_fixtures.py`
    `_quasistatic_torques`): with v = 0 and ddq = 0 the dynamics
    M ddq = [0; tau] - b + Jc^T f leave Jc^T f = b - [0; tau]; the base rows
    fix the contact forces nearest the force references f_ref, the joint
    rows then give tau."""
    from simple_mpc_tpu_torch.ops import soa, soa_dyn

    m = ocp.model
    q = torch.as_tensor(np.asarray(x0[: ocp.nq], np.float64))[:, None]
    v = torch.zeros((m.nv, 1), dtype=torch.float64)
    oR, op = soa.fk_world(m, q)
    Sw = soa.world_axes(m, oR, op)
    b = soa_dyn.nle_world(m, oR, op, Sw, soa.body_velocities(m, Sw, v), v)[:, 0]
    J = soa_dyn.contact_jacobians(m, oR, op, Sw, ocp.feet_fids, 3)[0][..., 0]  # (3 nk, nv)
    f_ref = ocp.problem.stage_params.f_ref[0].reshape(-1).to("cpu", torch.float64)
    Jb = J[:, :6].T
    f = f_ref + torch.linalg.pinv(Jb) @ (b[:6] - Jb @ f_ref)
    return (b[6:] - J[:, 6:].T @ f).numpy()


def k7_flops(nv, nc):
    """Counted FLOPs of K7's factorizations and solves on one lane: the
    Cholesky of M, the (nc + 1)-column solve, the Delassus product (lower
    triangle), its Cholesky and solve, ddq.  The kinematics, the CRBA and the
    bias torques are not counted."""
    return (nv ** 3 / 3 + 2 * nv * nv * (nc + 1) + nc * (nc + 1) * nv + nc ** 3 / 3
            + 2 * nc * nc + 2 * nv * nc)


def as64(args):
    """The arguments with every floating tensor (in param tuples too) in
    f64."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    def leaf(a):
        return a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    return tuple(tree_map(leaf, a) for a in args)


def phase_fd_kernels(device):
    """The full-dynamics kernels against their twins on the card, at the
    full-dynamics main path's shapes (Go2 T=100, B=128, perturbed standing
    problem), f32 and f64: fd_stage_linearize with u_scale None and "auto",
    fd_stage_eval on the candidates of one step, fd_dynamics on the B*T
    lanes and on the one lane `MPC.get_contact_forces` gives it.  Gates, as
    max|a - b| / max|b|: in f64 the kernel within 1e-10 of the twin; in f32
    the kernel within F32_FD_TOL = 3e-4 of the twin evaluated in f64 on the
    same (f32-rounded) inputs.  The f32 linearization loses ~1e-4 of A
    through the two KKT solves whoever evaluates it: on this data (seed 5;
    NVIDIA H100 80GB HBM3, 700 W) the kernel reads 1.2e-4 to 1.34e-4 from
    the f64 twin and the f32 twin 2.94e-4, so a fixed 1e-4 between two f32
    evaluations measures the function's conditioning, not the kernel.
    3e-4 leaves the kernel twice its readings and is about the plain f32
    twin's own distance; the
    f32 twin's distance and the kernel-vs-f32-twin distance are printed
    beside it."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    out = {}
    for dtype, tol in ((torch.float32, F32_FD_TOL), (torch.float64, 1e-10)):
        t0 = time.perf_counter()
        ocp, probs, xs, us, lam_in = fd_case(device, dtype, seed=5)
        eps = torch.finfo(dtype).eps
        mu = torch.full((B,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
        lam_eq = torch.zeros((B, T, 0), dtype=dtype, device=device)
        lam_term = torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device)
        sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
        tp = tree_map(torch.Tensor.contiguous, probs.term_params)
        alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=device)
        errs, abs_err, times, vs64 = {}, {}, {}, {}
        f32 = dtype == torch.float32

        def compare(name, got, want, want64=None):
            """Kernel `got` against its twin `want`; in f32 also against the
            twin in f64 on the same inputs, `want64`."""
            keep = [i for i, b in enumerate(want) if b.numel()]
            e = [rel_err(got[i], want[i]) for i in keep]
            check(all(torch.isfinite(got[i]).all() for i in keep), f"{name} {dtype}: non-finite")
            if want64 is None:
                check(all(np.isfinite(e)) and max(e) <= tol,
                      f"{name} {dtype}: rel err {max(e):.3e} > {tol}")
            else:
                e_twin = max(rel_err(want[i], want64[i]) for i in keep)
                e_kern = max(rel_err(got[i], want64[i]) for i in keep)
                check(np.isfinite(e_kern) and e_kern <= F32_FD_TOL,
                      f"{name} {dtype}: {e_kern:.3e} from the f64 twin > {F32_FD_TOL:.1e}"
                      f" (f32 twin: {e_twin:.3e})")
                old = vs64.get(name, (0.0, 0.0))
                vs64[name] = (max(old[0], e_kern), max(old[1], e_twin))
            errs[name] = max([errs.get(name, 0.0)] + e)
            abs_err[name] = max([abs_err.get(name, 0.0)] + [
                float((got[i].double() - want[i].double()).abs().max()) for i in keep])

        # (a) K7 + K1 + K2, without and with control scaling
        for su in (None, "auto"):
            solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, alphas=ALPHAS,
                                                       u_scale=su))
            lin_args = (solver, sp, xs, us, lam_eq, lam_in, mu)
            lin = kernels.fd_stage_linearize(*lin_args)
            lin0 = kernels._linearize_traj_plain(*lin_args)
            lin64 = (kernels._linearize_traj_plain(*as64(lin_args)) if f32
                     else None)
            compare("fd_stage_linearize", [lin[k] for k in kernels.LIN_KEYS],
                    [lin0[k] for k in kernels.LIN_KEYS],
                    lin64 and [lin64[k] for k in kernels.LIN_KEYS])
        # (b) K7 + K1 on the candidates of the twins' step (u_scale "auto")
        Vx, Vxx = kernels._linearize_term_plain(solver, xs[:, -1], tp, lam_term, mu)
        reg = max(solver.settings.reg_init, 50 * eps)
        ks0, Ks0, _ = kernels.riccati_backward_plain(lin0, Vx, Vxx, reg)
        dx0 = solver.space.difference(xs[:, 0], probs.x0)
        xs_c, us_c = solver._candidates(xs, us, lin0, ks0, Ks0, dx0, alphas)
        eval_args = (solver, sp, xs_c, us_c, lam_eq, lam_in, mu)
        compare("fd_stage_eval", kernels.fd_stage_eval(*eval_args),
                kernels._eval_traj_plain(*eval_args),
                kernels._eval_traj_plain(*as64(eval_args)) if f32 else None)
        # (c) K7 alone: every stage's lane, and the one lane of the MPC's
        # get_contact_forces
        x_all = xs[:, :-1].reshape(B * T, -1).contiguous()
        u_all = us.reshape(B * T, -1).contiguous()
        p_all = tree_map(lambda a: a.reshape((B * T,) + a.shape[2:]).contiguous(), sp)
        dyn_args = (ocp, x_all, u_all, p_all)
        one = (ocp, x_all[:1], u_all[:1], tree_map(lambda a: a[:1], p_all))
        for args in (dyn_args, one):
            compare("fd_dynamics", kernels.fd_dynamics(*args), kernels.fd_dynamics_plain(*args),
                    kernels.fd_dynamics_plain(*as64(args)) if f32 else None)

        slow = SLOW_REPS
        times = dict(
            fd_stage_linearize=(cuda_ms(lambda: kernels.fd_stage_linearize(*lin_args), REPS),
                                cuda_ms(lambda: kernels._linearize_traj_plain(*lin_args),
                                        slow)),
            fd_stage_eval=(cuda_ms(lambda: kernels.fd_stage_eval(*eval_args), REPS),
                           cuda_ms(lambda: kernels._eval_traj_plain(*eval_args), slow)),
            fd_dynamics=(cuda_ms(lambda: kernels.fd_dynamics(*one), REPS),
                         cuda_ms(lambda: kernels.fd_dynamics_plain(*one), slow)),
        )
        all_lanes = (cuda_ms(lambda: kernels.fd_dynamics(*dyn_args), REPS),
                     cuda_ms(lambda: kernels.fd_dynamics_plain(*dyn_args), slow))
        nx, nu, nv, nc = solver.space.ndx, ocp.nu, ocp.nv, 3 * ocp.nk
        n_rows = ocp._const(xs)["w"].shape[0] + ocp.n_eq + ocp.n_in
        k7 = k7_flops(nv, nc)
        na = alphas.shape[0]
        # per scenario (fd_dynamics: per lane): (counted FLOPs, bytes read and
        # written); the linearization counts the Gauss-Newton products and
        # K7 once in primal and once along each of its nx + nu directions
        per = dict(
            fd_stage_linearize=(T * (2 * n_rows * (nx * nx + nu * nu + nu * nx + nx + nu)
                                     + (1 + nx + nu) * k7),
                                nbytes((sp, xs, us, lam_eq, lam_in, mu, lin)) / B),
            fd_stage_eval=(na * T * k7, nbytes((sp, xs_c, us_c, lam_eq, lam_in, mu,
                                                kernels.fd_stage_eval(*eval_args))) / B),
            fd_dynamics=(k7, nbytes((one[1:], kernels.fd_dynamics(*one)))),
        )
        bounds = {k: roofline(f * (1 if k == "fd_dynamics" else B),
                              m * (1 if k == "fd_dynamics" else B))
                  for k, (f, m) in per.items()}
        # the other shapes the table reports: (a) and (b) for one scenario
        # at the fd_mpc tick's T=50 (FLOPs and bytes scale with the stages),
        # (c) on all B*T lanes
        other = dict(
            fd_stage_linearize_B1_T50=roofline(*(x * FD_MPC_T / T for x in
                                                 per["fd_stage_linearize"])),
            fd_stage_eval_B1_T50=roofline(*(x * FD_MPC_T / T for x in per["fd_stage_eval"])),
            fd_dynamics_all_lanes=roofline(k7 * B * T, nbytes((dyn_args[1:],
                                                               kernels.fd_dynamics(*dyn_args)))))
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"fd_kernels_{name}", t0, B=B, T=T, tol=tol, rel_err=errs, max_abs_err=abs_err,
              kernel_and_twin_vs_f64_twin=vs64 or None,
              ms_kernel_vs_plain=times, fd_dynamics_all_lanes_ms=all_lanes,
              bound_ms=bounds if dtype == torch.float32 else None,
              other_bound_ms=other if dtype == torch.float32 else None)
    return out


def phase_batched(device):
    """Bench configuration: B=128 one-iteration warm-started solves, f32."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    t0 = time.perf_counter()
    dtype = torch.float32
    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=dtype)
    probs = tile_problem(ocp.problem, B)
    xs = ocp._tensor(x0)[None, None].expand(B, T + 1, -1).clone()
    us = ocp.get_reference_control(0)[None, None].expand(B, T, -1).clone()
    lams = (torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device),
            torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device),
            torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device))
    bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                         alphas=ALPHAS)))
    for _ in range(2):  # warm-up: first calls allocate and load the library
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
    torch.cuda.synchronize()
    calls = 30
    t1 = time.perf_counter()
    for _ in range(calls):
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    s = {k: float(v) for k, v in bs.summary(res).items()}
    check(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
          and torch.isfinite(res.Ks).all(), "batched solve: non-finite iterate")
    check(s["any_diverged"] == 0, "batched solve: a scenario diverged")
    check(s["max_prim"] < 5e-4, f"batched solve lost feasibility: max prim {s['max_prim']:.3e}")
    phase("batched", t0, B=B, T=T, calls=calls, solves_per_s=B * calls / wall,
          ms_per_call=1e3 * wall / calls, **s)


def phase_fd_batched(device):
    """Full dynamics, the recipe of phase_batched: B=128 tiled Go2 T=100
    standing problems in f32, warm-started from the standing state and the
    standing torques, mu_init 1e-6, two warm-up calls, then 30
    one-iteration calls each fed the last result.  Gates: finite, no
    divergence, the last call's max prim_res < 1e-3
    (tests/test_fulldynamics_solver.py:83).

    The warm start is the quasistatic one, not the zero torque of the
    reference control: from zero torque the robot's collapse makes the
    value Hessian grow to ~4e6 over the 100 stages, and in f32 the
    Jacobi-scaled Quu of the serial Riccati pass turns indefinite at stage
    9 (NaN in the first call, twin and kernel alike, and JAX's own f32 pass
    on the same linearization: test_torch_fulldynamics.py::
    test_f32_serial_riccati_from_zero_torque_fails_as_jax_does).

    A cut of the configuration: the gated solve runs without the 20
    friction-pyramid rows (48 inequality rows).  The pyramids bound the
    force in the LOCAL foot frame, which the Go2 standing posture tilts 0.8
    rad, beyond the pyramid's half-angle atan(0.8), so no admissible force
    set holds the robot at rest there
    (tests/test_torch_fulldynamics.py::test_pyramids_exclude_rest_at_the_standing_posture),
    and on this recipe the JAX package's solver stalls as the port does
    (test_pyramid_standing_problem_stalls_in_jax_as_in_the_port, slow).
    After the gated calls, the 68-row problem runs PYRAMID_CALLS calls of
    the same recipe through the same kernels: gated finite and not
    diverged, its max prim printed."""
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    t0 = time.perf_counter()
    dtype = torch.float32

    def start(force_cone):
        ocp, _, x0 = make_go2_fulldynamics(T, device=device, dtype=dtype,
                                           force_cone=force_cone)
        xs = ocp._tensor(x0)[None, None].expand(B, T + 1, -1).clone()
        us = ocp._tensor(standing_torques(ocp, x0))[None, None].expand(B, T, -1).clone()
        lams = (torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device),
                torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device),
                torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device))
        bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                             alphas=ALPHAS)))
        return ocp, bs, tile_problem(ocp.problem, B), xs, us, lams

    ocp, bs, probs, xs, us, lams = start(force_cone=False)
    prims = []
    for _ in range(2):  # warm-up
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
    torch.cuda.synchronize()
    calls = 30
    t1 = time.perf_counter()
    for _ in range(calls):
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    s = {k: float(v) for k, v in bs.summary(res).items()}
    check(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
          and torch.isfinite(res.Ks).all(), "fd batched solve: non-finite iterate")
    check(s["any_diverged"] == 0, "fd batched solve: a scenario diverged")
    check(s["max_prim"] < 1e-3, f"fd batched solve: last max prim {s['max_prim']:.3e} >= 1e-3")

    # the 68-row configuration, pyramids on, through the same path
    ocp, bs68, probs, xs, us, lams = start(force_cone=True)
    prims68 = []
    for _ in range(PYRAMID_CALLS):
        res68 = bs68.run(probs, xs, us, lams)
        xs, us, lams = res68.xs, res68.us, (res68.lam_eq, res68.lam_in, res68.lam_term)
        prims68.append(float(res68.prim_res.max()))
    check(ocp.n_in == 68, f"fd batched, pyramids on: {ocp.n_in} inequality rows")
    check(torch.isfinite(res68.xs).all() and torch.isfinite(res68.us).all()
          and torch.isfinite(res68.Ks).all(), "fd batched, pyramids on: non-finite iterate")
    check(not bool(res68.diverged.any()), "fd batched, pyramids on: a scenario diverged")
    phase("fd_batched", t0, B=B, T=T, calls=calls, solves_per_s=B * calls / wall,
          ms_per_call=1e3 * wall / calls, max_prim_per_call=[float(p) for p in prims], **s,
          pyramids_on=dict(n_in=ocp.n_in, calls=PYRAMID_CALLS, max_prim_per_call=prims68))


def fd_host_mpc(device, force_cone):
    """The host MPC of phase_fd_mpc (examples/go2_fulldynamics.py: T=50,
    trot 10/30/10/30 at 0.2 m/s, f32, first solve cut to 20 iterations),
    walking; returns (mpc, m g)."""
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    ocp, mh, _ = make_go2_fulldynamics(FD_MPC_T, device=device, dtype=torch.float32,
                                       force_cone=force_cone)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                          max_iters=1, swing_apex=0.05, T_fly=30, T_contact=10,
                          timestep=0.01, init_max_iters=20), ocp)
    check(not mpc.diverged, f"fd MPC ({ocp.n_in} rows): initial solve diverged")
    feet = mh.feet_names
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    mpc.generate_cycle_horizon([ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
    return mpc, mh.mass * 9.81


def phase_fd_mpc(device):
    """The host MPC on full dynamics (examples/go2_fulldynamics.py:20-34:
    T=50, trot 10/30/10/30 at 0.2 m/s) without the friction pyramids (a
    cut of the configuration, see phase_fd_batched), f32, first solve cut
    to 20 iterations: 30 ticks fed their own planned next state, then 5
    more under the profiler.  Gates: finite plans, no divergence, and on
    every gated tick the stage-0 contact forces (MPC.get_contact_forces(0),
    through fd_dynamics) unilateral and summing to within 35 % of m g
    (tests/test_fulldynamics_solver.py:102-103).  Then the same MPC with
    all 68 rows, PYRAMID_CALLS ticks: gated finite and not diverged, each
    tick's prim and stage-0 force sum printed."""
    def walking_mpc(force_cone):
        return fd_host_mpc(device, force_cone)

    def tick(mpc):
        res = mpc.iterate(mpc.xs[1])
        check(not mpc.diverged, "fd MPC: a tick diverged")
        check(bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
                   and torch.isfinite(res.Ks).all()), "fd MPC: non-finite plan")
        return float(res.prim_res), mpc.get_contact_forces(0).double().cpu().numpy()

    t0 = time.perf_counter()
    mpc, mg = walking_mpc(force_cone=False)
    setup = time.perf_counter() - t0
    ticks, lat, prims, fz = 30, [], [], []
    for _ in range(ticks):
        t1 = time.perf_counter()
        prim, f = tick(mpc)
        lat.append(time.perf_counter() - t1)
        check(bool(np.isfinite(f).all()) and f[:, 2].min() > -1e-6,
              f"fd MPC: stage-0 forces not unilateral: {f[:, 2]}")
        check(abs(f[:, 2].sum() - mg) < 0.35 * mg,
              f"fd MPC: stage-0 forces carry {f[:, 2].sum():.2f} N of m g = {mg:.2f} N")
        prims.append(prim)
        fz.append(float(f[:, 2].sum() / mg))
    trace = trace_calls(lambda: mpc.iterate(mpc.xs[1]))
    lat_ms = 1e3 * np.asarray(lat)

    # the 68-row configuration, pyramids on
    mpc68, _ = walking_mpc(force_cone=True)
    on = [tick(mpc68) for _ in range(PYRAMID_CALLS)]
    phase("fd_mpc", t0, T=FD_MPC_T, ticks=ticks, setup_s=setup,
          tick_p50_ms=float(np.percentile(lat_ms, 50)),
          tick_p99_ms=float(np.percentile(lat_ms, 99)), max_prim=float(max(prims)),
          fz_sum_over_mg=[min(fz), max(fz)], tick_trace=trace,
          pyramids_on=dict(n_in=mpc68.ocp_handler.n_in, ticks=PYRAMID_CALLS,
                           prim_per_tick=[p for p, _ in on],
                           fz_sum_over_mg_per_tick=[float(f[:, 2].sum() / mg) for _, f in on]))


def phase_fixture(device):
    """f32 re-solve against the committed f64 fixture (recipe of
    tests/test_parity_fixtures.py): BCL 30 iterations, then 2 x 30 ungated."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    t0 = time.perf_counter()
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "go2_kinodynamics_T100.npz"))
    dtype = torch.float32
    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=dtype)
    probs = tile_problem(ocp.problem, 1)
    xs = ocp._tensor(x0)[None, None].expand(1, T + 1, -1).clone()
    us = ocp.get_reference_control(0)[None, None].expand(1, T, -1).clone()
    s_bcl = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(tol=1e-7, mu_init=1e-4,
                                                            max_iters=30)))
    s_mm = ProxDDPSolver(ocp, SolverSettings(tol=1e-7, mu_init=1e-4, max_iters=30,
                                             bcl=False))
    res = s_bcl.run(probs, xs, us)
    for _ in range(2):
        res = s_mm.run(probs, res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term),
                       res.mu)
    prim = float(res.prim_res[0])
    err_u = float(np.abs(res.us[0].double().cpu().numpy() - fx["us"]).max())
    err_x = float(np.abs(res.xs[0].double().cpu().numpy() - fx["xs"]).max())
    check(prim < 1e-4, f"fixture re-solve: prim {prim:.3e} >= 1e-4")
    check(err_u <= 1e-4, f"fixture gate: max|us - us*| = {err_u:.3e} > 1e-4")
    check(err_x <= 1e-3, f"fixture gate: max|xs - xs*| = {err_x:.3e} > 1e-3")
    phase("fixture", t0, prim_res=prim, max_abs_err_us=err_u, max_abs_err_xs=err_x)


def go2_host_mpc(device):
    """The host MPC of phase_mpc (examples/go2_kinodynamics.py trot at
    0.2 m/s, T=100, f32, first solve cut to 20 iterations), walking."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=torch.float32)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                          max_iters=1, num_threads=1, swing_apex=0.05, T_fly=30,
                          T_contact=10, timestep=0.01, init_max_iters=20), ocp)
    check(not mpc.diverged, "MPC: initial solve diverged")
    feet = mh.feet_names
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    mpc.generate_cycle_horizon([ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
    return mpc


def phase_mpc(device):
    """Host MPC loop on the card (examples/go2_kinodynamics.py trot)."""
    t0 = time.perf_counter()
    mpc, setup = go2_host_mpc(device), time.perf_counter() - t0
    ticks, lat, prims = 30, [], []
    for _ in range(ticks):
        x = mpc.xs[1]
        t1 = time.perf_counter()
        res = mpc.iterate(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        check(not mpc.diverged, "MPC: a tick diverged")
        check(bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
                   and torch.isfinite(res.Ks).all()), "MPC: non-finite plan")
        prims.append(float(res.prim_res))
    lat_ms = 1e3 * np.asarray(lat)
    phase("mpc", t0, T=T, ticks=ticks, setup_s=setup,
          tick_p50_ms=float(np.percentile(lat_ms, 50)),
          tick_p99_ms=float(np.percentile(lat_ms, 99)),
          max_prim=float(max(prims)),
          takeoff=mpc.get_foot_takeoff_cycle("FL_foot"),
          land=mpc.get_foot_land_cycle("FL_foot"))


def phase_fused(device):
    """The fused tick: B=128 self-fed step_batched ticks, one tick in
    sync-debug "error" mode, then B=1 `step` latency."""
    t0 = time.perf_counter()
    fused, carry = fused_engine(device)
    setup = time.perf_counter() - t0
    cb = fused.tile_carry(carry, B)
    for _ in range(2):  # warm-up: first calls allocate and load the library
        cb, res = fused.step_batched(cb, cb.xs[:, 1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cb, res = fused.step_batched(cb, cb.xs[:, 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ticks = 20
    prim = torch.zeros((), dtype=res.prim_res.dtype, device=device)
    bad = torch.zeros((), dtype=torch.bool, device=device)
    t1 = time.perf_counter()
    for _ in range(ticks):
        cb, res = fused.step_batched(cb, cb.xs[:, 1])
        prim = torch.maximum(prim, res.prim_res.max())
        bad = bad | res.diverged.any() | ~torch.isfinite(res.Ks).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    check(not bool(bad), "fused B=128: a scenario diverged or produced a non-finite plan")
    check(bool(torch.isfinite(cb.xs).all() and torch.isfinite(cb.us).all()),
          "fused B=128: non-finite carry")
    max_prim = float(prim)
    check(max_prim < 5e-3, f"fused B=128 lost feasibility: max prim {max_prim:.3e}")

    lat = []
    c1 = carry
    for _ in range(2):
        c1, r1 = fused.step(c1, c1.xs[1])
    trace = trace_calls(lambda: fused.step(c1, c1.xs[1]))
    for _ in range(ticks):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c1, r1 = fused.step(c1, c1.xs[1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t2)
        check(not bool(r1.diverged) and bool(torch.isfinite(r1.us).all()),
              "fused B=1: non-finite plan")
    lat_ms = 1e3 * np.asarray(lat)
    phase("fused", t0, T=T, B=B, setup_s=setup, ticks=ticks,
          ticks_per_s=B * ticks / wall, ms_per_batched_tick=1e3 * wall / ticks,
          max_prim=max_prim, sync_debug_tick="ok",
          step_p50_ms=float(np.percentile(lat_ms, 50)),
          step_p99_ms=float(np.percentile(lat_ms, 99)), step_prim=float(r1.prim_res),
          step_trace=trace)


def latency_setup(device):
    """The latency engine (its host MPC's first solve runs the serial
    pass, as the JAX bench's does): (fused, pristine carry, seconds)."""
    t0 = time.perf_counter()
    fused, carry = fused_engine(device, parallel=True)
    torch.cuda.synchronize()
    return fused, carry, time.perf_counter() - t0


def phase_latency(device, fused, carry0, setup_s):
    """The B=1 latency path (bench.py:357-464 at full precision):
    pipelined `step_donated`, eager `step`, and the self-fed rollout gate."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    t0 = time.perf_counter()
    reps, k, ticks = 10, 20, 20
    bad = torch.zeros((), dtype=torch.bool, device=device)
    carry = tree_map(torch.clone, carry0)  # the rollout below starts from carry0
    for _ in range(2):  # warm-up
        carry, res = fused.step_donated(carry, carry.xs[1])
    torch.cuda.synchronize()
    pipe = []
    for _ in range(reps):
        t1 = time.perf_counter()
        for _ in range(k):
            carry, res = fused.step_donated(carry, carry.xs[1])
            bad = bad | res.diverged | ~torch.isfinite(res.us).all()
        torch.cuda.synchronize()
        pipe.append(1e3 * (time.perf_counter() - t1) / k)
    check(not bool(bad), "latency: step_donated diverged or planned non-finite controls")

    c1, lat = tree_map(torch.clone, carry0), []
    for i in range(2 + ticks):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c1, r1 = fused.step(c1, c1.xs[1])
        torch.cuda.synchronize()
        if i >= 2:
            lat.append(1e3 * (time.perf_counter() - t2))
        check(not bool(r1.diverged) and bool(torch.isfinite(r1.us).all()),
              "latency: eager step diverged or planned non-finite controls")

    trace = trace_calls(lambda: fused.step_donated(carry, carry.xs[1]))
    _, (us0, xs1, prims) = fused.self_rollout(carry0, ticks)
    p = prims.double().cpu().numpy()
    check(bool(torch.isfinite(us0).all() and torch.isfinite(xs1).all()),
          "latency: non-finite self-fed rollout")
    max_prim, med_prim = float(p.max()), float(np.median(p))
    check(max_prim < 5e-3 and med_prim < 5e-4,
          f"latency path lost feasibility: max prim {max_prim:.3e}, median {med_prim:.3e}")
    phase("latency", t0, T=T, B=1, setup_s=setup_s, reps=reps, ticks_per_rep=k,
          donated_p50_ms=float(np.median(pipe)), donated_p99_ms=float(max(pipe)),
          step_p50_ms=float(np.percentile(lat, 50)),
          step_p99_ms=float(np.percentile(lat, 99)),
          rollout_ticks=ticks, rollout_max_prim=max_prim, rollout_median_prim=med_prim,
          donated_trace=trace)


def ptxas_report(log, names, wide=False):
    """{kernel: {"registers": n, "stack_bytes": n}} of the kernels whose
    mangled names contain one of `names`, read from nvcc's -Xptxas -v log:
    the kernel's "Used" line, whose cumulative stack size counts the stack
    of the device functions it calls (a kernel's own "stack frame" line
    reads 0 where its work sits in a function that was not inlined).  With
    `wide`, the instances compiled over csrc/stage_wide.cuh (their
    parameters' types are in the namespace smpc_wide), else the others."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((n for n in names if n in ln and ("smpc_wide" in ln) == wide), None)
            if cur is not None:
                cur = f"{cur}_{'f64' if f'{cur}IdE' in ln else 'f32'}"
        elif cur is not None and "Used" in ln and "registers" in ln:
            stack = (int(ln.split("bytes cumulative stack")[0].split()[-1])
                     if "cumulative stack" in ln else 0)
            out[cur] = dict(registers=int(ln.split("Used")[1].split()[0]), stack_bytes=stack)
            cur = None
    return out


def id_sim_case(device, dtype, nb, seed):
    """The example's ID (and one with contact_motion_equality), the
    simulator with the ground at the standing feet, and nb perturbed Go2
    robots made from numpy with a fixed seed: ID states and targets with
    the contact sets {all, diagonal pair} in turns; simulator states in
    turns standing (perturbed velocities), 5 cm above the ground (free
    fall) and with the FL thigh raised 0.3 rad (that foot off the
    ground)."""
    from simple_mpc_tpu_torch.configs import go2_handler
    from simple_mpc_tpu_torch.examples.go2_kinodynamics import ID_SETTINGS
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    mh = go2_handler()
    ids = [KinodynamicsID(mh, 1e-3, IDSettings(**ID_SETTINGS, contact_motion_equality=eq),
                          device=device, dtype=dtype) for eq in (False, True)]
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device=device)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(mh.reference_state)
    nq, nv = mh.model.nq, mh.model.nv

    def configs(scale):
        q = x0[:nq] + scale * rng.normal(size=(nb, nq))
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
        return q

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    contacts = np.where((np.arange(nb) % 2 == 0)[:, None], 1.0,
                        np.array([1.0, 0.0, 0.0, 1.0])[None])
    idin = dict(q=t(configs(0.02)), v=t(0.1 * rng.normal(size=(nb, nv))),
                targets=dict(q_t=t(configs(0.01)), v_t=t(0.1 * rng.normal(size=(nb, nv))),
                             a_t=t(rng.normal(size=(nb, nv))), contacts=t(contacts),
                             f_t=t(rng.normal(size=(nb, 4, 3)) + [0.0, 0.0, 30.0])))
    qs = np.repeat(x0[None, :nq], nb, 0)
    qs[1::3, 2] += 0.05
    qs[2::3, 8] += 0.3
    simin = (t(qs), t(0.05 * rng.normal(size=(nb, nv))), t(0.5 * rng.normal(size=(nb, nv - 6))))
    return ids, sim, idin, simin


def talos_id_sim_case(device, dtype, nb, seed):
    """The Talos example's ID (and one with contact_motion_equality), the
    simulator with the ground at the standing soles, and nb perturbed Talos
    robots made from numpy with a fixed seed: ID states and targets (6D
    wrenches) with the contact sets {both, left lifted, right lifted} in
    turns; simulator states in turns standing (perturbed velocities), with
    the left knee bent 0.3 rad (that sole off the ground) and with the base
    rising at 1 m/s (both contacts pull in the first solve and are dropped
    in the second)."""
    from simple_mpc_tpu_torch.configs import talos_handler
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import ID_SETTINGS
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    mh = talos_handler()
    ids = [KinodynamicsID(mh, 1e-3, IDSettings(**ID_SETTINGS, contact_motion_equality=eq),
                          device=device, dtype=dtype) for eq in (False, True)]
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device=device)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(mh.reference_state)
    nq, nv = mh.model.nq, mh.model.nv

    def configs(scale):
        q = x0[:nq] + scale * rng.normal(size=(nb, nq))
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
        return q

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    contacts = np.array([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])[np.arange(nb) % 3]
    idin = dict(q=t(configs(0.02)), v=t(0.1 * rng.normal(size=(nb, nv))),
                targets=dict(q_t=t(configs(0.01)), v_t=t(0.1 * rng.normal(size=(nb, nv))),
                             a_t=t(rng.normal(size=(nb, nv))), contacts=t(contacts),
                             f_t=t(10.0 * rng.normal(size=(nb, 2, 6))
                                   + [0.0, 0.0, 450.0, 0.0, 0.0, 0.0])))
    qs = np.repeat(x0[None, :nq], nb, 0)
    vs = 0.05 * rng.normal(size=(nb, nv))
    qs[1::3, 10] += 0.3  # leg_left_4_joint, the left knee
    vs[2::3, 2] = 1.0
    simin = (t(qs), t(vs), t(0.5 * rng.normal(size=(nb, nv - 6))))
    return ids, sim, idin, simin


def state_derivative_case(device, dtype, n, seed, robot):
    """A kinodynamics OCP of `robot` ("go2": the closed-loop example's
    weights, point feet; "talos": the Talos example's, 6D feet) and n lanes
    of states, controls and contact masks perturbed from numpy with a fixed
    seed: (ocp, x (n,nx), u (n,nu), stage params with leading n)."""
    from simple_mpc_tpu_torch.configs import go2_handler, go2_kinodynamics_config, talos_handler
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import talos_kinodynamics_config
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP

    talos = robot == "talos"
    mh = talos_handler() if talos else go2_handler()
    cfg = talos_kinodynamics_config(mh) if talos else go2_kinodynamics_config(mh)
    ocp = KinodynamicsOCP(cfg, mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, 2, 6 if talos else 3, -9.81, False)
    rng = np.random.default_rng(seed)
    nq = mh.model.nq
    x = np.repeat(x0[None], n, 0) + 0.02 * rng.normal(size=(n, x0.shape[0]))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    x[:, nq:] = 0.2 * rng.normal(size=(n, mh.model.nv))
    u0 = ocp.get_reference_control(0).double().cpu().numpy()
    u = u0 + np.where(np.abs(u0) > 1.0, 20.0, 1.0) * rng.normal(size=(n, ocp.nu))
    act = (rng.random((n, ocp.nk)) > 0.3).astype(np.float64)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    p = tree_map(lambda a: a[0][None].expand((n,) + tuple(a.shape[1:])).contiguous(),
                 ocp.problem.stage_params)
    return ocp, t(x), t(u), p._replace(contact_active=t(act))


def qp_flops(n, m, iters):
    """Counted FLOPs of one ADMM solve: K = H + sigma I + A' diag(rho) A, its
    Cholesky, per step A'w, the two triangular solves, Ax and ~10 m
    elementwise; the residuals at the end."""
    return (2 * m * n * n + n ** 3 / 3 + iters * (4 * m * n + 2 * n * n + 10 * m)
            + 4 * m * n + 2 * n * n)


def qp_spread(H, g, A, l, u, z0, y0, want, seed=3):
    """The QP twin's own response (max bound_rel over z and y) to a 1e-15
    relative move, of random sign from numpy with a fixed seed, of every
    entry of H, g and A."""
    from simple_mpc_tpu_torch import kernels

    rng = np.random.default_rng(seed)

    def moved(x):
        return x * (1.0 + 1e-15 * torch.as_tensor(rng.choice([-1.0, 1.0], size=x.shape),
                                                   dtype=x.dtype, device=x.device))

    got = kernels.solve_qp(moved(H), moved(g), moved(A), l, u, 60, z0=z0, y0=y0)
    return max(bound_rel(a, b) for a, b in zip(got[:2], want[:2]))


def phase_id_sim_kernels(device, ptxas_log="", robot="go2"):
    """K8 (qp_admm, id_assemble) and K10 (sim_step) against their twins on
    the card, at B=1 (the closed loop's shape) and B=128, f32 and f64, on
    perturbed Go2 states (id_sim_case), or with robot="talos" the wide
    instances (wide_id_assemble with 6D wrenches and wrench cones,
    qp_admm at n=40, m=98 and 110, wide_sim_step at 23 joints) on
    perturbed Talos states (talos_id_sim_case) and K11 (state_derivative
    on Go2, wide_state_derivative on Talos) at N=1 and N=128
    (state_derivative_case).  Gates: in f64 the kernel within 1e-10 of the
    twin (max|a - b| / max(1, max|b|); for l and u over the finite rows, the
    rows off at +-1e20 equal); the QP's residuals within 1e-10 of the
    twin's relative to the scale of the sums that form them; in f32 the
    kernel against the twin in f64 on the same inputs within F32_ID_TOL,
    F32_QP_TOL (z and y; the f32 residuals are roundoff and printed) and
    F32_SIM_TOL (Go2) or F32_TALOS_TOL (Talos and K11), the masks of both
    solves equal to the twin's in both types.  Those are about four to ten
    times the f32 twin's own distance to the f64 twin on these inputs
    (printed beside them).  The QP runs on the twin's assembly of each
    dtype, cold and warm-started from its cold solution.  On Talos the f64
    QP gate is max(1e-10, ten times the twin's own response to a 1e-15
    relative move of H, g and A, `qp_spread`): at 40 variables, forces of
    ~450 N and weights from 0.05 to 1e3 that response alone reaches
    1.1e-10 (CPU), so no summation order meets a fixed 1e-10."""
    from simple_mpc_tpu_torch import kernels

    talos = robot == "talos"
    ida, sims = ("wide_id_assemble", "wide_sim_step") if talos else ("id_assemble", "sim_step")
    tol32 = F32_TALOS_TOL if talos else {ida: F32_ID_TOL, "qp_admm": F32_QP_TOL,
                                         sims: F32_SIM_TOL}
    case = talos_id_sim_case if talos else id_sim_case
    out = {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        t0 = time.perf_counter()
        errs, abs_err, vs64, times, bounds, masks, spreads = {}, {}, {}, {}, {}, {}, []
        for nb in (1, B):
            ids, sim, idin, simin = case(device, dtype, nb, seed=11)

            def gate(name, got, want, want64, tol, keep=None):
                for a in got:
                    check(bool(torch.isfinite(a).all()), f"{name} {dtype} B={nb}: non-finite")
                pairs = list(zip(got, want64 if f32 else want))
                if keep is not None:
                    pairs = [pairs[i] for i in keep]
                e = max(bound_rel(a, b) for a, b in pairs)
                check(e <= tol, f"{name} {dtype} B={nb}: {e:.3e} > {tol:.1e}")
                errs[name] = max(errs.get(name, 0.0), e)
                abs_err[name] = max([abs_err.get(name, 0.0)] + [
                    float(finite_abs(a, b)) for a, b in zip(got, want)])
                if f32:
                    twin = max(bound_rel(a, b) for a, b in
                               [list(zip(want, want64))[i] for i in keep or range(len(got))])
                    old = vs64.get(name, (0.0, 0.0))
                    vs64[name] = (max(old[0], e), max(old[1], twin))

            as64 = lambda d: {k: a.double() for k, a in d.items()}  # noqa: E731
            for idq in ids:
                args = (idin["q"], idin["v"], idin["targets"])
                got = kernels.id_assemble(idq, *args)
                want = idq._assemble_core(*args)
                want64 = idq._assemble_core(idin["q"].double(), idin["v"].double(),
                                            as64(idin["targets"])) if f32 else None
                gate(ida, got, want, want64, tol32[ida] if f32 else 1e-10)
                H, g, A, l, u = want[:5]
                qp64 = ([x.double() for x in (H, g, A, l, u)] if f32 else None)
                cold = kernels.qp_admm(H, g, A, l, u, iters=60)
                cold0 = kernels.solve_qp(H, g, A, l, u, 60)
                for z0, y0 in ((None, None), (cold0.z, cold0.y)):
                    got = kernels.qp_admm(H, g, A, l, u, iters=60, z0=z0, y0=y0)
                    want = kernels.solve_qp(H, g, A, l, u, 60, z0=z0, y0=y0)
                    want64 = (kernels.solve_qp(*qp64, 60, z0=None if z0 is None else z0.double(),
                                               y0=None if y0 is None else y0.double())
                              if f32 else None)
                    qtol = tol32["qp_admm"] if f32 else 1e-10
                    if talos and not f32:
                        spreads.append(qp_spread(H, g, A, l, u, z0, y0, want))
                        qtol = max(qtol, 10.0 * spreads[-1])
                    gate("qp_admm", got, want, want64, qtol, keep=(0, 1))
                    if not f32:  # the residuals, against the scale of their sums
                        scale = 1.0 + float(g.abs().max() + (H.abs().sum(-1).max()
                                            * want.z.abs().max()) + A.abs().sum(-2).max()
                                            * want.y.abs().max())
                        e = max(float((a - b).abs().max()) for a, b in
                                zip(got[2:], want[2:])) / scale
                        check(e <= 1e-10, f"qp_admm f64 B={nb}: residuals {e:.3e} > 1e-10")
            got = kernels.sim_step(sim, *simin)
            want = sim.step_plain(*simin)
            want64 = sim.step_plain(*(x.double() for x in simin)) if f32 else None
            for ref in (want, want64) if f32 else (want,):
                check(torch.equal(got.active, ref.active.to(dtype)),
                      f"{sims} {dtype} B={nb}: contact masks differ from the twin's")
            gate(sims, got[:3], want[:3], want64 and want64[:3],
                 tol32[sims] if f32 else 1e-10)
            masks[f"B{nb}"] = got.active.sum(dim=0).tolist()

            idq = ids[0]
            args = (idin["q"], idin["v"], idin["targets"])
            H, g, A, l, u, M, h, JcT = kernels.id_assemble(idq, *args)
            qp_args = (H, g, A, l, u)
            slow = SLOW_REPS
            times[f"B{nb}"] = {
                ida: (cuda_ms(lambda: kernels.id_assemble(idq, *args), REPS),
                      cuda_ms(lambda: idq._assemble_core(*args), slow)),
                "qp_admm": (cuda_ms(lambda: kernels.qp_admm(*qp_args, iters=60), REPS),
                            cuda_ms(lambda: kernels.solve_qp(*qp_args, 60), slow)),
                sims: (cuda_ms(lambda: kernels.sim_step(sim, *simin), REPS),
                       cuda_ms(lambda: sim.step_plain(*simin), slow))}
            n, m = H.shape[-1], A.shape[-2]
            nr = idq.nu + 6 + 2 * idq.fdim * idq.nk
            nv, nc = idq.nv, 3 * idq.nk
            per = {
                ida: (2 * nr * n * n + 2 * nr * n, nbytes((args, H, g, A, l, u, M, h, JcT))),
                "qp_admm": (qp_flops(n, m, 60), nbytes((qp_args, cold))),
                sims: (2 * k7_flops(nv, nc), nbytes((simin, got[:3])))}
            if talos:  # K11, both instances
                for sd, bot in (("state_derivative", "go2"), ("wide_state_derivative", "talos")):
                    ocp, x, uu, p = state_derivative_case(device, dtype, nb, 13, bot)
                    got = kernels.state_derivative(ocp, x, uu, p)
                    want = kernels.state_derivative_plain(ocp, x, uu, p)
                    want64 = None
                    if f32:
                        ocp64, x64, u64, p64 = state_derivative_case(device, torch.float64, nb,
                                                                     13, bot)
                        want64 = kernels.state_derivative_plain(ocp64, x64, u64, p64)
                    gate(sd, (got,), (want,), None if want64 is None else (want64,),
                         tol32[sd] if f32 else 1e-10)
                    times[f"B{nb}"][sd] = (
                        cuda_ms(lambda: kernels.state_derivative(ocp, x, uu, p), REPS),
                        cuda_ms(lambda: kernels.state_derivative_plain(ocp, x, uu, p), slow))
                    # FK and the centroidal algebra are not counted: a bound by bytes
                    per[sd] = (0, nbytes((x, uu, p.contact_active, got)))
            bounds[f"B{nb}"] = {k: roofline(f * nb, mv) for k, (f, mv) in per.items()}
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        ptx = ptxas_report(ptxas_log, ("qp_admm_kernel", "id_assemble_kernel",
                                       "sim_step_kernel"))
        if talos:
            ptx = {k: v for k, v in ptx.items() if k.startswith("qp_admm")}
            ptx.update({f"wide_{k}": v for k, v in ptxas_report(
                ptxas_log, ("id_assemble_kernel", "sim_step_kernel",
                            "state_derivative_kernel"), wide=True).items()})
            ptx.update(ptxas_report(ptxas_log, ("state_derivative_kernel",)))
        phase(f"{'talos_' if talos else ''}id_sim_kernels_{name}", t0,
              tol=tol32 if f32 else 1e-10, rel_err=errs, max_abs_err=abs_err,
              kernel_and_twin_vs_f64_twin=vs64 or None, masks_active_per_foot=masks,
              ms_kernel_vs_plain=times, bound_ms=bounds if f32 else None,
              qp_shape=dict(n=int(n), m=[kernels._id_rows(i) for i in ids]) if talos else None,
              qp_f64_twin_spread=spreads or None,
              ptxas=ptx)
    return out


def phase_talos_id_sim_kernels(device, ptxas_log=""):
    """The Talos closed loop's kernels against their twins on the card
    (phase_id_sim_kernels with robot="talos")."""
    return phase_id_sim_kernels(device, ptxas_log, robot="talos")


def ls_rel(a, b):
    """max|a - b| / max|b| over the finite entries of b (rel_err), with
    inf where a and b are not finite at the same entries or differ there."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin) or not torch.equal(a[~fin].nan_to_num(),
                                                                 b[~fin].nan_to_num()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp_min(1e-300))


def ls_case(kind, device, dtype):
    """One iteration's real inputs of the line search at the main path's
    shapes (B=128, T=100): Go2 kinodynamics (standing_case), Go2 full
    dynamics with its 68 rows (fd_case) or Talos kinodynamics (talos_case,
    the feet lifted in turns), with mu 1e-6 (at its f32 floor in f32), eta
    from mu and omega unset as `run` enters its first iteration; the
    linearization, K3 and the rollout through the kernels.  Returns
    (solver, rollout steps (xs, us, dxs, dus), select's arguments after
    the solver)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    if kind == "go2":
        ocp, probs, xs, us = standing_case(device, dtype, seed=3)
        lam_in = torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device)
        lam_eq = torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device)
    elif kind == "fd":
        ocp, probs, xs, us, lam_in = fd_case(device, dtype, seed=5)
        lam_eq = torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device)
    else:
        ocp, probs, xs, us, lam_eq, lam_in = talos_case(device, dtype, B, T, seed=9)
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, alphas=ALPHAS,
                                               u_scale="auto" if kind == "talos" else None))
    st = solver.settings
    eps = torch.finfo(dtype).eps
    mu = torch.full((B,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
    lam_term = torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device)
    sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
    tp = tree_map(torch.Tensor.contiguous, probs.term_params)
    x0 = probs.x0.contiguous()
    lin = solver._linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
    Vx, Vxx = kernels.term_linearize(solver, xs[:, -1], tp, lam_term, mu)
    ks, Ks, dual = solver._backward(lin, Vx, Vxx, max(st.reg_init, 50 * eps))
    alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=device)
    dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks, Ks,
                                      kernels.state_difference_plain(solver, xs[:, 0], x0),
                                      alphas)
    xs_c, us_c = kernels.candidate_integrate_plain(solver, xs, us, dxs, dus)
    costs, g, h, gap = solver._eval(solver, sp, xs_c, us_c, lam_eq, lam_in, mu)
    eta = torch.clamp(mu ** st.bcl_alpha, min=float(st.tol))
    omega = torch.full((B,), -1.0, dtype=dtype, device=device)
    return solver, (xs, us, dxs, dus), (xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in,
                                        lam_term, mu, eta, omega, dual, alphas)


def select_bytes(sel, out):
    """Bytes line_search_select must move for these inputs: the candidates'
    stage costs and gaps (the merit), their initial and terminal states,
    the chosen candidate's states, controls, g and h, the multipliers and
    per-scenario scalars, and every output."""
    xs_c, us_c, costs, g, h, gap = sel[:6]
    nb, na = xs_c.shape[:2]
    e = xs_c.element_size()
    cand = nbytes((costs, gap)) + 2 * nb * na * xs_c.shape[-1] * e
    chosen = (nbytes((xs_c, us_c, g, h))) // na
    return cand + chosen + nbytes(sel[6:]) + nbytes(out)


def ls_f32_readings(solver, roll, sel, ci, ls, sd):
    """f32 runs of the line-search functions ci, ls and sd (the kernels or
    their twins) on one ls_case against the f64 twins on the same inputs
    (as64): each function's largest distance (ls_rel over its outputs;
    line_search_select's over the scenarios where it picked the f64 twin's
    step size), every scenario where it picked another one with the f64
    twin's relative merit gap between the two picks, and the f32 twin's
    largest relative distance from the f64 twin over the finite merits of
    every candidate ("twin_merit_rel")."""
    from simple_mpc_tpu_torch import kernels

    x1, x2 = roll[0][:, 0], sel[7]
    roll64, sel64 = as64(roll), as64(sel)
    got = ci(solver, *roll)
    out = dict(
        candidate_integrate=max(ls_rel(a, b) for a, b in zip(
            got, kernels.candidate_integrate_plain(solver, *roll64))),
        state_difference=ls_rel(sd(solver, x1, x2),
                                kernels.state_difference_plain(solver, *as64((x1, x2)))))
    got, want = ls(solver, *sel), kernels.line_search_select_plain(solver, *sel64)
    same = got.alpha.double() == want.alpha
    out["line_search_select"] = max(ls_rel(a[same], b[same]) for a, b in zip(got, want))

    def merits(s):
        return kernels._candidate_merits(solver, s[0], s[2], s[5], s[6], s[7], s[10],
                                         s[11])[0]

    m32, m64 = merits(sel), merits(sel64)
    fin = torch.isfinite(m64)
    out["twin_merit_rel"] = float(((m32.double() - m64).abs() / m64.abs())[fin].max())
    out["other_picks"] = []
    for b in torch.nonzero(~same).flatten().tolist():
        k = int(torch.nonzero(sel[15] == got.alpha[b])[0])
        w = int(torch.nonzero(sel64[15] == want.alpha[b])[0])
        out["other_picks"].append(dict(scenario=b, kernel=k, twin64=w, twin64_merit_gap=float(
            (m64[b, k] - m64[b, w]) / m64[b, w].abs())))
    return out


def phase_line_search_kernels(device):
    """K4 after the rollout (csrc/linesearch.cu and its wide instance)
    against its twins on the card, on the real candidates of one iteration
    (ls_case) of Go2 kinodynamics, Go2 full dynamics (68 rows) and Talos
    kinodynamics at B=128, T=100, nA=5, f32 and f64: candidate_integrate,
    line_search_select and state_difference (the initial gap).  Gates: in
    f64 every output within 1e-10 of the twin (relative to its largest
    entry) and the identical step size in every scenario.  In f32
    (ls_f32_readings) each kernel within F32_LS_TOL[problem] of the twin
    in f64 on the same inputs, line_search_select on the scenarios where it
    picked the f64 twin's step size, and another step size only where the
    f64 twin's relative merit gap between the two picks is within
    F32_LS_TOL's "tie"; the f32 twin's own readings printed beside, and the
    kernels' distances from the f32 twin with every scenario where the two
    picked differently.  Times: CUDA-
    event medians of the kernels and twins; bounds by bytes (the rigid-body
    arithmetic of the terminal costs and differences is not counted).
    Then the device kernels one solver iteration launches: a
    `BatchedSolver.run` of Go2 kinodynamics at B=1 (serial K3, the default
    SolverSettings) at max_iters=2 less the same at max_iters=1, each the
    most of three `call_kernels` readings, at most 16."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    out = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        f32 = dtype == torch.float32
        errs, abs_err, times, bounds, picks, per_kind = {}, {}, {}, {}, {}, {}
        vs64 = {}
        for kind in ("go2", "fd", "talos"):
            solver, roll, sel = ls_case(kind, device, dtype)
            ci, sd = kernels.candidate_integrate, kernels.state_difference
            ls = kernels.wide_line_search_select if kind == "talos" else kernels.line_search_select
            x1, x2 = roll[0][:, 0], sel[7]
            runs = {ci.__name__: (lambda: ci(solver, *roll),
                                  lambda: kernels.candidate_integrate_plain(solver, *roll)),
                    ls.__name__: (lambda: ls(solver, *sel),
                                  lambda: kernels.line_search_select_plain(solver, *sel)),
                    sd.__name__: (lambda: sd(solver, x1, x2),
                                  lambda: kernels.state_difference_plain(solver, x1, x2))}
            for name, (kern, twin) in runs.items():
                got, want = kern(), twin()
                got = (got,) if torch.is_tensor(got) else tuple(got)
                want = (want,) if torch.is_tensor(want) else tuple(want)
                e = max(ls_rel(a, b) for a, b in zip(got, want))
                if not f32:
                    check(e <= 1e-10, f"{name} {kind} f64: rel err {e:.3e} > 1e-10")
                moved = (select_bytes(sel, got) if name == ls.__name__
                         else nbytes((roll, solver._su(roll[0]), got)) if name == ci.__name__
                         else nbytes((x1, x2, got)))
                r = dict(rel_err=e, max_abs_err=max(float(finite_abs(a, b))
                                                    for a, b in zip(got, want) if a.numel()),
                         ms=cuda_ms(kern, REPS), plain_ms=cuda_ms(twin, REPS),
                         bound=roofline(0, moved))
                per_kind[f"{kind}/{name}"] = r
                # the summary's readings: Go2 kinodynamics for the Go2
                # unit, Talos for the wide one; the errors the worst case
                errs[name] = max(errs.get(name, 0.0), e)
                abs_err[name] = max(abs_err.get(name, 0.0), r["max_abs_err"])
                if name not in times:
                    times[name], bounds[name] = (r["ms"], r["plain_ms"]), r["bound"]
            # the step sizes picked; the twin's merits of every candidate
            got, want = ls(solver, *sel), kernels.line_search_select_plain(solver, *sel)
            differ = torch.nonzero(got.alpha != want.alpha).flatten().tolist()
            m = kernels._candidate_merits(solver, sel[0], sel[2], sel[5], sel[6], sel[7],
                                          sel[10], sel[11])[0]
            check(f32 or not differ, f"{ls.__name__} f64: other step sizes in scenarios {differ}")
            a_k = [int(torch.nonzero(sel[15] == a)[0]) for a in got.alpha[differ]]
            a_t = [int(torch.nonzero(sel[15] == a)[0]) for a in want.alpha[differ]]
            picks[kind] = [dict(scenario=b, kernel=k, twin=w, twin_merit_gap=float(
                (m[b, k] - m[b, w]) / m[b, w].abs())) for b, k, w in zip(differ, a_k, a_t)]
            picks[kind + "_nonfinite_candidates"] = int((~torch.isfinite(m)).sum())
            if f32:
                # the kernels and the f32 twins against the f64 twin
                r = ls_f32_readings(solver, roll, sel, ci, ls, sd)
                tw = ls_f32_readings(solver, roll, sel, kernels.candidate_integrate_plain,
                                     kernels.line_search_select_plain,
                                     kernels.state_difference_plain)
                tol = F32_LS_TOL[kind]
                for k in ("candidate_integrate", "state_difference", "line_search_select"):
                    check(r[k] <= tol[k], f"{k} {kind} f32: {r[k]:.3e} > {tol[k]:.1e} "
                          "from the f64 twin")
                ties = [p for p in r["other_picks"] if p["twin64_merit_gap"] > tol["tie"]]
                check(not ties, f"{ls.__name__} {kind} f32: another step size than the f64 "
                      f"twin's beyond a merit tie of {tol['tie']:.1e}: {ties}")
                vs64[kind] = dict(kernel=r, twin=tw, tol=tol)
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"line_search_kernels_{name}", t0, B=B, T=T, n_alpha=len(ALPHAS),
              rel_err=errs, max_abs_err=abs_err, per_problem=per_kind,
              bound_ms=bounds if f32 else None, other_picks=picks,
              kernel_and_twin_vs_f64_twin=vs64 or None)

    # the device kernels of one solver iteration at B=1
    t0 = time.perf_counter()
    ocp, _, x0 = make_go2_kinodynamics(T, device=device, dtype=torch.float32)
    probs = tile_problem(ocp.problem, 1)
    xs = ocp._tensor(x0)[None, None].expand(1, T + 1, -1).clone()
    us = ocp.get_reference_control(0)[None, None].expand(1, T, -1).clone()
    per, counts = {}, {}
    for n in (1, 2):
        bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(max_iters=n)))
        bs.run(probs, xs, us)
        counts[n] = [call_kernels(lambda: bs.run(probs, xs, us)) for _ in range(3)]
        per[n] = max(counts[n])
        check(per[n] > 0, f"no kernel of a max_iters={n} solve found in its traces")
    per_iter = per[2] - per[1]
    check(per_iter <= 16, f"one solver iteration launches {per_iter} device kernels > 16")
    phase("line_search_launches", t0, B=1, T=T, kernels_max_iters_1=per[1],
          kernels_max_iters_2=per[2], kernels_per_iteration=per_iter,
          traces_max_iters_1=counts[1], traces_max_iters_2=counts[2])
    out["kernels_per_iteration"] = per_iter
    return out


def bound_rel(a, b):
    """max|a - b| / max(1, max|b|) over the entries where |b| < 1e19; the
    entries at +-1e20 (rows switched off) must agree in sign and stay beyond
    1e19 (float32 rounds 1e20)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    off = b.abs() >= 1e19
    if bool(off.any()):
        same = torch.equal(torch.sign(a[off]), torch.sign(b[off])) and bool(
            (a[off].abs() >= 1e19).all())
        if not same:
            return float("inf")
    on = ~off
    if not bool(on.any()):
        return 0.0
    return float((a[on] - b[on]).abs().max() / b[on].abs().max().clamp_min(1.0))


def finite_abs(a, b):
    """max|a - b| over the entries where |b| < 1e19."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    on = b.abs() < 1e19
    return (a[on] - b[on]).abs().max() if bool(on.any()) else torch.zeros(())


def closed_loop_setup(device):
    """The example's MPC, model handler and ID in f32 (their construction
    runs the MPC's first solve and the ID's dry run)."""
    from simple_mpc_tpu_torch.examples.go2_kinodynamics import setup

    return setup(CLOSED_LOOP_T, device, torch.float32)


def loop_readings(mpc, mh, idq, log, q, v):
    """The timings of a closed-loop run for its phase line: p50/p99 on the
    host clock of the MPC iteration, of the tick's references (state
    derivatives, reference forces and the 10 interpolated targets), of the
    inner step (ID and simulator: the interpolation is not in it) and of
    the inner step with a tenth of its tick's references (the whole 1 kHz
    cost a step); the CUDA-event medians of the three inner kernels and of
    the state derivative at the loop's last state (q, v); profiler traces
    of 10 inner steps and of one tick's references; the host time of
    interpolating one inner step's state target against a tick's ten at
    once.  The launches of these timings are put back out of the counters."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator
    from simple_mpc_tpu_torch.utils.interpolator import Interpolator

    loop_launches = {k: k.launches for k in kernels.KERNELS}
    tick_ms = 1e3 * np.asarray(log["solve_time"])
    refs_ms = 1e3 * np.asarray(log["refs_time"])
    inner_ms = 1e3 * np.asarray(log["inner_time"])
    # the whole 1 kHz cost a step: the tick's references and targets shared
    # over its 10 inner steps, plus the step (ID and simulator)
    step_all_ms = refs_ms / 10 + inner_ms

    # the kernels at the loop's last state, and a trace of inner steps
    dev, dt = mpc.xs.device, mpc.xs.dtype
    qd = torch.as_tensor(q[-1], dtype=dt, device=dev)
    vd = torch.as_tensor(v[-1], dtype=dt, device=dev)
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device=dev)
    targets = {k: a[None] for k, a in idq._targets.items()}
    qb, vb = qd[None], vd[None]
    H, g, A, l, u = kernels.id_assemble(idq, qb, vb, targets)[:5]
    tau = idq.solve(0.0, qd, vd)
    wide = kernels.body_route(mh.model, idq.nk, idq.fdim) == "wide"
    pre = "wide_" if wide else ""
    kms = {f"{pre}id_assemble": cuda_ms(lambda: kernels.id_assemble(idq, qb, vb, targets), REPS),
           "qp_admm": cuda_ms(lambda: kernels.qp_admm(H, g, A, l, u, iters=60), REPS),
           f"{pre}sim_step": cuda_ms(lambda: kernels.sim_step(sim, qb, vb, tau[None]), REPS),
           f"{pre}state_derivative": cuda_ms(lambda: mpc.get_state_derivative(0), REPS)}

    def inner_steps():
        qq, vv = qd, vd
        for _ in range(10):
            t_ = idq.solve(0.0, qq, vv)
            qq, vv, _ = sim.step(qq, vv, t_)

    trace = trace_calls(inner_steps, n=3)

    # the tick's references (as examples/loop.py takes them) under the
    # profiler, and the interpolation of one inner step's targets against
    # a tick's ten at once, on the host clock
    interp = Interpolator(mh.model)
    xs, delays = mpc.xs[:2], [i * 1e-3 for i in range(10)]

    def refs():
        aa = torch.stack([mpc.get_state_derivative(0)[-mh.model.nv:],
                          mpc.get_state_derivative(1)[-mh.model.nv:]])
        interp.interpolate_state(delays, 0.01, xs)
        interp.interpolate_linear(delays, 0.01, aa)

    def host_ms(fn, reps=REPS):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t1) / reps

    refs_trace = trace_calls(refs, n=3)
    interp_ms = dict(one_delay=host_ms(lambda: interp.interpolate_state(3e-3, 0.01, xs)),
                     ten_delays=host_ms(lambda: interp.interpolate_state(delays, 0.01, xs)))
    for k, n in loop_launches.items():
        k.launches = n
    return dict(
        tick_p50_ms=float(np.percentile(tick_ms, 50)),
        tick_p99_ms=float(np.percentile(tick_ms, 99)),
        refs_p50_ms=float(np.percentile(refs_ms, 50)),
        refs_p99_ms=float(np.percentile(refs_ms, 99)),
        inner_step_p50_ms=float(np.percentile(inner_ms, 50)),
        inner_step_p99_ms=float(np.percentile(inner_ms, 99)),
        inner_step_with_refs_p50_ms=float(np.percentile(step_all_ms, 50)),
        inner_step_with_refs_p99_ms=float(np.percentile(step_all_ms, 99)),
        kernel_ms=kms, ten_inner_steps_trace=trace, tick_refs_trace=refs_trace,
        interpolate_state_host_ms=interp_ms)


def phase_closed_loop(device, mpc, mh, idq):
    """The Go2 kinodynamics closed loop of the port's example
    (examples/go2_kinodynamics.py: T=50, trot 10/30/10/30 at 0.2 m/s, apex
    0.05 m, mu_init 1e-8, the example's IDSettings with qp_iters 60, the
    simulator at dt 1e-3 with 10 inner steps a tick), f32, for
    CLOSED_LOOP_TICKS MPC ticks.  Gates (tests/test_walking.py:184-209):
    finite; base z within 0.08 m of its start; progress > 0.02 m; |v| < 20;
    stance feet slip < 2 cm between ticks.  Prints `loop_readings`."""
    from simple_mpc_tpu_torch.examples.go2_kinodynamics import run
    from simple_mpc_tpu_torch.ops import soa

    t0 = time.perf_counter()
    log = run(mpc, mh, idq, n_steps=CLOSED_LOOP_TICKS, log_every=0)
    wall = time.perf_counter() - t0
    q, v = np.stack(log["q"]), np.stack(log["v"])
    check(np.isfinite(q).all() and np.isfinite(v).all(), "closed loop: non-finite state")
    z0 = q[0, 2]
    check(bool((np.abs(q[:, 2] - z0) < 0.08).all()),
          f"closed loop: fell: base z {q[:, 2].min():.3f}..{q[:, 2].max():.3f}")
    check(q[-1, 0] - q[0, 0] > 0.02, f"closed loop: no progress: x {q[0, 0]:.4f} -> {q[-1, 0]:.4f}")
    check(np.abs(v).max() < 20.0, f"closed loop: |v| {np.abs(v).max():.2f} >= 20")
    ids = np.asarray(mh.feet_frame_ids)
    qt = torch.as_tensor(q.T)
    oR, op = soa.fk_world(mh.model, qt)
    fp = soa.frame_placements_world(mh.model, oR, op, ids)[1].permute(2, 0, 1).numpy()
    ground = fp[0, :, 2].mean()
    slip_max = 0.0
    for i in range(1, len(fp)):
        on = (fp[i - 1, :, 2] < ground + 0.005) & (fp[i, :, 2] < ground + 0.005)
        slip = np.linalg.norm(fp[i, :, :2] - fp[i - 1, :, :2], axis=1)
        if on.any():
            slip_max = max(slip_max, float(slip[on].max()))
    check(slip_max < 0.02, f"closed loop: stance slip {slip_max:.4f} m >= 0.02")
    phase("closed_loop", t0, T=CLOSED_LOOP_T, ticks=CLOSED_LOOP_TICKS, inner_steps_per_tick=10,
          dtype="float32", wall_s=wall, base_z=[float(q[:, 2].min()), float(q[:, 2].max())],
          progress_m=float(q[-1, 0] - q[0, 0]), max_abs_v=float(np.abs(v).max()),
          max_stance_slip_m=slip_max, **loop_readings(mpc, mh, idq, log, q, v))


def talos_closed_loop_setup(device):
    """The port's Talos example's MPC, model handler and ID in f32 at
    T=100 (their construction runs the MPC's first solve and the ID's dry
    run)."""
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import setup

    return setup(TALOS_LOOP_T, device, torch.float32)


def phase_talos_closed_loop(device, mpc, mh, idq):
    """The Talos kinodynamics closed loop of the port's example
    (examples/talos_kinodynamics.py, uncut: T=100, the biped gait
    20/80/20/80 at 0.1 m/s, apex 0.1 m, mu_init 1e-8, the example's weights
    and IDSettings with 6D feet, wrench cones and qp_iters 60, the simulator
    at dt 1e-3 with 10 inner steps a tick), f32, for TALOS_LOOP_TICKS MPC
    ticks.  Gates (the JAX package's smoke gate,
    tests/test_examples_smoke.py:36-40): finite; base z within 0.1 m of its
    start.  Prints `loop_readings`, the base height range, the progress and
    the contact forces' range."""
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import run

    t0 = time.perf_counter()
    log = run(mpc, mh, idq, n_steps=TALOS_LOOP_TICKS, log_every=0)
    wall = time.perf_counter() - t0
    q, v, f = np.stack(log["q"]), np.stack(log["v"]), np.stack(log["f"])
    check(np.isfinite(q).all() and np.isfinite(v).all(), "talos closed loop: non-finite state")
    z0 = q[0, 2]
    check(bool((np.abs(q[:, 2] - z0) < 0.1).all()),
          f"talos closed loop: fell: base z {q[:, 2].min():.3f}..{q[:, 2].max():.3f}")
    phase("talos_closed_loop", t0, T=TALOS_LOOP_T, ticks=TALOS_LOOP_TICKS,
          inner_steps_per_tick=10, dtype="float32", wall_s=wall,
          base_z=[float(q[:, 2].min()), float(q[:, 2].max())], base_z0=float(z0),
          progress_m=float(q[-1, 0] - q[0, 0]), max_abs_v=float(np.abs(v).max()),
          contact_fz_range=[float(f[..., 2].min()), float(f[..., 2].max())],
          **loop_readings(mpc, mh, idq, log, q, v))


def talos_case(device, dtype, nb, nT, seed, force_cone=False):
    """Talos kinodynamics (23 joints, two 6D quad feet) at half_sitting,
    horizon nT, batched nb times: the left foot lifted on stages 1, 5,
    9, ..., the right on stages 3, 7, ..., both down elsewhere; a warm start
    (states, forces and torques, joint accelerations) and multipliers
    perturbed from numpy with a fixed seed.  Returns (ocp, problems, xs, us,
    lam_eq, lam_in)."""
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.ocp.base import Problem
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = make_talos_kinodynamics(nT, device=device, dtype=dtype,
                                          force_cone=force_cone)
    sp = ocp.problem.stage_params
    act = sp.contact_active.clone()
    act[1::4, 0] = 0.0
    act[3::4, 1] = 0.0
    ocp.problem = Problem(x0=ocp.problem.x0, term_params=ocp.problem.term_params,
                          stage_params=sp._replace(contact_active=act))
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None, None], nb, 0).repeat(nT + 1, 1)
    xs = xs + 0.01 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = ocp.get_reference_control(0).double().cpu().numpy()
    scale = np.where(np.abs(u0) > 1.0, 20.0, 1.0)  # the normal forces
    us = u0 + scale * rng.normal(size=(nb, nT, ocp.nu))
    lam_eq = 0.1 * rng.normal(size=(nb, nT, ocp.n_eq))
    lam_in = 0.1 * np.abs(rng.normal(size=(nb, nT, ocp.n_in)))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return ocp, tile_problem(ocp.problem, nb), t(xs), t(us), t(lam_eq), t(lam_in)


def phase_talos_kernels(device, ptxas_log=""):
    """The three wide stage kernels (csrc/linearize_wide.cu) against their
    twins on the card, at the Talos main path's shapes (T=100, B=128, the
    perturbed problem of `talos_case`, feet lifted in turns), f32 and f64,
    and once more on a B=2, T=10 problem with the two 17-row wrench cones
    on.  Gates, as max|a - b| / max|b|: in f64 the kernel within 1e-10 of
    the twin; in f32 the kernel within F32_WIDE_TOL (per kernel) of the twin
    evaluated in f64 on the same (f32-rounded) inputs, the f32 twin's own
    distance printed beside it.  K3 (riccati_backward) and K4 (linear_rollout) at
    Talos widths (nx=56, nu=34) on the twin's linearization: gated in f64
    (K4 at 1e-10; K3 within ten times the twin's own spread under a 1e-15
    relative perturbation of its inputs), their f32 readings against the
    f32 twins printed.  Times:
    CUDA-event medians (the twins of K1+K2 and K5 on SLOW_REPS, K3's on
    one call), f32 twins only; the roofline bound at the main path's shapes; registers
    and stack of the three kernels from the ptxas log."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    out = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        f32 = dtype == torch.float32
        errs, abs_err, vs64, times = {}, {}, {}, {}

        def compare(name, got, want, want64):
            keep = [i for i, b in enumerate(want) if b.numel()]
            check(all(torch.isfinite(got[i]).all() for i in keep), f"{name} {dtype}: non-finite")
            ref = want64 if f32 else want
            tol = F32_WIDE_TOL[name] if f32 else 1e-10
            e = max(rel_err(got[i], ref[i]) for i in keep)
            check(np.isfinite(e) and e <= tol, f"{name} {dtype}: {e:.3e} > {tol:.1e}"
                  + (" from the f64 twin" if f32 else ""))
            errs[name] = max(errs.get(name, 0.0), e)
            abs_err[name] = max([abs_err.get(name, 0.0)] + [
                float((got[i].double() - want[i].double()).abs().max()) for i in keep])
            if f32:
                twin = max(rel_err(want[i], want64[i]) for i in keep)
                old = vs64.get(name, (0.0, 0.0))
                vs64[name] = (max(old[0], e), max(old[1], twin))

        def case(nb, nT, force_cone):
            ocp, probs, xs, us, lam_eq, lam_in = talos_case(device, dtype, nb, nT, seed=9,
                                                            force_cone=force_cone)
            solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, alphas=ALPHAS,
                                                       u_scale="auto"))
            eps = torch.finfo(dtype).eps
            mu = torch.full((nb,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
            lam_term = torch.zeros((nb, ocp.n_term_eq), dtype=dtype, device=device)
            sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
            tp = tree_map(torch.Tensor.contiguous, probs.term_params)
            lin_args = (solver, sp, xs, us, lam_eq, lam_in, mu)
            lin = kernels.wide_stage_linearize(*lin_args)
            lin0 = kernels._linearize_traj_plain(*lin_args)
            lin64 = kernels._linearize_traj_plain(*as64(lin_args)) if f32 else None
            compare("wide_stage_linearize", [lin[k] for k in kernels.LIN_KEYS],
                    [lin0[k] for k in kernels.LIN_KEYS],
                    lin64 and [lin64[k] for k in kernels.LIN_KEYS])
            term_args = (solver, xs[:, -1], tp, lam_term, mu)
            term = kernels.wide_term_linearize(*term_args)
            Vx, Vxx = kernels._linearize_term_plain(*term_args)
            compare("wide_term_linearize", term, (Vx, Vxx),
                    kernels._linearize_term_plain(*as64(term_args)) if f32 else None)
            reg = max(solver.settings.reg_init, 50 * eps)
            ks0, Ks0, Qus0 = kernels.riccati_backward_plain(lin0, Vx, Vxx, reg)
            dx0 = solver.space.difference(xs[:, 0], probs.x0)
            alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=device)
            xs_c, us_c = solver._candidates(xs, us, lin0, ks0, Ks0, dx0, alphas)
            eval_args = (solver, sp, xs_c, us_c, lam_eq, lam_in, mu)
            ev = kernels.wide_stage_eval(*eval_args)
            compare("wide_stage_eval", ev, kernels._eval_traj_plain(*eval_args),
                    kernels._eval_traj_plain(*as64(eval_args)) if f32 else None)
            return dict(ocp=ocp, solver=solver, lin_args=lin_args, lin=lin, lin0=lin0,
                        term_args=term_args, term=term, Vx=Vx, Vxx=Vxx, reg=reg,
                        ks0=ks0, Ks0=Ks0, Qus0=Qus0, dx0=dx0, alphas=alphas,
                        eval_args=eval_args, ev=ev)

        cone = case(TALOS_CONE_B, TALOS_CONE_T, True)
        check(cone["ocp"].n_in == 44 + 34, f"talos cones: {cone['ocp'].n_in} inequality rows")
        c = case(B, T, False)
        # K3 and K4 at Talos widths on the twin's linearization
        lin0, Vx, Vxx, reg = c["lin0"], c["Vx"], c["Vxx"], c["reg"]
        roll_args = (lin0["A"], lin0["B"], lin0["d"], c["ks0"], c["Ks0"], c["dx0"],
                     c["alphas"])
        k3 = kernels.riccati_backward(lin0, Vx, Vxx, reg)
        k3_0 = (c["ks0"], c["Ks0"], c["Qus0"].abs().amax(dim=(1, 2)))
        k4 = kernels.linear_rollout(*roll_args)
        k4_0 = kernels.linear_rollout_plain(*roll_args)
        k34 = dict(riccati_backward=max(rel_err(a, b) for a, b in zip(k3, k3_0)),
                   linear_rollout=max(rel_err(a, b) for a, b in zip(k4, k4_0)))
        if not f32:
            # K3 on this linearization is ill conditioned (AL weights 1/mu =
            # 1e6 beside the 1e5 foot weights): the kernel must agree with
            # the twin within 10x the twin's own response to a 1e-15
            # relative perturbation of its inputs, as K6 on the Go2 data
            g64 = torch.Generator(device=device).manual_seed(0)
            noisy = {k: v * (1 + 1e-15 * torch.randn(v.shape, generator=g64, dtype=dtype,
                                                     device=device)) for k, v in lin0.items()}
            k3_n = kernels.riccati_backward_plain(noisy, Vx, Vxx, reg)
            k34["riccati_backward_twin_spread"] = max(
                rel_err(a, b) for a, b in zip((k3_n[0], k3_n[1], k3_n[2].abs().amax(dim=(1, 2))),
                                              k3_0))
            check(k34["riccati_backward"] <= 10 * k34["riccati_backward_twin_spread"] + 1e-12
                  and k34["linear_rollout"] <= 1e-10, f"K3/K4 at Talos widths, f64: {k34}")
        slow = SLOW_REPS
        times = dict(
            wide_stage_linearize=cuda_ms(lambda: kernels.wide_stage_linearize(*c["lin_args"]),
                                         REPS),
            wide_term_linearize=cuda_ms(lambda: kernels.wide_term_linearize(*c["term_args"]),
                                        REPS),
            wide_stage_eval=cuda_ms(lambda: kernels.wide_stage_eval(*c["eval_args"]), REPS),
            riccati_backward=cuda_ms(lambda: kernels.riccati_backward(lin0, Vx, Vxx, reg), REPS),
            linear_rollout=cuda_ms(lambda: kernels.linear_rollout(*roll_args), REPS))
        if f32:
            plain = dict(
                wide_stage_linearize=cuda_ms(
                    lambda: kernels._linearize_traj_plain(*c["lin_args"]), slow),
                wide_term_linearize=cuda_ms(
                    lambda: kernels._linearize_term_plain(*c["term_args"]), slow),
                wide_stage_eval=cuda_ms(lambda: kernels._eval_traj_plain(*c["eval_args"]),
                                        slow),
                riccati_backward=cuda_ms(  # ~13 s a call: one timed call
                    lambda: kernels.riccati_backward_plain(lin0, Vx, Vxx, reg), 1),
                linear_rollout=cuda_ms(lambda: kernels.linear_rollout_plain(*roll_args), REPS))
            times = {k: (v, plain[k]) for k, v in times.items()}
        ocp, xs = c["ocp"], c["lin_args"][2]
        nx, nu = c["solver"].space.ndx, ocp.nu
        n_rows = ocp._const(xs)["w"].shape[0] + ocp.n_eq + ocp.n_in
        n_term = ocp._const(xs)["w_term"].shape[0] + ocp.n_term_eq
        na = len(ALPHAS)
        # per scenario: (counted FLOPs, bytes read and written), as phase_kernels
        per = dict(
            wide_stage_linearize=(T * 2 * n_rows * (nx * nx + nu * nu + nu * nx + nx + nu),
                                  nbytes((c["lin_args"][1:], c["lin"]))),
            wide_term_linearize=(2 * n_term * (nx * nx + nx),
                                 nbytes((c["term_args"][1:], c["term"]))),
            wide_stage_eval=(0, nbytes((c["eval_args"][1:], c["ev"]))),
            riccati_backward=(riccati_flops(1, T, nx, nu),
                              nbytes((lin0, Vx, Vxx, c["ks0"], c["Ks0"], c["Qus0"]))),
            linear_rollout=(na * T * (4 * nu * nx + 2 * nx * nx + 2 * nu + 2 * nx),
                            nbytes((roll_args, k4))))
        bounds = {k: roofline(f * B, m) for k, (f, m) in per.items()}
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"talos_kernels_{name}", t0, B=B, T=T, nq=ocp.nq, nv=ocp.nv, nu=nu,
              rows=n_rows, cone_case=dict(B=TALOS_CONE_B, T=TALOS_CONE_T, n_in=cone["ocp"].n_in),
              tol=F32_WIDE_TOL if f32 else 1e-10, rel_err=errs, max_abs_err=abs_err,
              kernel_and_twin_vs_f64_twin=vs64 or None,
              talos_k3_k4_rel_err_vs_twin=k34, ms=times,
              bound_ms=bounds if f32 else None,
              ptxas=ptxas_report(ptxas_log, ("linearize_wide_kernel", "eval_wide_kernel",
                                             "term_wide_kernel"), wide=True) if f32 else None)
    return out


def phase_talos_fixture(device):
    """Talos kinodynamics T=100 on the card against the committed f64
    fixture talos_kinodynamics_T100.npz.

    f32 (`phase_fixture`'s recipe, that of tests/test_parity_fixtures.py,
    run to the f32 floor): BCL 30 iterations, then rounds of 30 ungated
    multiplier iterations until a round leaves the iterate unchanged or
    after TALOS_F32_ROUNDS rounds.  Gates: prim < 1e-4, max|us - us*| <=
    3e-3 (the JAX package's pure-f32 gate on ~450 N forces), max|xs - xs*|
    <= 1e-3.  Every round's max|us - us*| is printed.

    f64: the fixture generator's own solve (tools/make_parity_fixtures.py
    `make`: BCL, tol 1e-8, mu_init 1e-4, 60 iterations from the standing
    start, continued while prim or dual >= 1e-6, at most 8 times):
    max|us - us*| <= 1e-4.  The three f64 multiplier iterations from the f32
    point of tests/test_parity_fixtures.py are printed, not gated: the line
    search stalls there (tests/test_torch_talos_fixture.py, slow)."""
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    t0 = time.perf_counter()
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "talos_kinodynamics_T100.npz"))

    def err(r, key="us"):
        return float(np.abs(getattr(r, key)[0].double().cpu().numpy() - fx[key]).max())

    def start(dtype):
        ocp, _, x0 = make_talos_kinodynamics(T, device=device, dtype=dtype)
        xs = ocp._tensor(x0)[None, None].expand(1, T + 1, -1).clone()
        us = ocp.get_reference_control(0)[None, None].expand(1, T, -1).clone()
        return ocp, tile_problem(ocp.problem, 1), xs, us

    mm = SolverSettings(tol=1e-7, mu_init=1e-4, max_iters=30, bcl=False)
    ocp, probs, xs, us = start(torch.float32)
    res = ProxDDPSolver(ocp, SolverSettings(tol=1e-7, mu_init=1e-4, max_iters=30)).run(
        probs, xs, us)
    s_mm = ProxDDPSolver(ocp, mm)
    per_round = []
    for _ in range(TALOS_F32_ROUNDS):
        prev = res.us
        res = s_mm.run(probs, res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term), res.mu)
        per_round.append(err(res))
        if torch.equal(res.us, prev):
            break
    prim, err_u, err_x = float(res.prim_res[0]), per_round[-1], err(res, "xs")
    check(prim < 1e-4, f"talos fixture re-solve: prim {prim:.3e} >= 1e-4")
    check(err_u <= 3e-3, f"talos fixture gate: max|us - us*| = {err_u:.3e} > 3e-3")
    check(err_x <= 1e-3, f"talos fixture gate: max|xs - xs*| = {err_x:.3e} > 1e-3")

    ocp64, probs64, xs, us = start(torch.float64)
    polish = ProxDDPSolver(ocp64, mm).run(
        probs64, res.xs.double(), res.us.double(),
        (res.lam_eq.double(), res.lam_in.double(), res.lam_term.double()), res.mu.double(),
        max_iters=3)
    check(bool(torch.isfinite(polish.us).all()), "talos fixture f64 polish: non-finite")
    s64 = ProxDDPSolver(ocp64, SolverSettings(tol=1e-8, mu_init=1e-4, max_iters=60))
    r64 = s64.run(probs64, xs, us)
    calls = 1
    while calls < 9 and not (float(r64.prim_res[0]) < 1e-6 and float(r64.dual_res[0]) < 1e-6):
        r64 = s64.run(probs64, r64.xs, r64.us, (r64.lam_eq, r64.lam_in, r64.lam_term), r64.mu)
        calls += 1
    err_u64 = err(r64)
    check(err_u64 <= 1e-4, f"talos fixture f64 solve: max|us - us*| = {err_u64:.3e} > 1e-4")
    phase("talos_fixture", t0, f32_rounds=len(per_round), prim_res=prim, max_abs_err_us=err_u,
          max_abs_err_us_per_round=per_round, max_abs_err_xs=err_x,
          f64_polish_3_iterations_max_abs_err_us=err(polish),
          f64_solve=dict(calls_of_60=calls, max_abs_err_us=err_u64,
                         max_abs_err_xs=err(r64, "xs"), prim_res=float(r64.prim_res[0]),
                         dual_res=float(r64.dual_res[0])))


def phase_talos_batched(device):
    """B=128 Talos kinodynamics T=100 problems in f32 from the committed
    fixture's point, each scenario's states, controls and multipliers
    perturbed from numpy with a fixed seed; the recipe of phase_batched
    (one iteration a call, mu_init 1e-6, two warm-up calls, then 30 calls
    each fed the last result).  Gates: finite, no divergence, the last
    call's max prim_res < 5e-4."""
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    t0 = time.perf_counter()
    dtype = torch.float32
    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "talos_kinodynamics_T100.npz"))
    ocp, mh, x0 = make_talos_kinodynamics(T, device=device, dtype=dtype)
    probs = tile_problem(ocp.problem, B)
    rng = np.random.default_rng(13)
    xs = fx["xs"][None] + 1e-3 * rng.normal(size=(B,) + fx["xs"].shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = fx["us"][None] + 0.1 * rng.normal(size=(B,) + fx["us"].shape)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    xs, us = t(xs), t(us)
    lams = tuple(t(np.repeat(fx[k][None], B, 0)) for k in ("lam_eq", "lam_in", "lam_term"))
    bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                         alphas=ALPHAS)))
    prims = []
    for _ in range(2):  # warm-up
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
    torch.cuda.synchronize()
    calls = 30
    t1 = time.perf_counter()
    for _ in range(calls):
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    s = {k: float(v) for k, v in bs.summary(res).items()}
    check(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
          and torch.isfinite(res.Ks).all(), "talos batched solve: non-finite iterate")
    check(s["any_diverged"] == 0, "talos batched solve: a scenario diverged")
    check(s["max_prim"] < 5e-4, f"talos batched solve: last max prim {s['max_prim']:.3e}")
    phase("talos_batched", t0, B=B, T=T, calls=calls, solves_per_s=B * calls / wall,
          ms_per_call=1e3 * wall / calls, max_prim_per_call=[float(p) for p in prims], **s)


def talos_host_mpc(device):
    """The host MPC of phase_talos_mpc (examples/talos_kinodynamics.py's
    biped gait and MPC settings, T=100, f32, first solve cut to 20
    iterations), walking at 0.1 m/s."""
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    ocp, mh, _ = make_talos_kinodynamics(T, device=device, dtype=torch.float32)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                          max_iters=1, swing_apex=0.1, T_fly=80, T_contact=20,
                          timestep=0.01, init_max_iters=20), ocp)
    check(not mpc.diverged, "talos MPC: initial solve diverged")
    l, r = mh.feet_names
    mpc.generate_cycle_horizon([{l: True, r: True}] * 20 + [{l: True, r: False}] * 80
                               + [{l: True, r: True}] * 20 + [{l: False, r: True}] * 80)
    mpc.switch_to_walk(np.array([0.1, 0, 0, 0, 0, 0]))
    return mpc


def phase_tick_traces(device):
    """Profiler readings (trace_calls: device kernels, device-busy and wall
    ms a call, idle share) of one tick of each B=1 path in f32, after two
    warm-up ticks: the fused tick (`step`, phase_fused), the latency tick
    (`step_donated`, phase_latency), the Go2, full-dynamics and Talos host
    MPC ticks (`iterate`, phases mpc, fd_mpc without the pyramids and
    talos_mpc) and one tick of each closed loop (the examples' `run` for one
    MPC tick from the reference state: the iteration, the tick's references
    and 10 inner steps).  It uses nothing this tree added to the port, so a
    copy of this script runs it in an older tree too, for holding two trees
    against each other in one call."""
    from simple_mpc_tpu_torch.examples import go2_kinodynamics, talos_kinodynamics

    t0 = time.perf_counter()
    fused, c1 = fused_engine(device)
    lat, c2 = fused_engine(device, parallel=True)
    go2, fd, talos = go2_host_mpc(device), fd_host_mpc(device, False)[0], talos_host_mpc(device)
    loop_go2, loop_talos = closed_loop_setup(device), talos_closed_loop_setup(device)
    calls = dict(
        fused_step=lambda: fused.step(c1, c1.xs[1]),
        latency_step_donated=lambda: lat.step_donated(c2, c2.xs[1]),
        go2_mpc_tick=lambda: go2.iterate(go2.xs[1]),
        fd_mpc_tick=lambda: fd.iterate(fd.xs[1]),
        talos_mpc_tick=lambda: talos.iterate(talos.xs[1]),
        go2_closed_loop_tick=lambda: go2_kinodynamics.run(*loop_go2, n_steps=1, log_every=0),
        talos_closed_loop_tick=lambda: talos_kinodynamics.run(*loop_talos, n_steps=1,
                                                              log_every=0))
    traces = {}
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        tr = trace_calls(fn, n=5)
        traces[name] = {k: tr[k] for k in ("kernels_per_call", "device_busy_ms", "wall_ms",
                                           "idle_share")}
    phase("tick_traces", t0, dtype="float32", traces=traces)
    return traces


def phase_talos_mpc(device):
    """The host MPC on Talos kinodynamics T=100 (the biped gait and
    MPCSettings of examples/talos_kinodynamics.py: 20 double / 80 left / 20
    double / 80 right, T_fly 80, T_contact 20, apex 0.1 m, mu_init 1e-8,
    walking at 0.1 m/s; the weights of configs.talos_kinodynamics_config;
    `init_max_iters` cut to 20), f32: 30 ticks fed their own planned next
    state, then 5 more under the profiler.  Gates: finite plans, no
    divergence."""
    t0 = time.perf_counter()
    mpc, setup = talos_host_mpc(device), time.perf_counter() - t0
    l = mpc.ocp_handler.model_handler.feet_names[0]
    ticks, lat, prims = 30, [], []
    for _ in range(ticks):
        x = mpc.xs[1]
        t1 = time.perf_counter()
        res = mpc.iterate(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        check(not mpc.diverged, "talos MPC: a tick diverged")
        check(bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
                   and torch.isfinite(res.Ks).all()), "talos MPC: non-finite plan")
        prims.append(float(res.prim_res))
    trace = trace_calls(lambda: mpc.iterate(mpc.xs[1]))
    lat_ms = 1e3 * np.asarray(lat)
    phase("talos_mpc", t0, T=T, ticks=ticks, setup_s=setup,
          tick_p50_ms=float(np.percentile(lat_ms, 50)),
          tick_p99_ms=float(np.percentile(lat_ms, 99)), max_prim=float(max(prims)),
          prim_per_tick=prims, takeoff=mpc.get_foot_takeoff_cycle(l),
          land=mpc.get_foot_land_cycle(l), tick_trace=trace)


def drive_main_path(device):
    """The main paths (phases 4-10, 12 and 14-16), each with the launch
    counters zeroed just before it (after its set-up) and read just after;
    returns the launches of each kernel summed over them."""
    from simple_mpc_tpu_torch import kernels

    launches = dict.fromkeys((k.__name__ for k in kernels.KERNELS), 0)
    for path, run, setup in (("batched", phase_batched, None), ("fixture", phase_fixture, None),
                             ("mpc", phase_mpc, None), ("fused", phase_fused, None),
                             ("latency", phase_latency, latency_setup),
                             ("fd_batched", phase_fd_batched, None),
                             ("fd_mpc", phase_fd_mpc, None),
                             ("closed_loop", phase_closed_loop, closed_loop_setup),
                             ("talos_batched", phase_talos_batched, None),
                             ("talos_fixture", phase_talos_fixture, None),
                             ("talos_mpc", phase_talos_mpc, None),
                             ("talos_closed_loop", phase_talos_closed_loop,
                              talos_closed_loop_setup)):
        args = setup(device) if setup else ()
        kernels.reset_launches()
        run(device, *args)
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"the {path} path never launched {name}")
        for name in PATH_ABSENT.get(path, ()):
            check(counts[name] == 0, f"the {path} path launched {name}")
        if path in PATH_EXACT:
            for name, n in PATH_EXACT[path].items():
                check(counts[name] == n, f"the {path} path launched {name} "
                      f"{counts[name]} times, not {n}")
        print(json.dumps({"phase": f"{path}_launches", "launches": counts}), flush=True)
        for name, n in counts.items():
            launches[name] += n
    return launches


PHASES = ("kernels", "fd_kernels", "id_sim_kernels", "fixture", "talos_kernels",
          "talos_fixture", "talos_id_sim_kernels", "talos_closed_loop", "line_search_kernels",
          "tick_traces")


def main():
    phases = None
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        phases = sys.argv[2].split(",")
        unknown = set(phases) - set(PHASES)
        if unknown:
            raise SystemExit(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    elif len(sys.argv) > 1:
        raise SystemExit("usage: chip_smoke.py [--phases " + ",".join(PHASES) + "]")
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.solver.proxddp import full_precision_matmuls

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    full_precision_matmuls()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, kind=kind, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, capability=list(torch.cuda.get_device_capability(0)))

    t0 = time.perf_counter()
    info = kernels.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "smem" in ln]
    phase("build", t0, nvcc_seconds=round(info["seconds"], 3), library=os.path.relpath(
        info["path"], ROOT), ptxas=ptxas)

    if phases is not None:
        runs = dict(kernels=phase_kernels, fd_kernels=phase_fd_kernels,
                    id_sim_kernels=lambda d: phase_id_sim_kernels(d, info["log"]),
                    fixture=phase_fixture,
                    talos_kernels=lambda d: phase_talos_kernels(d, info["log"]),
                    talos_fixture=phase_talos_fixture,
                    talos_id_sim_kernels=lambda d: phase_talos_id_sim_kernels(d, info["log"]),
                    talos_closed_loop=lambda d: phase_talos_closed_loop(
                        d, *talos_closed_loop_setup(d)),
                    line_search_kernels=phase_line_search_kernels, tick_traces=phase_tick_traces)
        for name in phases:
            runs[name](device)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()},
                          "phases": phases}), flush=True)
        return

    kres = phase_kernels(device)
    fdres = phase_fd_kernels(device)
    idres = phase_id_sim_kernels(device, info["log"])
    talres = phase_talos_kernels(device, info["log"])
    talidres = phase_talos_id_sim_kernels(device, info["log"])
    lsres = phase_line_search_kernels(device)
    launches = drive_main_path(device)

    replaces = dict(
        stage_linearize=("linearize.cu", "simple_mpc_tpu/solver/proxddp.py:271"),
        stage_eval=("linearize.cu", "simple_mpc_tpu/solver/proxddp.py:183"),
        riccati_backward=("riccati.cu", "simple_mpc_tpu/solver/proxddp.py:391"),
        parallel_riccati_backward=("parallel_riccati.cu",
                                   "simple_mpc_tpu/solver/parallel_riccati.py:59"),
        linear_rollout=("rollout.cu", "simple_mpc_tpu/solver/proxddp.py:458"),
        term_linearize=("linearize.cu", "simple_mpc_tpu/solver/proxddp.py:352"),
        tick_refs=("tick.cu", "simple_mpc_tpu/mpc/fused.py:175"),
        fd_stage_linearize=("fulldyn.cu", "simple_mpc_tpu/solver/proxddp.py:271"),
        fd_stage_eval=("fulldyn.cu", "simple_mpc_tpu/solver/proxddp.py:183"),
        fd_dynamics=("fulldyn.cu", "simple_mpc_tpu/ops/soa_dyn.py:199"),
        qp_admm=("qp.cu", "simple_mpc_tpu/id/qp.py:33"),
        id_assemble=("id.cu", "simple_mpc_tpu/id/kinodynamics_id.py:131"),
        sim_step=("sim.cu", "simple_mpc_tpu/sim/simulator.py:125"),
        wide_stage_linearize=("linearize_wide.cu", "simple_mpc_tpu/solver/proxddp.py:271"),
        wide_stage_eval=("linearize_wide.cu", "simple_mpc_tpu/solver/proxddp.py:183"),
        wide_term_linearize=("linearize_wide.cu", "simple_mpc_tpu/solver/proxddp.py:352"),
        state_derivative=("acc.cu", "simple_mpc_tpu/ocp/kinodynamics.py:531"),
        wide_state_derivative=("acc_wide.cu", "simple_mpc_tpu/ocp/kinodynamics.py:531"),
        wide_id_assemble=("id_wide.cu", "simple_mpc_tpu/id/kinodynamics_id.py:131"),
        wide_sim_step=("sim_wide.cu", "simple_mpc_tpu/sim/simulator.py:60"),
        candidate_integrate=("linesearch.cu", "simple_mpc_tpu/solver/proxddp.py:458"),
        line_search_select=("linesearch.cu", "simple_mpc_tpu/solver/proxddp.py:529"),
        state_difference=("linesearch.cu", "simple_mpc_tpu/solver/proxddp.py:527"),
        wide_line_search_select=("linesearch_wide.cu", "simple_mpc_tpu/solver/proxddp.py:529"),
    )
    # line_search_select also replaces the terminal AL cost and merit
    # (:207-217) and prim and the BCL update (:546-600)
    also = {k: ["simple_mpc_tpu/solver/proxddp.py:207", "simple_mpc_tpu/solver/proxddp.py:546"]
            for k in ("line_search_select", "wide_line_search_select")}
    # each kernel's readings from the phase that checked it (phase 3's
    # K3 and K4 are Go2's, qp_admm Go2's; the Talos phases' are printed
    # there); the closed loops' kernels at B=1
    checked = (kres["float32"], fdres["float32"], talres["float32"], lsres["float32"])
    loops = (idres["float32"], talidres["float32"])
    f32 = {k: {n: next(c[n][k] for c in checked if k in c["errs"])
               for n in ("abs_err", "times", "bounds")}
           for k in replaces if not any(k in c["errs"] for c in loops)}
    for c in reversed(loops):
        f32.update({k: dict(abs_err=c["abs_err"][k], times=c["times"]["B1"][k],
                            bounds=c["bounds"]["B1"][k]) for k in c["errs"]})
    shape = dict(parallel_riccati_backward=(1, T), fd_dynamics=(1, 1), qp_admm=(1, 1),
                 id_assemble=(1, 1), sim_step=(1, 1), state_derivative=(1, 1),
                 wide_state_derivative=(1, 1), wide_id_assemble=(1, 1),
                 wide_sim_step=(1, 1))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simple_mpc_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": f32[name]["abs_err"], "ms": f32[name]["times"][0],
         "plain_ms": f32[name]["times"][1], "bound_ms": f32[name]["bounds"][0],
         "bound_by": f32[name]["bounds"][1], "library_ms": None,
         "B": shape.get(name, (B, T))[0], "T": shape.get(name, (B, T))[1],
         "dtype": "float32", **({"also_replaces": also[name]} if name in also else {})}
        for name, (src, rep) in replaces.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
