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
               K1+K2, K3 and K5 on SLOW_REPS calls after a warm-up).  Then
               the full-dynamics kernels (K7 inside): fd_stage_linearize (u_scale None and
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
               each B=1 path, for holding two trees against each other; the
               Talos and full-dynamics ticks' device kernels gated at their
               Go2 counterpart's plus TICK_KERNEL_SLACK.
 21. talos_tick_kernels — (after phase 19) K9 at Talos widths
               (wide_tick_refs, csrc/tick_wide.cu) against its twin on
               B=128 carries of a Talos walking stream, f32 and f64.
 22. k6_wide_kernels — K6 at the new latency ticks' widths (Talos nx=56,
               nu=34; full dynamics 36, 12, with and without the friction
               pyramids) against its twin on the card's linearizations, f64
               gated, f32 printed; shared memory a block, combine times.
 23. talos_fused, talos_latency — the fused tick on Talos kinodynamics
               T=100 (configs.make_talos_fused: B=128 step_batched, B=1
               step) and its parallel=True engine (phase 8's readings and
               20-tick rollout gate), f32.
 24. fd_fused, fd_latency — the same on Go2 full dynamics T=50 (B=1
               step; configs.make_go2_fd_fused, pyramids cut as in 10),
               gated at feasibility_gate against the same ticks in f64.
 25. talos_fd_kernels — (after phase 22) the wide full-dynamics kernels
               of csrc/fulldyn_wide.cu (K7 with 6D LOCAL_WORLD_ALIGNED
               contacts at 23 joints: wide_fd_stage_linearize,
               wide_fd_stage_eval, wide_fd_dynamics) and the wide K5 and
               select on a full-dynamics OCP against their twins, f32 and
               f64, on one iteration's inputs of Talos full dynamics at
               B=128, T=100, of a B=2, T=10 problem with the wrench cones,
               landing rows and Baumgarte gains, and of a real iterate of
               the Talos walking stream at B=1 (phase_talos_fd_kernels
               states the gates); times, bounds, registers, stack, shared
               memory and the device memory the first launch takes.
 26. talos_fd_batched — 30 one-iteration solves of B=128 Talos
               full-dynamics T=100 problems, f32, from the quasistatic
               warm start: last max prim < 1e-3 (or 10 % above the same
               stream in f64 where that misses it); solves/s.
 27. talos_fd_mpc — the host MPC on Talos full dynamics T=100 (the
               example's gait), f32, 40 self-fed ticks: finite, no
               divergence, stage-0 wrenches unilateral with Σfz within 35 %
               of m g; tick p50/p99 and one tick's trace.
 28. talos_fd_closed_loop — (after the main paths) a reading, not gated:
               the port's examples/talos_fulldynamics.py on the card at its
               own T=100 (Riccati feedback at 1 kHz into the simulator), 30
               ticks, f32 and f64, on the example's plant (a point contact
               at each sole) and on one with the quad feet's corner points;
               the first tick out of JAX's smoke band, the base z range and
               the largest |v| before it.  On the example's plant the robot
               leaves the band within a few ticks in either precision, so
               this closed loop is not a main path (ROADMAP Queue 3).
 29. talos_centroidal_kernels — (after phase 25) the centroidal kernels
               against their twins on the card at B=128, T=100 and at B=1,
               f32 and f64 (one iteration's inputs of a perturbed Talos
               centroidal problem, cent_iteration, and CentroidalID's
               assembly on perturbed states with a foot in swing,
               cent_id_case): the stage linearization, the candidates, K5
               and the ODE of csrc/centroidal.cu, the vector-space integrate
               and gap, the select of csrc/linesearch_centroidal.cu and
               csrc/id_centroidal.cu; f64 within 1e-10, f32 within ten times
               the f32 twin's own distance from the f64 twin; times, bounds,
               registers and stack.  Then `talos_centroidal_sass`: each
               locked unit's SASS digest against LOCKED_SASS (gated when
               nvcc's release is LOCKED_SASS_NVCC).
 30. talos_centroidal_batched — 30 one-iteration calls of B=128 Talos
               centroidal T=100 problems from a perturbed iterate, f32: the
               first call's max prim above 5e-4, each call's within ten
               times the same stream's in f64 or under the f32 merit's
               floor, the last a tenth of the first and < 5e-4 (or 10 %
               above the f64 stream's); solves/s.
 31. talos_centroidal_mpc — the example's host MPC (T=100, the biped gait),
               f32, 40 ticks: finite, no divergence, stage-0 wrenches
               unilateral with Σfz within 35 % of m g; tick p50/p99, wrapper
               launches a tick and one tick's trace.
 32. talos_centroidal_closed_loop — the port's examples/talos_centroidal.py
               at JAX's own gate (T=50, 25 ticks: finite, base z within 0.1
               m); loop_readings.  Then `talos_centroidal_swing`, also a
               main path: the same loop past its horizon, into the first 8
               ticks of single support at stage 0 (CentroidalID's swing
               rows): finite, in the band, the swing sole unloaded and the
               stance sole carrying m g within 35 % on average.  After the main paths,
               a reading at the example's T=100 (30 ticks) against the 10 ms
               and 1 ms budgets (`talos_centroidal_closed_loop_T100`, not
               gated).
Phases 4-10, 12, 14-16, 18, 23-24, 26, 27 and 30-32 drive the main paths; every solver call
launches state_difference once and candidate_integrate and
line_search_select once an iteration (its wide instance on Talos).  The
kernels' launch counters are zeroed just before each of them (after the
latency engine's and the closed loops' set-up, whose first solves run
before the path) and read just after (a `<phase>_launches` line): each
must have launched every kernel it runs (phase 7 the nine of the serial
tick; phase 8 the same with K6 in place of K3, and K3 never; phases 23-24
the same on their models, Talos with the wide kernels and wide_tick_refs,
never tick_refs; phases 9-10
the full-dynamics stage kernels and never the kinodynamics ones; phases 12
and 18 the eight solver kernels exactly once a tick, the three inner
kernels exactly once an inner step and the state derivative exactly twice
a tick, phase 18 the wide ones of each and never the Go2 ones; phases
14-16 the four wide kernels, K3 and K4's rollout, integrate and initial
gap, and never the Go2 stage kernels; no Go2 phase a wide kernel; phases
26 and 27 the wide full-dynamics kernels with the wide K5 and select, and
never a kinodynamics or Go2 full-dynamics stage kernel, and no other path
those; phases 30-32 the centroidal kernels with K3 and K4's rollout and no
multibody stage, select, integrate, gap, ID or derivative kernel, phase 32
each solver kernel exactly once a tick, the three inner kernels
(centroidal_id_assemble, qp_admm, wide_sim_step) once an inner step and the
centroidal ODE twice a tick, and no other path a centroidal kernel).  The
kernel summary's `launches` is the sum over those twenty-one runs; the
launches of phases 3, 11, 13, 17, 19, 21, 22, 25, 28 and 29 and of phases
12's, 18's and 32's timings are not counted.  Its `bound_ms` is the larger of the bytes each
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
import math
import os
import subprocess
import sys
import time
import warnings

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
SLOW_REPS = 1  # the torch.func twins of K1+K2 and K5 and the f64 twin of K3
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
# the fused and latency ticks on Talos (wide K9, K1+K2, K1, K5, select) and
# on Go2 full dynamics (Go2's K9 and the full-dynamics stage kernels)
TALOS_TICK_KERNELS = WIDE_KERNELS + ("linear_rollout", "candidate_integrate",
                                     "state_difference", "wide_tick_refs")
FD_TICK_KERNELS = ("fd_stage_linearize", "fd_stage_eval", "linear_rollout", "term_linearize",
                   "tick_refs") + LS_KERNELS
PATH_KERNELS.update(talos_fused=TALOS_TICK_KERNELS + ("riccati_backward",),
                    talos_latency=TALOS_TICK_KERNELS + ("parallel_riccati_backward",),
                    fd_fused=FD_TICK_KERNELS + ("riccati_backward",),
                    fd_latency=FD_TICK_KERNELS + ("parallel_riccati_backward",))
PATH_KERNELS["closed_loop"] = SOLVER_KERNELS + INNER_KERNELS + ("state_derivative",)
# Talos full dynamics (wide K7, its K5 and select) on the batched solver,
# the host MPC (its contact wrenches through K7 alone) and the
# Riccati-feedback closed loop (K7 alone for the state derivatives, the wide
# simulator a step)
TALOS_FD_SOLVER_KERNELS = ("wide_fd_stage_linearize", "wide_fd_stage_eval",
                           "wide_term_linearize", "wide_line_search_select", "riccati_backward",
                           "linear_rollout", "candidate_integrate", "state_difference")
WIDE_FD_KERNELS = ("wide_fd_stage_linearize", "wide_fd_stage_eval", "wide_fd_dynamics")
PATH_KERNELS.update(talos_fd_batched=TALOS_FD_SOLVER_KERNELS,
                    talos_fd_mpc=TALOS_FD_SOLVER_KERNELS + ("wide_fd_dynamics",))
PATH_KERNELS["talos_closed_loop"] = (TALOS_SOLVER_KERNELS + TALOS_INNER_KERNELS
                                     + ("wide_state_derivative",))
TALOS_FD_LOOP_TICKS = 30  # tests/test_examples_smoke.py:43 runs 25


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
_LOOP_ABSENT = ("parallel_riccati_backward", "tick_refs", "wide_tick_refs", "fd_stage_linearize",
                "fd_stage_eval", "fd_dynamics")
PATH_ABSENT = dict(latency=("riccati_backward",),
                   fd_batched=("stage_linearize", "stage_eval"),
                   fd_mpc=("stage_linearize", "stage_eval"),
                   closed_loop=_LOOP_ABSENT,
                   talos_batched=GO2_STAGE_KERNELS, talos_fixture=GO2_STAGE_KERNELS,
                   talos_mpc=GO2_STAGE_KERNELS,
                   talos_closed_loop=GO2_STAGE_KERNELS + _LOOP_ABSENT
                   + ("id_assemble", "sim_step", "state_derivative"))
PATH_ABSENT.update(talos_fused=GO2_STAGE_KERNELS + ("tick_refs", "parallel_riccati_backward"),
                   talos_latency=GO2_STAGE_KERNELS + ("tick_refs", "riccati_backward"),
                   fd_fused=("stage_linearize", "stage_eval", "parallel_riccati_backward"),
                   fd_latency=("stage_linearize", "stage_eval", "riccati_backward"))
# no Go2 path launches a wide kernel
for _path in ("batched", "fixture", "mpc", "fused", "latency", "fd_batched", "fd_mpc",
              "closed_loop", "fd_fused", "fd_latency"):
    PATH_ABSENT[_path] = (PATH_ABSENT.get(_path, ()) + WIDE_KERNELS + WIDE_LOOP_KERNELS
                          + ("wide_tick_refs",))
# no kinodynamics path launches a full-dynamics kernel; the Talos
# full-dynamics paths launch neither the Go2 nor the kinodynamics stage
# kernels, no fused-tick kernel, and their closed loop no ID
_KINO_STAGE = ("stage_linearize", "stage_eval", "wide_stage_linearize", "wide_stage_eval",
               "state_derivative", "wide_state_derivative")
_GO2_FD = ("fd_stage_linearize", "fd_stage_eval", "fd_dynamics", "term_linearize",
           "line_search_select")
for _path in PATH_KERNELS:
    if not _path.startswith("talos_fd"):
        PATH_ABSENT[_path] = PATH_ABSENT.get(_path, ()) + WIDE_FD_KERNELS
for _path in ("talos_fd_batched", "talos_fd_mpc"):
    PATH_ABSENT[_path] = (_KINO_STAGE + _GO2_FD + ("tick_refs", "wide_tick_refs",
                                                     "parallel_riccati_backward"))
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


def fd_case(device, dtype, seed, force_cone=True):
    """Go2 full-dynamics T=100 standing problem (all 68 inequality rows;
    48 without `force_cone`, the friction pyramids) batched B times, with a
    perturbed warm start (states and torques) and positive inequality
    multipliers, made from numpy with a fixed seed."""
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = make_go2_fulldynamics(T, device=device, dtype=dtype, force_cone=force_cone)
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
    fix the contact forces (wrenches with 6D contacts) nearest the force
    references f_ref, the joint rows then give tau."""
    from simple_mpc_tpu_torch.ops import soa, soa_dyn

    m = ocp.model
    q = torch.as_tensor(np.asarray(x0[: ocp.nq], np.float64))[:, None]
    v = torch.zeros((m.nv, 1), dtype=torch.float64)
    oR, op = soa.fk_world(m, q)
    Sw = soa.world_axes(m, oR, op)
    b = soa_dyn.nle_world(m, oR, op, Sw, soa.body_velocities(m, Sw, v), v)[:, 0]
    J = soa_dyn.contact_jacobians(m, oR, op, Sw, ocp.feet_fids, ocp.fs)[0][..., 0]  # (fs nk, nv)
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


def feasibility_gate(prims, reference=None):
    """(max, median) limits of a stream of prim_res: the JAX bench's 5e-3
    and 5e-4 (`bench.py:346`, `:460`), or, where the same stream solved in
    f64 on the card (`reference`, its prims) misses them, 10 % above that
    stream's own reading: one iteration a tick does not reach the bench's
    gate there in any precision, and the f32 tick must not lose more."""
    lim = np.array([5e-3, 5e-4])
    if reference is None:
        return lim
    ref = np.array([max(reference), float(np.median(reference))])
    return np.maximum(lim, 1.1 * ref)


FUSED_TICKS = 20  # ticks of each timed loop and of the rollout gate (phases 7-8, 23-24)


def reference_prims(engine, device):
    """The f64 streams the feasibility gates of another model's engine are
    held to: prim_res of `engine(device, dtype=torch.float64)` from its
    pristine carry, (the B=1 loop of phase_fused: `step` fed its own xs[1],
    2 + FUSED_TICKS ticks of which the first two are warm-up;
    `self_rollout` over 2 FUSED_TICKS ticks, past the gait's first swing
    entering the horizon: tick 11 of the full-dynamics trot, tick 21 of the
    Talos gait).  Made before a path's counters are zeroed: its launches
    are a comparison's, not the path's."""
    fused, carry = engine(device, dtype=torch.float64)
    rollout = fused.self_rollout(carry, 2 * FUSED_TICKS)[1][2].cpu().numpy().tolist()
    prims = []
    for _ in range(2 + FUSED_TICKS):
        carry, res = fused.step(carry, carry.xs[1])
        prims.append(float(res.prim_res))
    return dict(step=prims[2:], rollout=rollout)


def phase_fused(device, name="fused", engine=None, batched=True, reference=None):
    """The fused tick: B=128 self-fed step_batched ticks, one tick in
    sync-debug "error" mode (with `batched`), then B=1 `step` latency.
    `engine(device)` gives (fused, carry): the bench's Go2 engine unless
    another is given, with its f64 `reference` streams (reference_prims);
    `name` heads the phase line.  Without `batched` the B=1 ticks carry the
    feasibility gate (feasibility_gate's max, against the same ticks in
    f64)."""
    t0 = time.perf_counter()
    fused, carry = (engine or fused_engine)(device)
    setup = time.perf_counter() - t0
    ticks, line = FUSED_TICKS, {}
    if batched:
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
        prim = torch.zeros((), dtype=res.prim_res.dtype, device=device)
        bad = torch.zeros((), dtype=torch.bool, device=device)
        t1 = time.perf_counter()
        for _ in range(ticks):
            cb, res = fused.step_batched(cb, cb.xs[:, 1])
            prim = torch.maximum(prim, res.prim_res.max())
            bad = bad | res.diverged.any() | ~torch.isfinite(res.Ks).all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        check(not bool(bad), f"{name} B={B}: a scenario diverged or produced a non-finite plan")
        check(bool(torch.isfinite(cb.xs).all() and torch.isfinite(cb.us).all()),
              f"{name} B={B}: non-finite carry")
        max_prim = float(prim)
        check(max_prim < 5e-3, f"{name} B={B} lost feasibility: max prim {max_prim:.3e}")
        line = dict(B=B, ticks=ticks, ticks_per_s=B * ticks / wall,
                    ms_per_batched_tick=1e3 * wall / ticks, max_prim=max_prim,
                    sync_debug_tick="ok")

    lat, prims = [], []
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
              f"{name} B=1: non-finite plan")
        prims.append(float(r1.prim_res))
    if not batched:
        # the B=1 ticks carry the feasibility gate of the B=128 ones
        ref = reference["step"]
        gate = float(feasibility_gate(prims, ref)[0])
        check(max(prims) < gate, f"{name} B=1 lost feasibility: max prim {max(prims):.3e} "
              f">= {gate:.3e} (f64 {max(ref):.3e})")
        line = dict(max_prim=max(prims), prim_per_tick=prims, f64_prim_per_tick=ref,
                    max_prim_gate=gate)
    if reference is not None:
        # printed, not gated: a self-fed rollout from the pristine carry
        # past the gait's first swing entering the horizon, in f32 and f64
        line["long_rollout_prim_per_tick"] = (
            fused.self_rollout(carry, 2 * ticks)[1][2].cpu().numpy().tolist())
        line["f64_long_rollout_prim_per_tick"] = reference["rollout"]
    lat_ms = 1e3 * np.asarray(lat)
    phase(name, t0, T=fused.T, nx=fused.solver.space.ndx, nu=fused.ocp.nu, setup_s=setup,
          **line, step_p50_ms=float(np.percentile(lat_ms, 50)),
          step_p99_ms=float(np.percentile(lat_ms, 99)), step_prim=float(r1.prim_res),
          step_trace=trace)


def latency_setup(device):
    """The latency engine (its host MPC's first solve runs the serial
    pass, as the JAX bench's does): (fused, pristine carry, seconds)."""
    t0 = time.perf_counter()
    fused, carry = fused_engine(device, parallel=True)
    torch.cuda.synchronize()
    return fused, carry, time.perf_counter() - t0


def phase_latency(device, fused, carry0, setup_s, name="latency", reference=None):
    """The B=1 latency path (bench.py:357-464 at full precision):
    pipelined `step_donated`, eager `step`, and the self-fed rollout gate;
    `name` heads the phase line and its messages.  With `reference` (the
    engine's f64 streams, reference_prims) the rollout's gate is
    feasibility_gate's against the same rollout in f64."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    t0 = time.perf_counter()
    reps, k, ticks = 10, 20, FUSED_TICKS
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
    check(not bool(bad), f"{name}: step_donated diverged or planned non-finite controls")

    c1, lat = tree_map(torch.clone, carry0), []
    for i in range(2 + ticks):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c1, r1 = fused.step(c1, c1.xs[1])
        torch.cuda.synchronize()
        if i >= 2:
            lat.append(1e3 * (time.perf_counter() - t2))
        check(not bool(r1.diverged) and bool(torch.isfinite(r1.us).all()),
              f"{name}: eager step diverged or planned non-finite controls")

    trace = trace_calls(lambda: fused.step_donated(carry, carry.xs[1]))
    _, (us0, xs1, prims) = fused.self_rollout(carry0, ticks)
    p = prims.double().cpu().numpy()
    check(bool(torch.isfinite(us0).all() and torch.isfinite(xs1).all()),
          f"{name}: non-finite self-fed rollout")
    max_prim, med_prim = float(p.max()), float(np.median(p))
    ref = None if reference is None else reference["rollout"][:ticks]
    gate = feasibility_gate(p, ref)
    check(max_prim < gate[0] and med_prim < gate[1],
          f"{name} path lost feasibility: max prim {max_prim:.3e}, median {med_prim:.3e} "
          f"(gates {gate[0]:.3e}, {gate[1]:.3e})")
    extra = {}
    if ref is not None:
        # printed, not gated: the rollout continued past the gait's first
        # swing entering the horizon, in f32 and in f64
        extra = dict(rollout_prim_per_tick=p.tolist(), f64_rollout_prim_per_tick=ref,
                     rollout_gates=gate.tolist(),
                     long_rollout_prim_per_tick=fused.self_rollout(carry0, 2 * ticks)[1][2]
                     .cpu().numpy().tolist(),
                     f64_long_rollout_prim_per_tick=reference["rollout"])
    phase(name, t0, T=fused.T, B=1, setup_s=setup_s, **extra, reps=reps, ticks_per_rep=k,
          donated_p50_ms=float(np.median(pipe)), donated_p99_ms=float(max(pipe)),
          step_p50_ms=float(np.percentile(lat, 50)),
          step_p99_ms=float(np.percentile(lat, 99)),
          rollout_ticks=ticks, rollout_max_prim=max_prim, rollout_median_prim=med_prim,
          donated_trace=trace)


FUSED_INIT_ITERS = 20  # the first solve of the Talos and full-dynamics engines (100 cut to 20)


def talos_fused_engine(device, parallel=False, dtype=torch.float32):
    """Talos kinodynamics T=100 on the fused tick (`configs.make_talos_fused`:
    the port's examples/talos_kinodynamics.py weights, biped gait 20/80/20/80
    at 0.1 m/s, T_fly 80, T_contact 20, apex 0.1 m, mu_init 1e-8; the first
    solve cut to FUSED_INIT_ITERS iterations, as phase_talos_mpc's);
    serial Riccati, or K6 with `parallel`.  Returns (fused, carry)."""
    from simple_mpc_tpu_torch.configs import make_talos_fused

    return make_talos_fused(T, device=device, dtype=dtype, parallel=parallel,
                            init_max_iters=FUSED_INIT_ITERS)


def fd_fused_engine(device, parallel=False, dtype=torch.float32):
    """Go2 full dynamics T=50 on the fused tick (`configs.make_go2_fd_fused`:
    examples/go2_fulldynamics.py's MPC settings and trot at 0.2 m/s, the
    friction pyramids cut as in phase_fd_mpc, the first solve cut to
    FUSED_INIT_ITERS iterations); serial Riccati, or K6 with `parallel`.
    Returns (fused, carry)."""
    from simple_mpc_tpu_torch.configs import make_go2_fd_fused

    return make_go2_fd_fused(FD_MPC_T, device=device, dtype=dtype, parallel=parallel,
                             init_max_iters=FUSED_INIT_ITERS)


def phase_talos_fused(device, reference=None):
    """The fused tick on Talos kinodynamics T=100 (talos_fused_engine, f32):
    phase_fused's B=128 step_batched ticks (ticks/s, max prim < 5e-3, one
    tick without a host sync) and B=1 `step` p50/p99.  Its latency engine
    is phase_latency's `talos_latency` (talos_latency_setup)."""
    phase_fused(device, "talos_fused", talos_fused_engine, reference=reference
                or reference_prims(talos_fused_engine, device))


def phase_fd_fused(device, reference=None):
    """The fused tick on Go2 full dynamics T=50 (fd_fused_engine, f32):
    B=1 `step` p50/p99, every tick finite and not diverged, max prim
    within feasibility_gate against the same ticks in f64 (the trot's first
    swing entering the horizon lifts prim to ~3.9e-2 in f32 and f64 alike,
    as on the host MPC).  Its latency engine is phase_latency's
    `fd_latency` (fd_latency_setup)."""
    phase_fused(device, "fd_fused", fd_fused_engine, batched=False, reference=reference
                or reference_prims(fd_fused_engine, device))


def wide_latency_setup(device, name, engine):
    """(fused, pristine carry, seconds, name, f64 reference streams) of
    phase_latency on another model's latency engine."""
    t0 = time.perf_counter()
    fused, carry = engine(device, parallel=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    return fused, carry, setup_s, name, reference_prims(
        lambda d, dtype: engine(d, parallel=True, dtype=dtype), device)


def talos_latency_setup(device):
    return wide_latency_setup(device, "talos_latency", talos_fused_engine)


def fd_latency_setup(device):
    return wide_latency_setup(device, "fd_latency", fd_fused_engine)


def walking_tick_batch(device):
    """B carries of the Talos fused engine (f64, T=100) taken from one
    self-fed walk of B ticks, stacked into a batch, every fourth scenario
    switched to STANDING, with measurements perturbed from each carry's
    xs[1] and base velocities from numpy with a fixed seed.  Returns (fused
    engine, batched carry, measurements)."""
    from simple_mpc_tpu_torch.mpc.mpc import STANDING
    from simple_mpc_tpu_torch.ocp.base import tree_map

    n = B
    fused, carry = talos_fused_engine(device, dtype=torch.float64)
    carries = []
    for _ in range(n):
        carry, _ = fused.step(carry, carry.xs[1])
        carries.append(carry)
    cb = tree_map(lambda *a: torch.stack(a), *carries)
    rng = np.random.default_rng(11)
    now = cb.now.clone()
    now[1::4] = STANDING
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    cb = cb._replace(now=now, velocity_base=cb.velocity_base + t(0.1 * rng.normal(size=(n, 6))))
    x = cb.xs[:, 1] + t(0.01 * rng.normal(size=cb.xs[:, 1].shape))
    x[:, 3:7] /= x[:, 3:7].norm(dim=-1, keepdim=True)
    return fused, cb, x


def phase_talos_tick_kernels(device):
    """K9 at Talos widths (`wide_tick_refs`, csrc/tick_wide.cu) against its
    twin `tick_refs_plain` on B=128 carries of a Talos walking stream
    (walking_tick_batch: swings, pending events and standing scenarios).
    Gates: the walking flags and the int32 queues equal the twin's in f32
    and f64; in f64 the swing endpoints, the references and the CoM target
    within 1e-10 of the twin (max|a - b| / max|b|); in f32 within ten times
    the f32 twin's own distance from the f64 twin on the same inputs,
    both twins run on the CPU (the F32_WIDE_TOL rule, measured in the
    run).  Times at B=128 and B=1, the roofline bound (bytes)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map

    out, fields = {}, ("p_init", "p_final", "refs", "com_ref")
    base = walking_tick_batch(device)
    pending = int((base[1].land < kernels.EMPTY // 2).sum())
    lifted = int((base[1].stage_params.contact_active == 0).any(dim=(1, 2)).sum())
    check(pending > 0 and lifted > 0, f"talos tick batch: {pending} events, {lifted} swings")
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        if dtype == torch.float64:
            fused, cb, x = base
        else:
            fused = talos_fused_engine(device, dtype=dtype)[0]
            cast = lambda a: a.to(dtype) if a.is_floating_point() else a  # noqa: E731
            cb, x = tree_map(cast, base[1]), cast(base[2])
        check(kernels.stage_route(fused.ocp) == "wide", "talos tick: not the wide route")
        n = kernels.wide_tick_refs.launches
        got = kernels.tick_refs(fused, cb, x)
        check(kernels.wide_tick_refs.launches == n + 1, "tick_refs did not hand Talos over")
        want = kernels.tick_refs_plain(fused, cb, x)
        for k in ("walking", "takeoff", "land"):
            check(torch.equal(getattr(got, k), getattr(want, k)),
                  f"wide_tick_refs {dtype}: {k} differs from the twin")
        if dtype == torch.float64:
            err = max(rel_err(getattr(got, k), getattr(want, k)) for k in fields)
            tol, twin = 1e-10, None
        else:
            cpu = lambda a: a.cpu()  # noqa: E731
            up = lambda a: a.double() if a.is_floating_point() else a  # noqa: E731
            c_cpu, x_cpu = tree_map(cpu, cb), x.cpu()
            ref = kernels.tick_refs_plain(fused, tree_map(up, c_cpu), x_cpu.double())
            mine = kernels.tick_refs_plain(fused, c_cpu, x_cpu)
            twin = max(rel_err(getattr(mine, k), getattr(ref, k)) for k in fields)
            err = max(rel_err(getattr(got, k), getattr(ref, k)) for k in fields)
            tol = 10 * twin
        check(np.isfinite(err) and err <= tol,
              f"wide_tick_refs {dtype}: {err:.3e} > {tol:.3e}")
        c1, x1 = tree_map(lambda a: a[:1].contiguous(), cb), x[:1].contiguous()
        times = {nb: (cuda_ms(lambda: kernels.tick_refs(fused, c, xx), REPS),
                      cuda_ms(lambda: kernels.tick_refs_plain(fused, c, xx), REPS))
                 for nb, c, xx in ((B, cb, x), (1, c1, x1))}
        moved = nbytes((x, cb.stage_params.contact_active[:, T - 1], cb.now, cb.plan,
                        cb.takeoff, cb.land, cb.p_init, cb.p_final, cb.velocity_base,
                        cb.com0_z, got))
        bounds = {nb: roofline(0, moved * nb / B) for nb in (B, 1)}
        abs_err = max(float((getattr(got, k).double() - getattr(want, k).double()).abs().max())
                      for k in fields)
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=dict(wide_tick_refs=err), abs_err=dict(wide_tick_refs=abs_err),
                         times=dict(wide_tick_refs=times[B]),
                         bounds=dict(wide_tick_refs=bounds[B]))
        phase(f"talos_tick_kernels_{name}", t0, B=B, T=T, nq=fused.ocp.nq, nk=fused.nk,
              pending_land_events=pending, scenarios_with_a_swing=lifted,
              rel_err=err, tol=tol, f32_twin_vs_f64_twin_cpu=twin, max_abs_err=abs_err,
              ms_kernel_vs_plain={f"B{nb}": v for nb, v in times.items()},
              bound_ms={f"B{nb}": v for nb, v in bounds.items()})
    return out


# JAX's own f32 `parallel_backward` against its f64 value on each
# formulation's linearization rounded to f32, at the f32 penalty floor
# (tests/test_torch_parallel_riccati_wide.py `test_f32_witness`, T=8, CPU:
# max|.|/max|.| over ks and Ks, the larger of its two scenarios), printed
# beside the kernel's f32 readings, which are not gated: without Jacobi
# scaling the function keeps about three digits on Talos and one on full
# dynamics whoever evaluates it
JAX_F32_K6 = dict(talos=8.3e-4, fd=0.229)


def k6_case(device, dtype, robot, nb):
    """The LQ data K6 takes on the card: the Talos kinodynamics (talos_case)
    or Go2 full-dynamics linearization at T=100 (fd_case: "fd" the 48 rows
    of the full-dynamics latency tick, "fd_pyramids" all 68) through the
    card's stage kernels, and its terminal Vx, Vxx; B=nb scenarios.
    Returns (lin, Vx, Vxx, reg)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    eps = torch.finfo(dtype).eps
    mu = torch.full((nb,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
    if robot == "talos":
        ocp, probs, xs, us, lam_eq, lam_in = talos_case(device, dtype, nb, T, seed=9)
        solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, u_scale="auto"))
        sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
        lin = kernels.wide_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
    else:
        ocp, probs, xs, us, lam_in = fd_case(device, dtype, seed=5,
                                             force_cone=robot == "fd_pyramids")
        xs, us, lam_in = (a[:nb].contiguous() for a in (xs, us, lam_in))
        lam_eq = torch.zeros((nb, T, 0), dtype=dtype, device=device)
        solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6))
        sp = tree_map(lambda a: a[:nb].contiguous(), probs.stage_params)
        lin = kernels.fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
    tp = tree_map(lambda a: a[:nb].contiguous(), probs.term_params)
    lam_term = torch.zeros((nb, ocp.n_term_eq), dtype=dtype, device=device)
    Vx, Vxx = kernels.term_linearize(solver, xs[:, -1], tp, lam_term, mu)
    return lin, Vx, Vxx, max(solver.settings.reg_init, 50 * eps)


def finite_rel(a, b):
    """rel_err over the entries where b is finite (None if there are none)."""
    keep = torch.isfinite(b)
    return rel_err(a[keep], b[keep]) if bool(keep.any()) else None


def phase_k6_wide_kernels(device):
    """K6 (`parallel_riccati_backward`, csrc/parallel_riccati.cu as it is)
    at the widths of the new latency ticks: Talos kinodynamics (nx=56,
    nu=34) and Go2 full dynamics (nx=36, nu=12; the 48 rows of the latency
    tick, and all 68 with the friction pyramids), on linearizations made
    on the card (k6_case) at B=128 and B=1.  Gates: finite where the twin
    is finite; in f64 the twin finite and the kernel within
    max(1e-10, ten times the twin's own response to a 1e-15 relative move
    of its inputs), as max|a - b| / max|b|; in f32 the kernel's and the f32
    twin's distances from the f64 twin on the same inputs (over the
    entries where that is finite) printed beside JAX's own f32 loss
    (JAX_F32_K6), and the non-finite entries counted.  Each kernel's
    dynamic shared memory a block against the device's opt-in maximum; the
    combine's time (profiler) and the whole call's at B=1 and B=128; the
    roofline bound with the 191 combines of a work-efficient scan."""
    from simple_mpc_tpu_torch import kernels

    out = {}
    optin = kernels.smem_optin(device)
    for robot in ("talos", "fd", "fd_pyramids"):
        t0 = time.perf_counter()
        line = {}
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).replace("torch.", "")
            lin, Vx, Vxx, reg = k6_case(device, dtype, robot, B)
            nx, nu = lin["B"].shape[-2:]
            res = {}
            for nb in (B, 1):
                args = ({k: v[:nb].contiguous() for k, v in lin.items()},
                        Vx[:nb].contiguous(), Vxx[:nb].contiguous())
                got = kernels.parallel_riccati_backward(*args, reg)[:2]
                twin = kernels.parallel_riccati_backward_plain(*args, reg)[:2]
                fin = [torch.isfinite(b) for b in twin]
                r = dict(non_finite=sum(int((~f).sum()) for f in fin),
                         kernel_non_finite=sum(int((~torch.isfinite(a)).sum()) for a in got),
                         kernel_vs_twin=max(finite_rel(a, b) or 0.0 for a, b in zip(got, twin)))
                # where the twin is finite the kernel must be; where it is not
                # (the f32 pass on the pyramid rows), f32 rounding decides
                # which pivots fail, and the counts are printed
                check(r["non_finite"] > 0 or r["kernel_non_finite"] == 0,
                      f"K6 {robot} B={nb} {dname}: non-finite where the twin is finite")
                if dtype == torch.float64:
                    check(r["non_finite"] == 0, f"K6 {robot} B={nb} f64: the twin is not finite")
                    g64 = torch.Generator(device=device).manual_seed(0)
                    noisy = {k: v * (1 + 1e-15 * torch.randn(v.shape, generator=g64,
                                                             dtype=dtype, device=device))
                             for k, v in args[0].items()}
                    spread = kernels.parallel_riccati_backward_plain(noisy, *args[1:], reg)[:2]
                    r["twin_spread"] = max(rel_err(a, b) for a, b in zip(spread, twin))
                    r["tol"] = max(1e-10, 10 * r["twin_spread"])
                    check(r["kernel_vs_twin"] <= r["tol"], f"K6 {robot} B={nb} f64: {r}")
                else:
                    ref = kernels.parallel_riccati_backward_plain(
                        {k: v.double() for k, v in args[0].items()}, args[1].double(),
                        args[2].double(), reg)[:2]
                    r.update(kernel_vs_f64=[finite_rel(a, b) for a, b in zip(got, ref)],
                             twin_vs_f64=[finite_rel(a, b) for a, b in zip(twin, ref)],
                             jax_f32_vs_f64_cpu_t8=JAX_F32_K6.get(robot))
                call = lambda a=args: kernels.parallel_riccati_backward(*a, reg)  # noqa: E731
                ev, _ = profile_kernels(call, REPS)
                r.update(ms=cuda_ms(call, REPS),
                         plain_ms=cuda_ms(lambda a=args: kernels.parallel_riccati_backward_plain(
                             *a, reg), 3 if nb == B else REPS),
                         device_ms=k6_kernel_ms(ev, T, REPS),
                         bound=roofline(parallel_riccati_flops(nb, T, nx, nu),
                                        nbytes((args, got)) + nbytes(got)))
                res[f"B{nb}"] = r
            smem = kernels.parallel_riccati_smem(nx, nu, dtype)
            check(max(smem.values()) <= optin, f"K6 {robot} {dname}: {smem} > {optin}")
            line[dname] = dict(res, smem_bytes=smem)
        out[robot] = line
        phase(f"k6_wide_kernels_{robot}", t0, T=T, nx=int(nx), nu=int(nu),
              smem_optin_bytes=optin, **line)
    return out


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
    # the centroidal loop: its ID's and its 9-dim ODE's kernels, and its
    # state interpolated linearly
    cent = kernels._is_centroidal(mpc.ocp_handler)
    id_name = "centroidal_id_assemble" if kernels._is_centroidal_id(idq) else f"{pre}id_assemble"
    sd_name = "centroidal_state_derivative" if cent else f"{pre}state_derivative"
    kms = {id_name: cuda_ms(lambda: kernels.id_assemble(idq, qb, vb, targets), REPS),
           "qp_admm": cuda_ms(lambda: kernels.qp_admm(H, g, A, l, u, iters=60), REPS),
           f"{pre}sim_step": cuda_ms(lambda: kernels.sim_step(sim, qb, vb, tau[None]), REPS),
           sd_name: cuda_ms(lambda: mpc.get_state_derivative(0), REPS)}

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
    state = interp.interpolate_linear if cent else interp.interpolate_state

    def refs():
        aa = torch.stack([mpc.get_state_derivative(0)[-mh.model.nv:],
                          mpc.get_state_derivative(1)[-mh.model.nv:]])
        state(delays, 0.01, xs)
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
    interp_ms = dict(one_delay=host_ms(lambda: state(3e-3, 0.01, xs)),
                     ten_delays=host_ms(lambda: state(delays, 0.01, xs)))
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


# the fused and latency ticks of Talos and full dynamics launch at most this
# many device kernels more than the Go2 tick of the same engine (the same
# bookkeeping and one iteration; other parameter leaves to roll and write)
TICK_KERNEL_SLACK = 8
# the B=1 ticks of the fused engines of other models, beside their Go2
# counterpart
WIDE_TICKS = dict(talos_fused_step="fused_step", talos_latency_step_donated="latency_step_donated",
                  fd_fused_step="fused_step", fd_latency_step_donated="latency_step_donated")


def phase_tick_traces(device):
    """Profiler readings (trace_calls: device kernels, device-busy and wall
    ms a call, idle share) of one tick of each B=1 path in f32, after two
    warm-up ticks: the fused tick (`step`, phase_fused), the latency tick
    (`step_donated`, phase_latency), the Go2, full-dynamics and Talos host
    MPC ticks (`iterate`, phases mpc, fd_mpc without the pyramids and
    talos_mpc), one tick of each closed loop (the examples' `run` for one
    MPC tick from the reference state: the iteration, the tick's references
    and 10 inner steps), and, where the tree has their engines, the Talos
    and full-dynamics fused `step` and latency `step_donated` (phases
    talos_fused and fd_fused).  Each tick's device kernels are also counted
    with call_kernels; those of the Talos and full-dynamics ticks are gated
    at their Go2 counterpart's plus TICK_KERNEL_SLACK.  Apart from those
    engines it uses nothing this tree added to the port, so a copy of this
    script runs it in an older tree too, for holding two trees against each
    other in one call."""
    from simple_mpc_tpu_torch import configs
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
    if hasattr(configs, "make_talos_fused"):
        engines = dict(talos_fused_step=talos_fused_engine(device),
                       talos_latency_step_donated=talos_fused_engine(device, parallel=True),
                       fd_fused_step=fd_fused_engine(device),
                       fd_latency_step_donated=fd_fused_engine(device, parallel=True))
        for name, (f, c) in engines.items():
            step = f.step_donated if name.endswith("donated") else f.step
            calls[name] = lambda step=step, c=c: step(c, c.xs[1])
    traces = {}
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        tr = trace_calls(fn, n=5)
        traces[name] = {k: tr[k] for k in ("kernels_per_call", "device_busy_ms", "wall_ms",
                                           "idle_share")}
        traces[name]["kernels_counted"] = call_kernels(fn)
    for name, go2_name in WIDE_TICKS.items():
        if name in traces:
            n, n_go2 = traces[name]["kernels_counted"], traces[go2_name]["kernels_counted"]
            check(0 < n <= n_go2 + TICK_KERNEL_SLACK,
                  f"the {name} tick launches {n} device kernels, its Go2 counterpart {n_go2}")
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


# ---------------------------------------------------------------------------
# Talos full dynamics (6D contacts, 23 joints): the wide K7
# ---------------------------------------------------------------------------

TALOS_FD_CONE_B, TALOS_FD_CONE_T = 2, 10  # the cones-and-landing case of phase_talos_fd_kernels
TWIN_CHUNK = 64  # scenarios a call of the full-dynamics twins takes (their memory on the card)
TALOS_FD_MPC_TICKS = 40
TALOS_FD_LOOP_T = 100  # the example's own horizon (phase_talos_fd_closed_loop)
# f32 wide full-dynamics kernels vs their twin in f64 (see
# phase_talos_fd_kernels): ten times the f32 twin's own distance from the
# f64 twin in that phase's recipe ("twin_vs64" of talos_fd_check, the
# largest over its three cases, read by the phase on an NVIDIA H100 80GB
# HBM3 at 700 W: 2.7e-4, 1.8e-4, 4.2e-3, 1.5e-6 and 1.0e-7, each from the
# walking stream's iterate)
F32_TALOS_FD_TOL = dict(wide_fd_stage_linearize=2.7e-3, wide_fd_stage_eval=1.8e-3,
                        wide_fd_dynamics=4.3e-2, wide_term_linearize=1.5e-5,
                        wide_line_search_select=1.0e-6)


def talos_fd_ocp(device, dtype, nT, force_cone=False, land=False):
    """`configs.make_talos_fulldynamics` at horizon nT; with `land` the
    landing equalities on and the Baumgarte gains of
    tests/test_torch_talos_fd.py (kp, kd vectors) set.  Returns (ocp, mh,
    x0)."""
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP

    ocp, mh, x0 = make_talos_fulldynamics(nT, device=device, dtype=dtype,
                                          force_cone=force_cone)
    if land:
        s = ocp.settings
        s.land_cstr = True
        s.Kp_correction, s.Kd_correction = np.linspace(5.0, 30.0, 6), np.linspace(0.5, 4.0, 6)
        ocp = FullDynamicsOCP(s, mh, device, dtype)
        ocp.create_problem(x0, nT, 6, -9.81, False)
    return ocp, mh, x0


def talos_fd_case(device, dtype, nb, nT, seed, force_cone=False, land=False):
    """Talos full dynamics at half_sitting, horizon nT, batched nb times:
    the left foot lifted on stages 1, 5, 9, ..., the right on 3, 7, ...
    (the landing flag on the stage after each lift), the reference foot
    rotations turned by up to ~0.1 rad; a warm start (states, and joint
    torques about the quasistatic ones) and multipliers perturbed from numpy
    with a fixed seed.  Returns (ocp, problems, xs, us, lam_eq, lam_in)."""
    from scipy.spatial.transform import Rotation

    from simple_mpc_tpu_torch.ocp.base import Problem
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = talos_fd_ocp(device, dtype, nT, force_cone, land)
    rng = np.random.default_rng(seed)
    sp = ocp.problem.stage_params
    act, lnd = sp.contact_active.clone(), sp.land.clone()
    act[1::4, 0] = 0.0
    act[3::4, 1] = 0.0
    lnd[2::4, 0] = 1.0
    lnd[4::4, 1] = 1.0
    turn = Rotation.from_rotvec(0.05 * rng.normal(size=(nT * ocp.nk, 3))).as_matrix()
    R = sp.foot_ref_R @ torch.as_tensor(turn.reshape(nT, ocp.nk, 3, 3), dtype=dtype,
                                        device=device)
    ocp.problem = Problem(x0=ocp.problem.x0, term_params=ocp.problem.term_params,
                          stage_params=sp._replace(contact_active=act, land=lnd,
                                                   foot_ref_R=R.contiguous()))
    xs = np.repeat(x0[None, None], nb, 0).repeat(nT + 1, 1)
    xs = xs + 0.01 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = standing_torques(ocp, x0) + 5.0 * rng.normal(size=(nb, nT, ocp.nu))
    lam_eq = 0.1 * rng.normal(size=(nb, nT, ocp.n_eq))
    lam_in = 0.1 * np.abs(rng.normal(size=(nb, nT, ocp.n_in)))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return ocp, tile_problem(ocp.problem, nb), t(xs), t(us), t(lam_eq), t(lam_in)


def talos_fd_stream_case(device, dtype, ticks=5):
    """One real iterate of a Talos walking stream: the host MPC of
    phase_talos_fd_mpc in `dtype` after `ticks` self-fed ticks (the left
    foot's swing in the horizon), as a B=1 case: (ocp, problems, xs, us,
    lam_eq, lam_in)."""
    from simple_mpc_tpu_torch.parallel import tile_problem

    mpc = talos_fd_host_mpc(device, dtype)
    for _ in range(ticks):
        mpc.iterate(mpc.xs[1])
    ocp = mpc.ocp_handler
    return (ocp, tile_problem(ocp.problem, 1), mpc.xs[None].contiguous(),
            mpc.us[None].contiguous(), mpc.lams[0][None].contiguous(),
            mpc.lams[1][None].contiguous())


def chunked(fn, solver, nb, *args, size=TWIN_CHUNK):
    """fn(solver, *args) over the leading axis `size` at a time (every
    tensor leaf with a leading axis of nb is cut), the outputs joined along
    their leading axis: the full-dynamics twins' torch.func sweep over a
    whole B=128 batch would hold tens of GB on the card."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    def cut(a, sl):
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return tree_map(lambda x: cut(x, sl), a)
        return a[sl] if torch.is_tensor(a) and a.dim() and a.shape[0] == nb else a

    outs = [fn(solver, *[cut(a, slice(s, s + size)) for a in args])
            for s in range(0, nb, size)]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return tuple(torch.cat(parts) for parts in zip(*outs))


def talos_fd_iteration(case, dtype, device):
    """The inputs of each wide kernel in one solver iteration on a
    talos_fd_case (or stream case): the linearization's, the terminal
    Jacobian's, the candidates' evaluation (K3 and the rollout through the
    kernels), the dynamics' on the B*T stage lanes and the select's
    (ls_case's schedule: mu at the dtype's floor, omega unset)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, probs, xs, us, lam_eq, lam_in = case
    nb, nT = us.shape[:2]
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, alphas=ALPHAS, u_scale="auto"))
    st = solver.settings
    eps = torch.finfo(dtype).eps
    mu = torch.full((nb,), max(1e-6, eps ** 0.5), dtype=dtype, device=device)
    lam_term = torch.zeros((nb, ocp.n_term_eq), dtype=dtype, device=device)
    sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
    tp = tree_map(torch.Tensor.contiguous, probs.term_params)
    x0 = probs.x0.contiguous()
    lin_args = (sp, xs, us, lam_eq, lam_in, mu)
    lin = kernels.wide_fd_stage_linearize(solver, *lin_args)
    term_args = (xs[:, -1], tp, lam_term, mu)
    Vx, Vxx = kernels.wide_term_linearize(solver, *term_args)
    ks, Ks, dual = solver._backward(lin, Vx, Vxx, max(st.reg_init, 50 * eps))
    alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=device)
    dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks, Ks,
                                      kernels.state_difference(solver, xs[:, 0], x0), alphas)
    xs_c, us_c = kernels.candidate_integrate(solver, xs, us, dxs, dus)
    eval_args = (sp, xs_c, us_c, lam_eq, lam_in, mu)
    costs, g, h, gap = kernels.wide_fd_stage_eval(solver, *eval_args)
    eta = torch.clamp(mu ** st.bcl_alpha, min=float(st.tol))
    omega = torch.full((nb,), -1.0, dtype=dtype, device=device)
    sel_args = (xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in, lam_term, mu, eta,
                omega, dual, alphas)
    dyn_args = (xs[:, :-1].reshape(nb * nT, -1).contiguous(),
                us.reshape(nb * nT, -1).contiguous(),
                tree_map(lambda a: a.reshape((nb * nT,) + a.shape[2:]).contiguous(), sp))
    return dict(solver=solver, ocp=ocp, lin_args=lin_args, lin=lin, term_args=term_args,
                term=(Vx, Vxx), eval_args=eval_args, ev=(costs, g, h, gap),
                sel_args=sel_args, dyn_args=dyn_args)


def talos_fd_runs(it):
    """{kernel: (the kernel's call, its twin's call)} on one iteration's
    inputs (talos_fd_iteration); each call takes that input tuple (as64
    gives the f64 twin's).  The twins of the linearization, the candidates
    and the dynamics run TWIN_CHUNK scenarios at a time."""
    from simple_mpc_tpu_torch import kernels

    s, ocp = it["solver"], it["ocp"]
    nb, nT = it["lin_args"][2].shape[:2]

    def dyn_plain(_, *a):
        return kernels.fd_dynamics_plain(ocp, *a)

    return dict(
        wide_fd_stage_linearize=(
            "lin_args", lambda a: kernels.wide_fd_stage_linearize(s, *a),
            lambda a: chunked(kernels._linearize_traj_plain, s, nb, *a)),
        wide_fd_stage_eval=(
            "eval_args", lambda a: kernels.wide_fd_stage_eval(s, *a),
            lambda a: chunked(kernels._eval_traj_plain, s, nb, *a)),
        wide_fd_dynamics=(
            "dyn_args", lambda a: kernels.wide_fd_dynamics(ocp, *a),
            lambda a: chunked(dyn_plain, s, nb * nT, *a, size=TWIN_CHUNK * nT)),
        wide_term_linearize=(
            "term_args", lambda a: kernels.wide_term_linearize(s, *a),
            lambda a: kernels._linearize_term_plain(s, *a)),
        wide_line_search_select=(
            "sel_args", lambda a: kernels.wide_line_search_select(s, *a),
            lambda a: kernels.line_search_select_plain(s, *a)))


def unit_rel(a, b):
    """ls_rel relative to max(1, the largest finite |b|): the f32 readings
    of the full-dynamics kernels, whose gaps at a near-feasible iterate
    (~1e-4) carry the f32 roundoff of the states they difference."""
    e = ls_rel(a, b)
    if not np.isfinite(e) or e == 0.0:
        return e
    fin = torch.isfinite(b)
    return e * max(float(b[fin].double().abs().max()), 1e-300) / max(
        1.0, float(b[fin].double().abs().max()))


def outputs(r):
    """A kernel's or twin's result as a list of tensors."""
    if torch.is_tensor(r):
        return [r]
    return list(r.values()) if isinstance(r, dict) else list(r)


def event_ms(fn):
    """(fn(), the milliseconds of that one call by CUDA events on the
    card, by the host clock elsewhere)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        return fn(), 1e3 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def talos_fd_check(it, f32):
    """Each wide kernel of `talos_fd_runs` against its twin on one
    iteration's inputs: {name: dict(rel (ls_rel, the worst output),
    max_abs, and the select's `same_steps`)}; in f32 also the kernel's
    ("vs64") and the f32 twin's ("twin_vs64") distance from the f64 twin on
    the same inputs (unit_rel; the select's over the scenarios where each
    picked the f64 twin's step size; "other_picks" counts the kernel's
    others), and "twin_ms" the one call of the twin (event_ms).
    "twin_vs64" is the reading behind F32_TALOS_FD_TOL."""
    out = {}
    for name, (key, kern, twin) in talos_fd_runs(it).items():
        got = kern(it[key])
        want, twin_ms = event_ms(lambda: twin(it[key]))
        pairs = [(a, b) for a, b in zip(outputs(got), outputs(want)) if b.numel()]
        r = dict(rel=max(ls_rel(a, b) for a, b in pairs),
                 max_abs=max(float(finite_abs(a, b)) for a, b in pairs), twin_ms=twin_ms)
        sel = name == "wide_line_search_select"
        if sel:
            r["same_steps"] = bool(torch.equal(got.alpha, want.alpha))
        if f32:
            w = twin(as64(it[key]))
            for tag, res in (("vs64", got), ("twin_vs64", want)):
                if sel:
                    same = res.alpha.double() == w.alpha
                    r[tag] = max(unit_rel(a[same], b[same]) for a, b in zip(res, w))
                    if tag == "vs64":
                        r["other_picks"] = int((~same).sum())
                else:
                    r[tag] = max(unit_rel(a, b) for a, b in zip(outputs(res), outputs(w))
                                 if b.numel())
        out[name] = r
    return out


def talos_fd_cases(device, dtype):
    """The three cases of phase_talos_fd_kernels: {name: a maker of the
    case}."""
    return dict(
        B128=lambda: talos_fd_case(device, dtype, B, T, seed=11),
        cones_land=lambda: talos_fd_case(device, dtype, TALOS_FD_CONE_B, TALOS_FD_CONE_T,
                                         seed=12, force_cone=True, land=True),
        stream_B1=lambda: talos_fd_stream_case(device, dtype))


def phase_talos_fd_kernels(device, ptxas_log=""):
    """The three wide full-dynamics kernels (csrc/fulldyn_wide.cu:
    wide_fd_stage_linearize, wide_fd_stage_eval, wide_fd_dynamics) and the
    wide K5 and select on a full-dynamics OCP against their twins on the
    card, f32 and f64, on one iteration's inputs (talos_fd_iteration) of
    three cases: the Talos main path's shapes (T=100, B=128, the example's
    problem, talos_fd_case with the feet lifted in turns), a B=2, T=10
    problem with the two 17-row wrench cones, the landing equalities and
    Baumgarte gains on, and B=1 at a real iterate of the Talos walking
    stream (talos_fd_stream_case).  Gates, as ls_rel (the worst output,
    relative to its largest entry): in f64 every kernel within 1e-10 of its
    twin and the select's step sizes identical; in f32 every kernel within
    F32_TALOS_FD_TOL of the twin evaluated in f64 on the same inputs (the
    select on the scenarios where it picked the f64 twin's step size), the
    f32 twin's own distance printed beside.  Times: CUDA-event medians of
    the kernels at B=128 (REPS) and of their twins (the check's one call; the
    linearization's, the candidates' and the dynamics' over TWIN_CHUNK
    pieces); bounds by roofline at the main path's shapes; registers and
    stack of the three kernels from the ptxas log; the device memory free
    before and after the first launch of the wide linearization in each
    dtype (the local memory CUDA reserves for its stack)."""
    from simple_mpc_tpu_torch import kernels

    out = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        f32 = dtype == torch.float32
        errs, abs_err, per_case = {}, {}, {}
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info(device)[0]
        for cname, make in talos_fd_cases(device, dtype).items():
            it = talos_fd_iteration(make(), dtype, device)
            if cname == "B128":
                torch.cuda.synchronize()
                free1 = torch.cuda.mem_get_info(device)[0]
                main = it
            res = talos_fd_check(it, f32)
            if cname == "B128":
                twin_ms = {k: r["twin_ms"] for k, r in res.items()}
            for name, r in res.items():
                if f32:
                    tol = F32_TALOS_FD_TOL[name]
                    check(r["vs64"] <= tol, f"{name} {cname} f32: {r['vs64']:.3e} > {tol:.1e} "
                          "from the f64 twin")
                else:
                    check(r["rel"] <= 1e-10, f"{name} {cname} f64: rel err {r['rel']:.3e}")
                    check(r.get("same_steps", True),
                          f"{name} {cname} f64: another step size than the twin's")
                errs[name] = max(errs.get(name, 0.0), r["vs64"] if f32 else r["rel"])
                abs_err[name] = max(abs_err.get(name, 0.0), r["max_abs"])
            per_case[cname] = dict(B=it["lin_args"][1].shape[0], T=it["lin_args"][2].shape[1],
                                   n_eq=it["ocp"].n_eq, n_in=it["ocp"].n_in, readings=res)
        runs = talos_fd_runs(main)
        times = {name: cuda_ms(lambda f=f, a=main[key]: f(a), REPS)
                 for name, (key, f, _) in runs.items()}
        # K3 (csrc/riccati.cu as it is) at nx=56, nu=22 on the kernels'
        # linearization: timed, and in f32 its distance from its twin
        # printed (K3 is held to its twin at other widths elsewhere)
        lin, (Vx, Vxx) = main["lin"], main["term"]
        reg = max(main["solver"].settings.reg_init, 50 * torch.finfo(dtype).eps)
        k3_out = kernels.riccati_backward(lin, Vx, Vxx, reg)
        times["riccati_backward"] = cuda_ms(
            lambda: kernels.riccati_backward(lin, Vx, Vxx, reg), REPS)
        if f32:
            k3, twin_ms["riccati_backward"] = event_ms(
                lambda: kernels.riccati_backward_plain(lin, Vx, Vxx, reg))
            k3_rel = max(unit_rel(a, b) for a, b in zip(k3_out[:2], k3[:2]))
            times = {name: (t, twin_ms[name]) for name, t in times.items()}
        ocp, s = main["ocp"], main["solver"]
        nx, nu = s.space.ndx, ocp.nu
        n_rows = ocp._const(main["lin_args"][1])["w"].shape[0] + ocp.n_eq + ocp.n_in
        n_term = ocp._const(main["lin_args"][1])["w_term"].shape[0] + ocp.n_term_eq
        nc = ocp.fs * ocp.nk
        na = len(ALPHAS)
        k7 = k7_flops(ocp.nv, nc)
        sel_out = runs["wide_line_search_select"][1](main["sel_args"])
        dyn_out = runs["wide_fd_dynamics"][1](main["dyn_args"])
        # (counted FLOPs of the whole call, bytes read and written), as
        # phase_fd_kernels: the GN products and K7's factorizations and
        # solves, once in primal and once along each tangent direction
        per = dict(
            wide_fd_stage_linearize=(
                B * T * (2 * n_rows * (nx * nx + nu * nu + nu * nx + nx + nu)
                         + (nx + nu + 1) * k7), nbytes((main["lin_args"], main["lin"]))),
            wide_fd_stage_eval=(B * na * T * k7, nbytes((main["eval_args"], main["ev"]))),
            wide_fd_dynamics=(B * T * k7, nbytes((main["dyn_args"], dyn_out))),
            wide_term_linearize=(B * 2 * n_term * (nx * nx + nx),
                                 nbytes((main["term_args"], main["term"]))),
            wide_line_search_select=(0, select_bytes(main["sel_args"], sel_out)),
            riccati_backward=(riccati_flops(B, T, nx, nu), nbytes((lin, Vx, Vxx, k3_out))))
        bounds = {k: roofline(f, m) for k, (f, m) in per.items()}
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"talos_fd_kernels_{name}", t0, B=B, T=T, nq=ocp.nq, nv=ocp.nv, nu=nu,
              rows=n_rows, contact_rows=nc, cases=per_case,
              tol=F32_TALOS_FD_TOL if f32 else 1e-10, rel_err=errs, max_abs_err=abs_err,
              ms=times, bound_ms=bounds if f32 else None,
              device_free_gb_before_after_first_launch=[free0 / 1e9, free1 / 1e9],
              smem_bytes_a_block=kernels.fd_smem(ocp, dtype),
              k3_f32_unit_rel_vs_twin=k3_rel if f32 else None,
              ptxas=ptxas_report(ptxas_log, ("fdw_linearize_kernel", "fdw_eval_kernel",
                                             "fdw_dynamics_kernel"), wide=True)
              if f32 else None)
    return out


def talos_fd_start(device, dtype):
    """The batched solver of phase_talos_fd_batched and its start: B=128
    Talos full-dynamics T=100 problems (the example's), warm-started from
    the standing state and the quasistatic torques, one iteration a call,
    mu_init 1e-6."""
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, _, x0 = make_talos_fulldynamics(T, device=device, dtype=dtype)
    xs = ocp._tensor(x0)[None, None].expand(B, T + 1, -1).clone()
    us = ocp._tensor(standing_torques(ocp, x0))[None, None].expand(B, T, -1).clone()
    lams = (torch.zeros((B, T, ocp.n_eq), dtype=dtype, device=device),
            torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device),
            torch.zeros((B, ocp.n_term_eq), dtype=dtype, device=device))
    bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                         alphas=ALPHAS)))
    return ocp, bs, tile_problem(ocp.problem, B), xs, us, lams


def talos_fd_batched_stream(device, dtype, calls=30):
    """(max prim_res of each call, the last result, the wall seconds of the
    timed calls) of the phase_talos_fd_batched recipe: two warm-up calls,
    then `calls` calls each fed the last result."""
    ocp, bs, probs, xs, us, lams = talos_fd_start(device, dtype)
    prims = []
    for i in range(2 + calls):
        if i == 2:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
    torch.cuda.synchronize()
    return [float(p) for p in prims], res, bs, time.perf_counter() - t1


def talos_fd_batched_setup(device):
    """The f64 stream beside phase_talos_fd_batched's f32 one, made before
    the path's counters are zeroed (a comparison, not the path)."""
    return (talos_fd_batched_stream(device, torch.float64)[0],)


def phase_talos_fd_batched(device, prims64=None):
    """Talos full dynamics, the recipe of phase_fd_batched (B=128, T=100,
    the example's problem: torque and joint limits, no wrench cones), f32,
    from the standing state and the quasistatic torques, mu_init 1e-6: two
    warm-up calls, then 30 one-iteration calls each fed the last result.
    Gates: finite, no divergence, the last call's max prim_res < 1e-3
    (tests/test_fulldynamics_solver.py:83), or, where the same stream in
    f64 (`prims64`, solved on the card) also misses 1e-3, 10 % above its
    last call.  Prints solves/s and both streams."""
    t0 = time.perf_counter()
    calls = 30
    prims, res, bs, wall = talos_fd_batched_stream(device, torch.float32, calls)
    s = {k: float(v) for k, v in bs.summary(res).items()}
    check(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
          and torch.isfinite(res.Ks).all(), "talos fd batched solve: non-finite iterate")
    check(s["any_diverged"] == 0, "talos fd batched solve: a scenario diverged")
    lim = 1e-3 if prims64 is None or prims64[-1] < 1e-3 else 1.1 * prims64[-1]
    check(s["max_prim"] < lim, f"talos fd batched solve: last max prim {s['max_prim']:.3e} "
          f">= {lim:.3e}")
    phase("talos_fd_batched", t0, B=B, T=T, calls=calls, solves_per_s=B * calls / wall,
          ms_per_call=1e3 * wall / calls, max_prim_per_call=prims, gate=lim,
          f64_max_prim_per_call=prims64, **s)


def talos_fd_host_mpc(device, dtype=torch.float32):
    """The host MPC of phase_talos_fd_mpc: `configs.talos_fd_mpc` (the
    example's gait and MPCSettings) at T=100 in `dtype`, first solve cut to
    FUSED_INIT_ITERS iterations, walking."""
    from simple_mpc_tpu_torch.configs import talos_fd_mpc

    mpc = talos_fd_mpc(T, device=device, dtype=dtype, init_max_iters=FUSED_INIT_ITERS)
    check(not mpc.diverged, "talos fd MPC: initial solve diverged")
    return mpc


def phase_talos_fd_mpc(device):
    """The host MPC on Talos full dynamics T=100 (examples/talos_fulldynamics.py's
    biped gait 20/80/20/80 at 0.1 m/s and MPCSettings: T_fly 80, T_contact
    20, apex 0.1 m, mu_init 1e-8; `init_max_iters` cut to 20), f32:
    TALOS_FD_MPC_TICKS ticks fed their own planned next state, then 5 more
    under the profiler.  Gates: finite plans, no divergence, and on every
    tick the stage-0 contact wrenches (MPC.get_contact_forces(0), through
    wide_fd_dynamics) unilateral (fz > -1e-6) with their fz summing to
    within 35 % of m g (tests/test_fulldynamics_solver.py:102-103)."""
    t0 = time.perf_counter()
    mpc = talos_fd_host_mpc(device)
    setup = time.perf_counter() - t0
    mg = mpc.ocp_handler.model_handler.mass * 9.81
    lat, prims, fz = [], [], []
    for _ in range(TALOS_FD_MPC_TICKS):
        t1 = time.perf_counter()
        res = mpc.iterate(mpc.xs[1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        check(not mpc.diverged, "talos fd MPC: a tick diverged")
        check(bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
                   and torch.isfinite(res.Ks).all()), "talos fd MPC: non-finite plan")
        f = mpc.get_contact_forces(0).double().cpu().numpy()
        check(bool(np.isfinite(f).all()) and f[:, 2].min() > -1e-6,
              f"talos fd MPC: stage-0 wrenches not unilateral: fz {f[:, 2]}")
        check(abs(f[:, 2].sum() - mg) < 0.35 * mg,
              f"talos fd MPC: stage-0 wrenches carry {f[:, 2].sum():.2f} N of m g = {mg:.2f} N")
        prims.append(float(res.prim_res))
        fz.append(float(f[:, 2].sum() / mg))
    trace = trace_calls(lambda: mpc.iterate(mpc.xs[1]))
    lat_ms = 1e3 * np.asarray(lat)
    phase("talos_fd_mpc", t0, T=T, ticks=TALOS_FD_MPC_TICKS, setup_s=setup,
          tick_p50_ms=float(np.percentile(lat_ms, 50)),
          tick_p99_ms=float(np.percentile(lat_ms, 99)), max_prim=float(max(prims)),
          prim_per_tick=prims, fz_sum_over_mg=[min(fz), max(fz)], tick_trace=trace)


def quad_corner_plant(mh, device, dt=1e-3):
    """The closed loop's simulator with the quad feet's four corner points
    (the model handler's contact points, 0.1 x 0.075 m about each sole
    frame) as its contacts, in place of one point at each sole: a flat foot
    that can bear the contact moments of the MPC's 6D contacts."""
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.models.model import Frame
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    m, ids = mh.model, []
    for i, fid in enumerate(mh.feet_frame_ids):
        f = m.frames[fid]
        for c, d in enumerate(mh.feet_contact_points[i]):
            ids.append(m.add_frame(Frame(f"{f.name}_corner{c}", f.parent_joint,
                                         np.asarray(f.R), np.asarray(f.p) + np.asarray(f.R) @ d)))
    return Simulator(m, ids, SimSettings(dt=dt, ground_height=foot_height(mh)), device=device)


def talos_fd_loop_run(device, dtype, corners=False, plant_dt=1e-3):
    """The port's Talos full-dynamics example (examples/talos_fulldynamics.py:
    T=100, the biped gait 20/80/20/80 at 0.1 m/s, apex 0.1 m, mu_init 1e-8,
    the first solve's 100 iterations, Riccati feedback us[0] - Ks[0]
    difference(x, xs[0]) at 1 kHz, 10 inner steps a tick) in `dtype` for
    TALOS_FD_LOOP_TICKS ticks, on the example's plant (a point contact at
    each sole) or with `corners` on quad_corner_plant, whose steps take
    `plant_dt` (0.01 / plant_dt inner steps a tick, the feedback at each
    step).  Returns the first tick whose state is not finite or whose base
    z leaves the 0.1 m band of JAX's smoke test
    (tests/test_examples_smoke.py:20-25; None if none), the base z range
    and the largest |v| before it with its joint, and the host times of the
    tick, its references and the inner step."""
    from simple_mpc_tpu_torch.examples.loop import foot_height, run_closed_loop
    from simple_mpc_tpu_torch.examples.talos_fulldynamics import setup
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import WALK, biped
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    mpc, mh = setup(TALOS_FD_LOOP_T, device, dtype)
    m = mh.model
    plant = (quad_corner_plant(mh, device, plant_dt) if corners else
             Simulator(m, mh.feet_frame_ids, SimSettings(dt=plant_dt,
                                                         ground_height=foot_height(mh)),
                       device=device))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        log = run_closed_loop(mpc, mh, id_solver=None, n_steps=TALOS_FD_LOOP_TICKS,
                              n_simu=round(0.01 / plant_dt), walk_velocity=WALK,
                              gait=biped(mh.feet_names), log_every=0, plant=plant)
    q, v = np.stack(log["q"]), np.stack(log["v"])
    bad = ~(np.isfinite(q).all(axis=1) & np.isfinite(v).all(axis=1)
            & (np.abs(q[:, 2] - q[0, 2]) < 0.1))
    first = int(np.argmax(bad)) if bad.any() else None
    ok = slice(0, max(first, 1)) if first is not None else slice(None)
    i = int(np.abs(v[ok]).max(axis=0).argmax())

    def p(key, q_):
        return float(np.percentile(1e3 * np.asarray(log[key])[ok], q_))

    return dict(T=TALOS_FD_LOOP_T, dtype=str(dtype).replace("torch.", ""),
                plant="quad corners" if corners else "soles", plant_dt=plant_dt,
                ticks=TALOS_FD_LOOP_TICKS,
                first_tick_out=first, base_z=[float(q[ok, 2].min()), float(q[ok, 2].max())],
                max_abs_v=float(np.abs(v[ok]).max()),
                max_abs_v_at=m.joint_names[i - 5] if i >= 6 else f"base {i}",
                solver_warnings=sum("non-finite" in str(w.message) for w in caught),
                tick_p50_ms=p("solve_time", 50), refs_p50_ms=p("refs_time", 50),
                inner_step_p50_ms=p("inner_time", 50))


def phase_talos_fd_closed_loop(device):
    """A reading, not a gated path: the Talos full-dynamics example in
    closed loop at its own T=100 for TALOS_FD_LOOP_TICKS ticks, in f32 and
    f64, on its plant and on quad_corner_plant, and in f64 on its plant
    with steps of 0.1 ms (talos_fd_loop_run).  On the example's plant it
    leaves the band within a few ticks in either precision (PERF.md,
    ROADMAP Queue 3): the sole points let the feet roll under the ankle
    torques of the 6D-contact plan, and the Riccati feedback rings on the
    ankle-roll joints.  Nothing here gates; the phase fails only if a run
    raises."""
    t0 = time.perf_counter()
    runs = [talos_fd_loop_run(device, dtype, corners)
            for corners in (False, True) for dtype in (torch.float32, torch.float64)]
    runs.append(talos_fd_loop_run(device, torch.float64, plant_dt=1e-4))
    phase("talos_fd_closed_loop", t0, gated=False, runs=runs)


# ---------------------------------------------------------------------------
# Talos centroidal (x = [com; h], two 6D wrenches): csrc/centroidal.cu, its
# line-search select (csrc/linesearch_centroidal.cu) and CentroidalID's
# assembly (csrc/id_centroidal.cu)
# ---------------------------------------------------------------------------

CENT_KERNELS = ("centroidal_stage_linearize", "centroidal_stage_eval",
                "centroidal_term_linearize", "centroidal_line_search_select",
                "vector_candidate_integrate", "vector_state_difference")
CENT_SOLVER_KERNELS = CENT_KERNELS + ("riccati_backward", "linear_rollout")
CENT_INNER_KERNELS = ("centroidal_id_assemble", "qp_admm", "wide_sim_step")
CENT_ALL = CENT_KERNELS + ("centroidal_state_derivative", "centroidal_id_assemble")
CENT_MPC_TICKS = 40
# JAX's own smoke gate of the example (tests/test_examples_smoke.py:20-33):
# T=50, 25 ticks; beside it a reading at the example's T=100
CENT_LOOP_T, CENT_LOOP_TICKS = 50, 25
CENT_READ_T, CENT_READ_TICKS = 100, 30
# past the horizon at JAX's gate's T=50: the gait's first single support
# reaches stage 0 at tick index 19 + T, and the loop stops CENT_SWING_SS + 1
# ticks into it (the example diverges 14 ticks in, in JAX as in the port)
CENT_SWING_SS = 8
CENT_SWING_TICKS = 20 + CENT_LOOP_T + CENT_SWING_SS
PATH_KERNELS.update(talos_centroidal_batched=CENT_SOLVER_KERNELS,
                    talos_centroidal_mpc=CENT_SOLVER_KERNELS,
                    talos_centroidal_closed_loop=CENT_SOLVER_KERNELS + CENT_INNER_KERNELS
                    + ("centroidal_state_derivative",))
PATH_KERNELS["talos_centroidal_swing"] = PATH_KERNELS["talos_centroidal_closed_loop"]
PATH_EXACT["talos_centroidal_closed_loop"] = loop_launches(
    CENT_SOLVER_KERNELS, CENT_INNER_KERNELS, "centroidal_state_derivative", CENT_LOOP_TICKS)
PATH_EXACT["talos_centroidal_swing"] = loop_launches(
    CENT_SOLVER_KERNELS, CENT_INNER_KERNELS, "centroidal_state_derivative", CENT_SWING_TICKS)
# the centroidal paths launch no multibody stage, select, integrate, gap,
# ID or derivative kernel and no fused-tick kernel; no other path launches
# a centroidal one
_CENT_ABSENT = (GO2_STAGE_KERNELS + WIDE_KERNELS + WIDE_FD_KERNELS + _KINO_STAGE + _GO2_FD
                + ("candidate_integrate", "state_difference", "id_assemble",
                   "wide_id_assemble", "tick_refs", "wide_tick_refs", "parallel_riccati_backward"))
for _path in PATH_KERNELS:
    if _path.startswith("talos_centroidal"):
        PATH_ABSENT[_path] = _CENT_ABSENT
    else:
        PATH_ABSENT[_path] = PATH_ABSENT.get(_path, ()) + CENT_ALL
PATH_ABSENT["talos_centroidal_batched"] += ("centroidal_state_derivative", "centroidal_id_assemble")
PATH_ABSENT["talos_centroidal_mpc"] += ("centroidal_id_assemble",)
# csrc units that existed before the centroidal ones: their SASS must not
# move (ROADMAP "Constraints")
LOCKED_UNITS = ("linearize.cu", "linearize_wide.cu", "tick.cu", "tick_wide.cu", "fulldyn.cu",
                "fulldyn_wide.cu", "id.cu", "sim.cu", "acc.cu", "acc_wide.cu", "id_wide.cu",
                "sim_wide.cu", "linesearch.cu", "linesearch_wide.cu", "riccati.cu",
                "rollout.cu", "parallel_riccati.cu", "qp.cu")
# sha256 of each locked unit's normalized `cuobjdump -sass` as the tree
# before the centroidal units compiled it on an NVIDIA H100 80GB HBM3 at
# 700 W with the nvcc release below (sass_digests); another nvcc prints
# its digests ungated
LOCKED_SASS_NVCC = "Cuda compilation tools, release 12.9, V12.9.86"
LOCKED_SASS = {
    "linearize.cu": "1090ed1bd8512e313bf88caabf0e884012a4e72f2c264d4804898b4cfda401a9",
    "linearize_wide.cu": "6ef3e15f289bc44ee830ed4144f94e28d7c010812d38f9720eee00dcead066d0",
    "tick.cu": "55e311b9ae502d7864b1319fac55d77d71568adcb1c9fa0abf09460508b252b1",
    "tick_wide.cu": "ddea9f183d706e05efdb138c8d867e45a0f606ec9f7805266a594e59f7377f74",
    "fulldyn.cu": "ad0e55a758937576f460c8e46ba46539d5c7c1a016be49ec63926a04fd56d820",
    "fulldyn_wide.cu": "9fa7879915ddf739e8788dd748062bf26578d8e0efa1275aef517cbed860f241",
    "id.cu": "b0978d5b17323d37e8f716a93ee4ea6037500d08d7b4f7e977062da2dfbbc833",
    "sim.cu": "053955c30d2553f078671d2a462469a85e836fa4af550281e262cfbedf35417b",
    "acc.cu": "76d652022eea9f5570ecbe8c5c38cd74bf580c10e054b53c22dac4cbd5d234ae",
    "acc_wide.cu": "9b152d3c7a73e059a8a2ffc7614d47983d423a68aa524c34f9a7a5a046255edc",
    "id_wide.cu": "b548bcbecdbe424e14be98e93b1a1883732764b7eb367e4240229affc1bef52a",
    "sim_wide.cu": "0963c9b772d7770dcb4ab1a5383f3ce1f23e46fd5d1ce038d9e8717d4e11b730",
    "linesearch.cu": "bc760b65a04d0c3fbcae61133a55a6fdd527d77c5e6d5f5837b247a31b886a12",
    "linesearch_wide.cu": "a93c8493ecdcf4628546efb28f593c2a79bf0f555198fd2e384b149aeb8fe0fd",
    # re-taken after K3's redesign (its outputs bitwise the old unit's)
    "riccati.cu": "31d9dd7ceb546b15d247c3be34310b3003e682e567ffd63f357e6b58a704f760",
    "rollout.cu": "d0d6ab6cd30522454a249da8be064f0def106b00a7bc7fa3c0132966e2156673",
    "parallel_riccati.cu": "50b440eee30e6438f62f897653eba2bbb803861ac936a68e1d2acd84a7baf6ca",
    "qp.cu": "f682ff83427a68e16ce61f30370a413b3441d11f1d36dad4d472052cad9bdd63",
}


def sass_start(csrc, units, workdir):
    """Start one nvcc per csrc/<unit>, all together, compiling it alone to a
    cubin with the library's flags; `sass_digests` reads them.  The script
    starts them after the build so that they compile while the kernel phases
    run, at the lowest CPU priority (the card's launches keep the host's
    cores first); they are killed at exit if still running."""
    import atexit

    from simple_mpc_tpu_torch import kernels

    nvcc = kernels._nvcc()
    os.makedirs(workdir, exist_ok=True)
    procs = {}
    for u in units:
        fmad = ("-fmad=false",) if u in kernels.NO_FMA else ()
        out = os.path.join(workdir, u + ".cubin")
        procs[u] = (out, subprocess.Popen(
            [nvcc, *kernels.ARCH, "-std=c++17", "-O3", *fmad, "-cubin", "-o", out,
             os.path.join(csrc, u)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, preexec_fn=lambda: os.nice(19)))
    atexit.register(lambda: [p.kill() for _, p in procs.values() if p.poll() is None])
    return nvcc, procs


def sass_digests(started):
    """{unit: sha256 of its SASS} of `sass_start`'s cubins, read with
    cuobjdump -sass; the names of internal-linkage functions, which carry a
    per-path hash, are normalized.  Also returns nvcc's release line."""
    import hashlib
    import re

    nvcc, procs = started
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    digests = {}
    for u, (out, p) in procs.items():
        log = p.communicate()[0]
        check(p.returncode == 0, f"nvcc -cubin {u} failed:\n{log}")
        r = subprocess.run([cuobjdump, "-sass", out], capture_output=True, text=True,
                           timeout=300)
        check(r.returncode == 0, f"cuobjdump {u}: {r.stderr}")
        text = re.sub(r"(_INTERNAL_|_GLOBAL__N__)[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", r"\1",
                      r.stdout)
        digests[u] = hashlib.sha256(text.encode()).hexdigest()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    release = next((ln.strip() for ln in ver.splitlines() if "release" in ln), ver.strip())
    return digests, release


def locked_sass_start():
    return sass_start(os.path.join(ROOT, "simple_mpc_tpu_torch", "csrc"), LOCKED_UNITS,
                      os.path.join(ROOT, "simple_mpc_tpu_torch", "_build", "sass"))


def cent_case(device, dtype, nb, seed):
    """(ocp, solver, stage params, xs, us, lam_in, mu, term params, x0) of a
    perturbed Talos centroidal problem (configs.make_talos_centroidal, the
    example's weights and 6D wrenches) at the main path's T=100 with nb
    scenarios: each scenario's feet lifted in turns over a window, its foot
    positions, references and iterate perturbed from numpy with `seed`, and
    cone multipliers on about half the rows."""
    from simple_mpc_tpu_torch.configs import make_talos_centroidal
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, mh, x0 = make_talos_centroidal(T, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    sp = tree_map(lambda a: a[None].expand((nb,) + a.shape).clone(), ocp.problem.stage_params)
    act = np.ones((nb, T, ocp.nk))
    for b in range(nb):
        s0 = rng.integers(0, T - T // 3)
        act[b, s0: s0 + T // 3, b % ocp.nk] = 0.0
    sp = sp._replace(
        contact_active=t(act),
        contact_pose=sp.contact_pose + t(0.02 * rng.standard_normal((nb, T, ocp.nk, 3))),
        com_ref=t(x0[:3] + 0.02 * rng.standard_normal((nb, T, 3))),
        linmom_ref=t(rng.standard_normal((nb, T, 3))),
        angmom_ref=t(0.5 * rng.standard_normal((nb, T, 3))))
    xs = t(x0[None, None] + np.concatenate([0.01 * rng.standard_normal((nb, T + 1, 3)),
                                            0.5 * rng.standard_normal((nb, T + 1, 6))], -1))
    us = sp.u_ref * t(act.repeat(ocp.fs, -1)) + t(5.0 * rng.standard_normal((nb, T, ocp.nu)))
    li = rng.exponential(5.0, (nb, T, ocp.n_in)) * (rng.random((nb, T, ocp.n_in)) < 0.5)
    mu = t(10.0 ** rng.uniform(-4, -2, nb))
    tp = tree_map(lambda a: a[None].expand((nb,) + a.shape).clone(), ocp.problem.term_params)
    tp = tp._replace(linmom_ref=t(rng.standard_normal((nb, 3))))
    x0b = xs[:, 0] + t(0.001 * rng.standard_normal((nb, 9)))
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-8, max_iters=1, alphas=ALPHAS))
    return ocp, solver, sp, xs, us, t(li), mu, tp, x0b


def cent_iteration(device, dtype, nb, seed=21):
    """One solver iteration of cent_case through the kernels, keeping each
    new kernel's inputs: {name: (kernel, twin, args)} and the ocp."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map

    ocp, s, sp, xs, us, li, mu, tp, x0 = cent_case(device, dtype, nb, seed)
    le = torch.zeros((nb, T, 0), dtype=dtype, device=device)
    lt = torch.zeros((nb, 0), dtype=dtype, device=device)
    lin_args = (s, sp, xs, us, le, li, mu)
    lin = kernels.centroidal_stage_linearize(*lin_args)
    term_args = (s, xs[:, -1], tp, lt, mu)
    Vx, Vxx = kernels.centroidal_term_linearize(*term_args)
    reg = max(s.settings.reg_init, 50 * torch.finfo(dtype).eps)
    ks, Ks, dual = kernels.riccati_backward(lin, Vx, Vxx, reg)
    dif_args = (s, xs[:, 0], x0)
    dx0 = kernels.vector_state_difference(*dif_args)
    alphas = s._const("alphas", ALPHAS, xs)
    dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks, Ks, dx0, alphas)
    int_args = (s, xs, us, dxs, dus)
    xs_c, us_c = kernels.vector_candidate_integrate(*int_args)
    eval_args = (s, sp, xs_c, us_c, le, li, mu)
    costs, g, h, gap = kernels.centroidal_stage_eval(*eval_args)
    eta = torch.clamp(mu ** s.settings.bcl_alpha, min=s.settings.tol)
    omega = torch.full_like(mu, -1.0)
    sel_args = (s, xs_c, us_c, costs, g, h, gap, tp, x0, le, li, lt, mu, eta, omega, dual,
                alphas)
    p = tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), sp)
    ode_args = (ocp, xs[:, :-1].reshape(-1, 9), us.reshape(-1, ocp.nu), p)
    return ocp, dict(
        centroidal_stage_linearize=(kernels.centroidal_stage_linearize,
                                    kernels._linearize_traj_plain, lin_args),
        centroidal_stage_eval=(kernels.centroidal_stage_eval, kernels._eval_traj_plain,
                               eval_args),
        centroidal_term_linearize=(kernels.centroidal_term_linearize,
                                   kernels._linearize_term_plain, term_args),
        vector_candidate_integrate=(kernels.vector_candidate_integrate,
                                    kernels.candidate_integrate_plain, int_args),
        vector_state_difference=(kernels.vector_state_difference,
                                 kernels.state_difference_plain, dif_args),
        centroidal_line_search_select=(kernels.centroidal_line_search_select,
                                       kernels.line_search_select_plain, sel_args),
        centroidal_state_derivative=(kernels.centroidal_state_derivative,
                                     kernels.centroidal_state_derivative_plain, ode_args))


def cent_id_case(device, dtype, nb, seed=5):
    """(kernel, twin, args) of CentroidalID's assembly on nb perturbed Talos
    states (the example's IDSettings), the right foot in swing with its
    target moved and turned, CoM targets perturbed."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import talos_handler
    from simple_mpc_tpu_torch.examples.talos_centroidal import ID_SETTINGS
    from simple_mpc_tpu_torch.id.centroidal_id import CentroidalID
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings

    mh = talos_handler()
    cid = CentroidalID(mh, 1e-3, IDSettings(**ID_SETTINGS), device=device, dtype=dtype)
    m, rng = mh.model, np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    x = np.asarray(mh.reference_state)
    q = np.tile(x[: m.nq], (nb, 1))
    q[:, 7:] += 0.05 * rng.standard_normal((nb, m.nq - 7))
    q[:, :3] += 0.01 * rng.standard_normal((nb, 3))
    v = 0.2 * rng.standard_normal((nb, m.nv))
    tg = {k: a[None].expand((nb,) + a.shape).clone() for k, a in cid._targets.items()}
    tg["contacts"] = t(np.tile([1.0, 0.0], (nb, 1)))
    th = 0.1 * rng.standard_normal(nb)
    rot = np.stack([np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
                    for a in th])
    tg["feet_R_t"] = tg["feet_R_t"] @ t(rot)[:, None]
    tg["feet_p_t"] = tg["feet_p_t"] + t(0.03 * rng.standard_normal((nb, 2, 3)))
    tg["feet_v_t"] = t(0.1 * rng.standard_normal((nb, 2, 6)))
    tg["com_t"] = tg["com_t"] + t(0.01 * rng.standard_normal((nb, 3)))
    tg["com_v_t"] = t(0.05 * rng.standard_normal((nb, 3)))
    return cid, (kernels.centroidal_id_assemble, lambda c, qq, vv, tt: c._assemble_core(qq, vv, tt),
                 (cid, t(q), t(v), tg))


def cent_rel(a, b, select=False):
    """The worst ls_rel over two results' tensors (empty ones skipped).
    With `select` (two LineSearch results) over the scenarios where both
    picked the same step size; where they did not, their merits must tie
    within 1e-5 (f32 roundoff of the merit), else inf."""
    if select:
        same = (a.alpha == b.alpha).cpu()
        tie = ((a.merit - b.merit).abs() <= 1e-5 * b.merit.abs()).cpu()
        if not bool((same | tie).all()):
            return float("inf")
        a = [x[same.to(x.device)] for x in outputs(a)]
        b = [x[same.to(x.device)] for x in outputs(b)]
    return max([ls_rel(x, y) for x, y in zip(outputs(a), outputs(b)) if y.numel()] or [0.0])


def cent_flops(ocp, cid):
    """Counted FLOPs of the centroidal kernels at the main path's shapes:
    the Gauss-Newton products of the linearization (nr AL rows, 9 + nu
    directions) and of CentroidalID's cost rows (H and g over nz); the rest
    move bytes."""
    nr, nd = 15 + ocp.nu + ocp.n_in, 9 + ocp.nu
    rows = cid.nu + 6 + 2 * cid.nk * cid.fdim + 3 + cid.nk * cid.fdim
    return dict(centroidal_stage_linearize=B * T * 2 * nr * nd * (nd + 1),
                centroidal_id_assemble=B * 2 * rows * cid.nz * (cid.nz + 1))


def cent_up(args):
    """args with every floating tensor (and param tuple leaf) in float64."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    def up(a):
        if torch.is_tensor(a):
            return a.double() if a.is_floating_point() else a
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return tree_map(lambda x: x.double() if x.is_floating_point() else x, a)
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        return a
    return tuple(up(a) for a in args)


def phase_talos_centroidal_kernels(device, ptxas_log="", sass_job=None):
    """The centroidal kernels against their twins on the card: the stage
    linearization, the candidates' evaluation, the terminal K5 and the ODE
    of csrc/centroidal.cu, its vector-space integrate and initial gap, the
    select of csrc/linesearch_centroidal.cu (cent_iteration: one
    iteration's inputs of a perturbed Talos centroidal T=100 problem) and
    CentroidalID's assembly of csrc/id_centroidal.cu (cent_id_case), at
    B=128 and B=1.  Gates (cent_rel: the worst output, relative to its
    largest entry): in f64 within 1e-10 of the twin; in f32 within ten times
    the f32 twin's own distance from the f64 twin (both on the card, the
    f64 twin on the f32 inputs; at least 1e-6: a distance of 0 leaves the
    kernel its own roundoff).  Times: CUDA-event medians of the kernels and
    of their twins; bounds by roofline; registers and stack from the ptxas
    log.  Then the locked units' SASS (sass_digests) against LOCKED_SASS."""
    from simple_mpc_tpu_torch import kernels

    out = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        f32 = dtype == torch.float32
        errs, abs_err, twin_d, times, bounds = {}, {}, {}, {}, {}
        for nb in (B, 1):
            ocp, runs = cent_iteration(device, dtype, nb)
            cid, idrun = cent_id_case(device, dtype, nb)
            runs["centroidal_id_assemble"] = idrun
            for name, (kern, twin, args) in runs.items():
                got, want = kern(*args), twin(*args)
                sel = name == "centroidal_line_search_select"
                if f32:
                    ref = twin(*cent_up(args))
                    d = cent_rel(want, ref, sel)
                    err, tol = cent_rel(got, ref, sel), max(10 * d, 1e-6)
                    twin_d[f"{name}_B{nb}"] = d
                else:
                    err, tol = cent_rel(got, want, sel), 1e-10
                    if sel:
                        check(torch.equal(got.alpha, want.alpha),
                              f"{name} B={nb} f64: another step size than the twin's")
                check(err <= tol, f"{name} B={nb} {dtype}: {err:.3e} > {tol:.3e}")
                errs[name] = max(errs.get(name, 0.0), err)
                a = max([float((x.double() - y.double()).abs().nan_to_num().max())
                         for x, y in zip(outputs(got), outputs(want)) if y.numel()] or [0.0])
                abs_err[name] = max(abs_err.get(name, 0.0), a)
                if nb == B:
                    times[name] = (cuda_ms(lambda: kern(*args), REPS),
                                   cuda_ms(lambda: twin(*args), SLOW_REPS))
                    moved = (select_bytes(args[1:], got) if name == "centroidal_line_search_select"
                             else nbytes((args, got)))
                    bounds[name] = roofline(cent_flops(ocp, cid).get(name, 0), moved)
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"talos_centroidal_kernels_{name}", t0, B=B, T=T, nx=9, nu=ocp.nu,
              n_in=ocp.n_in, rel_err=errs, max_abs_err=abs_err,
              f32_twin_vs_f64_twin=twin_d if f32 else None, ms_kernel_vs_plain=times,
              bound_ms=bounds,
              ptxas=ptxas_report(ptxas_log, ("centroidal_linearize_kernel",
                                             "centroidal_eval_kernel", "id_assemble_kernel"),
                                 wide=True) if f32 else None)
    t0 = time.perf_counter()
    digests, release = sass_digests(sass_job or locked_sass_start())
    gated = release == LOCKED_SASS_NVCC
    if gated:
        moved = [u for u in LOCKED_UNITS if digests[u] != LOCKED_SASS.get(u)]
        check(not moved, f"locked units' SASS moved: {moved}")
    phase("talos_centroidal_sass", t0, nvcc=release, gated=gated, sha256=digests)
    return out


def cent_batched_start(device, dtype):
    """The batched solver of phase_talos_centroidal_batched and its start:
    B=128 Talos centroidal T=100 standing problems (the example's), each
    scenario's x0 (CoM 1 cm, momenta 0.1) and its iterate (states: CoM
    1 cm, momenta 0.5 about x0; wrenches 5 N or N m about the reference)
    perturbed from numpy (seed 17), so that the first call leaves a max
    prim_res ten times the gate; one iteration a call, mu_init 1e-6 (the
    batched cells' and the JAX bench's, bench.py:121)."""
    from simple_mpc_tpu_torch.configs import make_talos_centroidal
    from simple_mpc_tpu_torch.ocp.base import Problem
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, _, x0 = make_talos_centroidal(T, device=device, dtype=dtype)
    rng = np.random.default_rng(17)
    x0b = x0[None] + np.concatenate([0.01 * rng.standard_normal((B, 3)),
                                     0.1 * rng.standard_normal((B, 6))], -1)
    xs = x0b[:, None] + np.concatenate([0.01 * rng.standard_normal((B, T + 1, 3)),
                                        0.5 * rng.standard_normal((B, T + 1, 6))], -1)
    xs[:, 0] = x0b
    probs = tile_problem(ocp.problem, B)
    us = probs.stage_params.u_ref.cpu().double().numpy() + 5.0 * rng.standard_normal(
        (B, T, ocp.nu))
    probs = Problem(x0=ocp._tensor(x0b), stage_params=probs.stage_params,
                    term_params=probs.term_params)
    lams = (torch.zeros((B, T, 0), dtype=dtype, device=device),
            torch.zeros((B, T, ocp.n_in), dtype=dtype, device=device),
            torch.zeros((B, 0), dtype=dtype, device=device))
    bs = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                         alphas=ALPHAS)))
    return bs, probs, ocp._tensor(xs), ocp._tensor(us), lams


def cent_batched_stream(device, dtype, calls=30):
    """(per call: max prim_res, mean merit, the share of scenarios whose
    line search kept the iterate (alpha = 0); the last result, the solver,
    the wall seconds of the timed calls): two warm-up calls from the start,
    then `calls` calls from the start again, each fed the last result."""
    bs, probs, xs0, us0, lams0 = cent_batched_start(device, dtype)
    for _ in range(2):
        bs.run(probs, xs0, us0, lams0)
    torch.cuda.synchronize()
    xs, us, lams = xs0, us0, lams0
    prims, merits, kept = [], [], []
    t1 = time.perf_counter()
    for _ in range(calls):
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        prims.append(res.prim_res.max())
        merits.append(res.merit.mean())
        kept.append((res.alpha == 0).to(dtype).mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    return ([float(p) for p in prims], [float(m) for m in merits], [float(k) for k in kept],
            res, bs, wall)


def cent_batched_setup(device):
    """The f64 stream beside phase_talos_centroidal_batched's f32 one, made
    before the path's counters are zeroed (a comparison, not the path)."""
    return (cent_batched_stream(device, torch.float64)[0],)


def merit_floor(res, nT):
    """The smallest gap an f32 merit can see: a step that closes a gap g
    lowers the merit by g^2 / (2 mu), and the merit, a sum of nT stage
    terms, carries about sqrt(nT) eps |merit| of f32 rounding; below that
    the step ties with alpha = 0 and the argmin keeps the iterate."""
    eps = torch.finfo(torch.float32).eps
    return math.sqrt(2.0 * float(res.mu.max()) * math.sqrt(nT) * eps
                     * float(res.merit.abs().max()))


def phase_talos_centroidal_batched(device, prims64):
    """Talos centroidal, B=128, T=100 (cent_batched_start: a perturbed
    iterate), f32: 30 one-iteration calls each fed the last result, after
    two warm-up calls.  Gates: finite, no divergence; the first call's max
    prim_res above 5e-4 in both streams (the stream starts above the gate);
    call by call, the f32 stream within ten times the same stream in f64
    (`prims64`, solved on the card) or under `merit_floor`; the last call
    a tenth of the first at most and under 5e-4 (bench.py:192), or, where
    the f64 stream also misses 5e-4, under 10 % above its last call.
    Prints solves/s, both streams, the f32 merits and the share of
    scenarios that kept their iterate each call."""
    t0 = time.perf_counter()
    calls = len(prims64)
    prims, merits, kept, res, bs, wall = cent_batched_stream(device, torch.float32, calls)
    s = {k: float(v) for k, v in bs.summary(res).items()}
    check(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
          and torch.isfinite(res.Ks).all(), "centroidal batched solve: non-finite iterate")
    check(s["any_diverged"] == 0, "centroidal batched solve: a scenario diverged")
    check(min(prims[0], prims64[0]) > 5e-4,
          f"centroidal batched solve: the stream starts under the gate ({prims[0]:.3e}, "
          f"f64 {prims64[0]:.3e})")
    floor = merit_floor(res, T)
    off = [i for i, (p, q) in enumerate(zip(prims, prims64)) if p > max(10 * q, floor)]
    check(not off, f"centroidal batched solve: f32 max prim over ten times f64's and over "
          f"the merit floor {floor:.3e} at calls {off}: {[prims[i] for i in off]} against "
          f"{[prims64[i] for i in off]}")
    lim = 5e-4 if prims64[-1] < 5e-4 else 1.1 * prims64[-1]
    check(s["max_prim"] < lim and prims[-1] <= 0.1 * prims[0],
          f"centroidal batched solve: last max prim {s['max_prim']:.3e} (first "
          f"{prims[0]:.3e}, gate {lim:.3e})")
    phase("talos_centroidal_batched", t0, B=B, T=T, calls=calls,
          solves_per_s=B * calls / wall, ms_per_call=1e3 * wall / calls,
          max_prim_per_call=prims, gate=lim, f64_max_prim_per_call=prims64,
          merit_floor=floor, mean_merit_per_call=merits, alpha0_share_per_call=kept, **s)


def phase_talos_centroidal_mpc(device):
    """The host MPC of examples/talos_centroidal.py (configs.talos_centroidal_mpc:
    T=100, the biped gait 20/80/20/80 at 0.1 m/s, T_fly 80, T_contact 20,
    apex 0.1 m, mu_init 1e-8, the first solve's 100 iterations), f32:
    CENT_MPC_TICKS ticks, each measuring the reference state, then 5 more
    under the profiler.  Gates: finite plans, no divergence, and on every
    tick the stage-0 wrenches (us[0]) unilateral (fz > -1e-6) with their fz
    summing to within 35 % of m g.  Prints tick p50/p99 and the kernels a
    tick (from the launch counters)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import talos_centroidal_mpc

    t0 = time.perf_counter()
    mpc = talos_centroidal_mpc(T, device=device, dtype=torch.float32)
    check(not mpc.diverged, "centroidal MPC: initial solve diverged")
    setup = time.perf_counter() - t0
    mh = mpc.ocp_handler.model_handler
    mg, x = mh.mass * 9.81, np.asarray(mh.reference_state)
    n0 = sum(k.launches for k in kernels.KERNELS)
    lat, prims, fz = [], [], []
    for _ in range(CENT_MPC_TICKS):
        t1 = time.perf_counter()
        res = mpc.iterate(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        check(not mpc.diverged, "centroidal MPC: a tick diverged")
        check(bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
                   and torch.isfinite(res.Ks).all()), "centroidal MPC: non-finite plan")
        f = res.us[0].double().cpu().numpy().reshape(mh.n_feet, -1)
        act = np.asarray(mpc.ocp_handler.get_contact_state(0), bool)
        check(f[act, 2].min() > -1e-6, f"centroidal MPC: stage-0 wrenches not unilateral: {f[:, 2]}")
        check(abs(f[act, 2].sum() - mg) < 0.35 * mg,
              f"centroidal MPC: stage-0 wrenches carry {f[act, 2].sum():.2f} N of m g = {mg:.2f} N")
        prims.append(float(res.prim_res))
        fz.append(float(f[act, 2].sum() / mg))
    per_tick = (sum(k.launches for k in kernels.KERNELS) - n0) / CENT_MPC_TICKS
    trace = trace_calls(lambda: mpc.iterate(x))
    lat_ms = 1e3 * np.asarray(lat)
    phase("talos_centroidal_mpc", t0, T=T, ticks=CENT_MPC_TICKS, setup_s=setup,
          tick_p50_ms=float(np.percentile(lat_ms, 50)),
          tick_p99_ms=float(np.percentile(lat_ms, 99)), kernel_calls_per_tick=per_tick,
          max_prim=float(max(prims)), prim_per_tick=prims, fz_sum_over_mg=[min(fz), max(fz)],
          tick_trace=trace)


def cent_loop_setup(device, nT=CENT_LOOP_T):
    """The port's examples/talos_centroidal.py at horizon nT in f32: (mpc,
    mh, adapter); their construction runs the MPC's first solve and the
    ID's dry run."""
    from simple_mpc_tpu_torch.examples.talos_centroidal import setup

    return setup(nT, device, torch.float32)


def cent_loop(device, mpc, mh, idq, ticks):
    """(log, q, v, wall s) of `ticks` closed-loop ticks of the example."""
    from simple_mpc_tpu_torch.examples.talos_centroidal import run

    t0 = time.perf_counter()
    log = run(mpc, mh, idq, n_steps=ticks, log_every=0)
    wall = time.perf_counter() - t0
    q, v = np.stack(log["q"]), np.stack(log["v"])
    return log, q, v, wall


def phase_talos_centroidal_closed_loop(device, mpc, mh, idq):
    """The Talos centroidal closed loop of the port's example
    (examples/talos_centroidal.py: the biped gait at 0.1 m/s, CentroidalID
    with the example's IDSettings and 60 ADMM steps, the simulator at dt
    1e-3, 10 inner steps a tick), f32, at the configuration of JAX's own
    gate (tests/test_examples_smoke.py:20-33: T=50, 25 ticks).  Gates:
    finite; base z within 0.1 m of its start.  Prints loop_readings."""
    t0 = time.perf_counter()
    log, q, v, wall = cent_loop(device, mpc, mh, idq, CENT_LOOP_TICKS)
    f = np.stack(log["f"])
    check(np.isfinite(q).all() and np.isfinite(v).all(), "centroidal closed loop: non-finite")
    z0 = q[0, 2]
    check(bool((np.abs(q[:, 2] - z0) < 0.1).all()),
          f"centroidal closed loop: fell: base z {q[:, 2].min():.3f}..{q[:, 2].max():.3f}")
    phase("talos_centroidal_closed_loop", t0, T=CENT_LOOP_T, ticks=CENT_LOOP_TICKS,
          inner_steps_per_tick=10, dtype="float32", wall_s=wall,
          base_z=[float(q[:, 2].min()), float(q[:, 2].max())], base_z0=float(z0),
          progress_m=float(q[-1, 0] - q[0, 0]), max_abs_v=float(np.abs(v).max()),
          contact_fz_range=[float(f[..., 2].min()), float(f[..., 2].max())],
          **loop_readings(mpc, mh, idq.cid, log, q, v))


def phase_talos_centroidal_swing(device, mpc, mh, idq):
    """The closed loop of phase_talos_centroidal_closed_loop (T=50) past its
    horizon: CENT_SWING_TICKS ticks, the last CENT_SWING_SS of them with the
    gait's first single support at stage 0, so that CentroidalID's swing
    rows (weighted w_feet_tracking (1 - contact)) run on their inner steps.
    Gates: finite; base z within 0.1 m of its start (JAX's band); at least
    CENT_SWING_SS ticks with a foot out of contact at stage 0; on those, the
    simulator's swing sole bears at most 5 % of m g by the last tick and
    the stance sole carries m g within 35 % on average (a tick's one 1 ms
    reading swings with the impacts).  Prints both soles' loads a tick and
    loop_readings."""
    t0 = time.perf_counter()
    log, q, v, wall = cent_loop(device, mpc, mh, idq, CENT_SWING_TICKS)
    f = np.stack(log["f"])
    check(np.isfinite(q).all() and np.isfinite(v).all(), "centroidal swing loop: non-finite")
    z0 = q[0, 2]
    check(bool((np.abs(q[:, 2] - z0) < 0.1).all()),
          f"centroidal swing loop: fell: base z {q[:, 2].min():.3f}..{q[:, 2].max():.3f}")
    con = np.asarray(log["contacts"], bool)
    ss = np.flatnonzero(~con.all(1))
    check(len(ss) >= CENT_SWING_SS, f"centroidal swing loop: {len(ss)} ticks with a foot "
          f"in swing at stage 0, not {CENT_SWING_SS}")
    mg = mh.mass * 9.81
    stance = np.where(con[ss], f[ss, :, 2], 0.0).sum(1) / mg
    swing = np.where(con[ss], 0.0, f[ss, :, 2]).sum(1) / mg
    check(swing[-1] <= 0.05, f"centroidal swing loop: the swing sole still bears "
          f"{swing[-1]:.3f} m g")
    check(abs(stance.mean() - 1.0) < 0.35,
          f"centroidal swing loop: the stance sole carries {stance.mean():.3f} m g on average")
    phase("talos_centroidal_swing", t0, T=CENT_LOOP_T, ticks=CENT_SWING_TICKS,
          single_support_ticks=[int(ss[0]), int(ss[-1])], wall_s=wall,
          base_z=[float(q[:, 2].min()), float(q[:, 2].max())], base_z0=float(z0),
          stance_fz_over_mg=stance.tolist(), swing_fz_over_mg=swing.tolist(),
          max_abs_v=float(np.abs(v).max()), **loop_readings(mpc, mh, idq.cid, log, q, v))


def phase_talos_centroidal_loop_reading(device):
    """(after the main paths) a reading at the example's own T=100: the
    closed loop of phase_talos_centroidal_closed_loop for CENT_READ_TICKS
    ticks, its loop_readings against the reference's 10 ms tick and 1 ms
    inner-loop budgets; the base z range printed, not gated."""
    t0 = time.perf_counter()
    mpc, mh, idq = cent_loop_setup(device, CENT_READ_T)
    log, q, v, wall = cent_loop(device, mpc, mh, idq, CENT_READ_TICKS)
    r = loop_readings(mpc, mh, idq.cid, log, q, v)
    phase("talos_centroidal_closed_loop_T100", t0, T=CENT_READ_T, ticks=CENT_READ_TICKS,
          gated=False, wall_s=wall, finite=bool(np.isfinite(q).all()),
          base_z=[float(q[:, 2].min()), float(q[:, 2].max())], base_z0=float(q[0, 2]),
          tick_within_10ms=r["tick_p99_ms"] <= 10.0,
          inner_step_within_1ms=r["inner_step_with_refs_p99_ms"] <= 1.0, **r)


def drive_main_path(device):
    """The main paths (phases 4-10, 12, 14-16, 18, 23-24, 26, 27 and 30-32), each with the
    launch counters zeroed just before it (after its set-up) and read just
    after; returns the launches of each kernel summed over them."""
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
                              talos_closed_loop_setup),
                             ("talos_fused", phase_talos_fused,
                              lambda d: (reference_prims(talos_fused_engine, d),)),
                             ("talos_latency", phase_latency, talos_latency_setup),
                             ("fd_fused", phase_fd_fused,
                              lambda d: (reference_prims(fd_fused_engine, d),)),
                             ("fd_latency", phase_latency, fd_latency_setup),
                             ("talos_fd_batched", phase_talos_fd_batched,
                              talos_fd_batched_setup),
                             ("talos_fd_mpc", phase_talos_fd_mpc, None),
                             ("talos_centroidal_batched", phase_talos_centroidal_batched,
                              cent_batched_setup),
                             ("talos_centroidal_mpc", phase_talos_centroidal_mpc, None),
                             ("talos_centroidal_closed_loop",
                              phase_talos_centroidal_closed_loop, cent_loop_setup),
                             ("talos_centroidal_swing", phase_talos_centroidal_swing,
                              cent_loop_setup)):
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


# ---------------------------------------------------------------------------
# K3 at every width it serves (csrc/riccati.cu)
# ---------------------------------------------------------------------------

# (name, nx, nu, T): Go2 kinodynamics, Go2 full dynamics, Talos
# kinodynamics, Talos full dynamics, Talos centroidal
RICCATI_WIDTHS = (("go2", 36, 24, T), ("go2_fd", 36, 12, 50), ("talos", 56, 34, T),
                  ("talos_fd", 56, 22, T), ("centroidal", 9, 12, T))
# widths no formulation has, checked and not timed, one for each kernel
# instance the five above leave out: the tiled kernel at nu=28 (its 32-wide
# factorization); the staged kernel at nu=48 (wider than the tiled one
# takes), and at nx=65, nu=28, where the tiled plan exceeds the H100's
# shared memory in f64 (the staged one fits) and takes the tiled kernel in f32
RICCATI_EXTRA_WIDTHS = (("nu28", 36, 28, 20), ("nu48", 36, 48, 20), ("nx65", 65, 28, 20))


def riccati_case(device, nx, nu, nT, nb, seed=0):
    """K3's inputs at one width: `testing.random_lq` made in f32 (its f64
    twin is the exact upcast, so one f64 twin serves both precisions'
    gates), every odd scenario with its last four controls unweighted as a
    swing foot's forces (zero rows and columns of Quu, zero rows of Qux and
    qu, zero columns of B: the Jacobi scale falls to sqrt(eps) there).
    Returns {dtype: (lin, Vx, Vxx)}."""
    from simple_mpc_tpu_torch.testing import random_lq

    lin, Vx, Vxx, _ = random_lq(nb, nT, nx, nu, torch.float32, device, seed=seed)
    z, odd = slice(nu - 4, nu), slice(1, None, 2)
    lin["Quu"][odd, :, z, :] = 0
    lin["Quu"][odd, :, :, z] = 0
    lin["Qux"][odd, :, z, :] = 0
    lin["qu"][odd, :, z] = 0
    lin["B"][odd, :, :, z] = 0
    return {dt: ({k: v.to(dt) for k, v in lin.items()}, Vx.to(dt), Vxx.to(dt))
            for dt in (torch.float32, torch.float64)}


def riccati_ptxas(log):
    """{"f32_nb24": {"registers", "stack_bytes"}, ...} of K3's instances (one
    a scalar type and factorization width, riccati.cu `riccati_nb`; "staged":
    the staged kernel) from nvcc's -Xptxas -v log."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"riccati_backward_kernelI([fd])Li(\d+)E", ln)
            cur = None if m is None else (
                f"{'f32' if m.group(1) == 'f' else 'f64'}_"
                + (f"nb{m.group(2)}" if m.group(2) != "0" else "staged"))
        elif cur is not None and "Used" in ln and "registers" in ln:
            stack = (int(ln.split("bytes cumulative stack")[0].split()[-1])
                     if "cumulative stack" in ln else 0)
            out[cur] = dict(registers=int(ln.split("Used")[1].split()[0]), stack_bytes=stack)
            cur = None
    return out


def riccati_check(name, data, twin, rows, key, reg):
    """K3 on rows of riccati_case's data against the f64 twin's rows, in
    both precisions: f64 within 1e-10 (rel_err on ks, Ks and Qus), f32 within
    ten times the f32 twin's own distance from the f64 twin.  Returns
    {dtype: (args, outputs, errors)}."""
    from simple_mpc_tpu_torch import kernels

    res = {}
    for dt in (torch.float32, torch.float64):
        dname = str(dt).replace("torch.", "")
        lin, Vx, Vxx = data[dt]
        args = ({k: v[rows].contiguous() for k, v in lin.items()}, Vx[rows].contiguous(),
                Vxx[rows].contiguous())
        got = kernels._riccati_cuda(*args, reg)
        check(all(torch.isfinite(a).all() for a in got), f"K3 {name} {key} {dname}: non-finite")
        err = max(rel_err(a, b[rows]) for a, b in zip(got, twin[torch.float64]))
        if dt == torch.float64:
            check(err <= 1e-10, f"K3 {name} {key} f64: {err:.3e} > 1e-10")
            res[dname] = (args, got, dict(rel_err=err))
        else:
            d = max(rel_err(a[rows], b[rows]) for a, b in zip(twin[dt], twin[torch.float64]))
            check(err <= 10 * d, f"K3 {name} {key} f32: {err:.3e} > 10 x {d:.3e}")
            res[dname] = (args, got, dict(kernel_vs_f64=err, twin_vs_f64=d))
    return res


def phase_riccati_kernels(device, ptxas_log="", digest=False):
    """K3 (`riccati_backward`, csrc/riccati.cu) against its twin at the five
    widths it serves (RICCATI_WIDTHS, riccati_case) at B=128 and at B=1
    (scenario 0, and scenario 1 with the unweighted controls, against the
    B=128 twin's rows; the twins run on the host), and at
    RICCATI_EXTRA_WIDTHS, untimed; gates in riccati_check.  Prints each
    width's CUDA-event medians at B=128 and B=1 in both precisions,
    microseconds a stage, the roofline bound (riccati_flops, inputs and
    outputs moved once), the kernel it takes and that kernel's shared memory
    a block (kernels.riccati_route, kernels.riccati_smem), registers and
    stack from the ptxas log; with `digest`, riccati.cu's SASS digest
    (sass_digests) beside LOCKED_SASS's."""
    from simple_mpc_tpu_torch import kernels

    sass = (sass_start(os.path.join(ROOT, "simple_mpc_tpu_torch", "csrc"), ("riccati.cu",),
                       os.path.join(ROOT, "simple_mpc_tpu_torch", "_build", "sass_riccati"))
            if digest else None)
    optin = kernels.smem_optin(device)
    reg = 1e-9
    out = {}
    for name, nx, nu, nT in RICCATI_WIDTHS + RICCATI_EXTRA_WIDTHS:
        t0 = time.perf_counter()
        timed = (name, nx, nu, nT) in RICCATI_WIDTHS
        nb = B if timed else 8
        data = riccati_case(device, nx, nu, nT, nb)
        # the twins on the host: their unrolled Cholesky is thousands of
        # elementwise ops a stage, launch-bound on the card
        twin = {dt: kernels.riccati_backward_plain(
            {k: v.cpu() for k, v in lin.items()}, Vx.cpu(), Vxx.cpu(), reg)
            for dt, (lin, Vx, Vxx) in data.items()}
        line = {}
        for n, rows in ((nb, slice(None)), (1, slice(0, 1)), (1, slice(1, 2))):
            key = f"B{n}" if n == nb else f"B1_scenario{rows.start}"
            for dname, (args, got, res) in riccati_check(name, data, twin, rows, key,
                                                         reg).items():
                if timed and rows.start != 1:
                    ms = cuda_ms(lambda a=args: kernels._riccati_cuda(*a, reg), REPS)
                    res.update(ms=ms, us_a_stage=1e3 * ms / nT,
                               bound=roofline(riccati_flops(n, nT, nx, nu),
                                              nbytes((args, got))))
                line.setdefault(dname, {})[key] = res
        for dt in (torch.float32, torch.float64):
            route = kernels.riccati_route(nx, nu, dt, optin)
            line[str(dt).replace("torch.", "")].update(
                kernel=route, smem_bytes=kernels.riccati_smem(nx, nu, dt)[route])
        out[name] = line
        phase(f"riccati_kernels_{name}", t0, T=nT, nx=nx, nu=nu, smem_optin_bytes=optin, **line)
    t0 = time.perf_counter()
    extra = {}
    if sass is not None:
        digests, release = sass_digests(sass)
        extra = dict(nvcc=release, sha256=digests["riccati.cu"],
                     locked=LOCKED_SASS["riccati.cu"])
    phase("riccati_kernels_build", t0, ptxas=riccati_ptxas(ptxas_log), **extra)
    return out


def riccati_library(src, name, defines=()):
    """riccati.cu at `src` built alone (its plain C interface, seconds of
    nvcc) into _build/<name>/, loaded with its entry points typed."""
    import ctypes

    from simple_mpc_tpu_torch import kernels

    work = os.path.join(ROOT, "simple_mpc_tpu_torch", "_build", name)
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, f"lib{name}.so")
    r = subprocess.run([kernels._nvcc(), *kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", *defines, "-o", so, src], capture_output=True, text=True)
    check(r.returncode == 0, f"{name} build: {r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in ("smpc_riccati_backward_f32", "smpc_riccati_backward_f64"):
        getattr(lib, fn).argtypes = [P] * 10 + [D, D, I, I, I, I] + [P] * 4
    return lib


def riccati_caller(lib, device, lin, Vx, Vxx, reg):
    """A call of `lib`'s K3 on these inputs, into outputs of its own."""
    from simple_mpc_tpu_torch import kernels

    dt = Vx.dtype
    dims, ins, res = kernels._backward_args(lin, Vx, Vxx)
    fn = getattr(lib, f"smpc_riccati_backward_{kernels._suffix(dt)}")

    def call():
        err = fn(*ins, reg, float(torch.finfo(dt).eps), *dims, *[o.data_ptr() for o in res],
                 kernels._stream(device))
        check(err == 0, f"riccati baseline: launch error {err}")
        return res

    return call


def phase_riccati_versus(device):
    """This tree's K3 against another tree's csrc/riccati.cu (the path in
    SMPC_RICCATI_BASELINE, built alone) in one process, at the five widths
    (RICCATI_WIDTHS, riccati_case) and RICCATI_EXTRA_WIDTHS, B=128 and
    B=1, f32 and f64: whether the outputs are bitwise equal (gated: the
    redesigned kernel keeps every operation's order), and at the five
    widths the CUDA-event medians in the order baseline, this, this,
    baseline, with microseconds a stage and the ratio of the means."""
    from simple_mpc_tpu_torch import kernels

    t0 = time.perf_counter()
    src = os.environ.get("SMPC_RICCATI_BASELINE")
    check(src is not None and os.path.isfile(src),
          "riccati_versus: set SMPC_RICCATI_BASELINE to another tree's csrc/riccati.cu")
    base = riccati_library(src, "riccati_baseline")
    reg = 1e-9
    out = {}
    for name, nx, nu, nT in RICCATI_WIDTHS + RICCATI_EXTRA_WIDTHS:
        timed = (name, nx, nu, nT) in RICCATI_WIDTHS
        nb = B if timed else 8
        data = riccati_case(device, nx, nu, nT, nb)
        line = {}
        for dt in (torch.float32, torch.float64):
            lin, Vx, Vxx = data[dt]
            for n, rows in ((nb, slice(None)), (1, slice(0, 1)), (1, slice(1, 2))):
                args = ({k: v[rows].contiguous() for k, v in lin.items()}, Vx[rows].contiguous(),
                        Vxx[rows].contiguous())
                this = lambda a=args: kernels._riccati_cuda(*a, reg)  # noqa: E731
                that = riccati_caller(base, device, *args, reg)
                same = all(torch.equal(a, b) for a, b in zip(this(), that()))
                key = f"{kernels._suffix(dt)}_" + (f"B{n}" if n == nb else f"B1_scenario{rows.start}")
                check(same, f"riccati_versus {name} {key}: outputs differ from the baseline's")
                res = dict(bitwise=same)
                if timed and rows.start != 1:
                    b1, t1, t2, b2 = (cuda_ms(f, REPS) for f in (that, this, this, that))
                    res.update(baseline_ms=[b1, b2], ms=[t1, t2],
                               us_a_stage=500 * (t1 + t2) / nT,
                               baseline_us_a_stage=500 * (b1 + b2) / nT,
                               speedup=(b1 + b2) / (t1 + t2))
                line[key] = res
        out[name] = line
    phase("riccati_versus", t0, baseline=os.path.relpath(src, ROOT), **out)
    return out


# K3's profiling marks (csrc/riccati.cu SMPC_MARK(n)), each the cycles of
# thread 0 (marks 0-12) or thread 32 (13-15) of block 0 since that thread's
# mark before it, summed over the stages
RICCATI_MARKS = {0: "G: Vxx, Vx and the wait at the stage's top", 1: "A: VAB",
                 2: "B: Q's control rows",
                 12: "B': the Jacobi scale, scaled Quu and right-hand sides",
                 10: "C: warp 0's factor", 13: "C: thread 32's load of its right-hand side",
                 14: "C: thread 32's forward solve, behind the factor",
                 15: "C: thread 32's back solve",
                 3: "C: the rest of phase C after warp 0's factor (the solves)",
                 4: "D: sol = x / dscale and the gains out", 5: "E: Quu sol",
                 6: "F: Qux' sol, sol' Quu sol"}


def phase_riccati_phases(device):
    """Where a K3 stage's time goes: csrc/riccati.cu built alone with
    -DSMPC_RICCATI_PROF (its clock64() marks), run at B=1 on riccati_case's
    scenario 0 at the five widths in both precisions; cycles a stage for
    each mark (RICCATI_MARKS) and the CUDA-event time."""
    import ctypes

    from simple_mpc_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = riccati_library(os.path.join(ROOT, "simple_mpc_tpu_torch", "csrc", "riccati.cu"),
                          "riccati_phases", ("-DSMPC_RICCATI_PROF",))
    lib.smpc_riccati_marks.argtypes = [ctypes.c_void_p]
    out = {}
    for name, nx, nu, nT in RICCATI_WIDTHS:
        data = riccati_case(device, nx, nu, nT, 2)
        for dt in (torch.float32, torch.float64):
            lin, Vx, Vxx = data[dt]
            call = riccati_caller(lib, device, {k: v[:1].contiguous() for k, v in lin.items()},
                                  Vx[:1].contiguous(), Vxx[:1].contiguous(), 1e-9)
            ms = cuda_ms(call, REPS)
            marks = (ctypes.c_longlong * 16)()
            check(lib.smpc_riccati_marks(marks) == 0, "riccati_phases: cudaMemcpyFromSymbol")
            out[f"{name}_{kernels._suffix(dt)}"] = dict(
                ms=ms, cycles_a_stage={v: round(marks[q] / nT) for q, v in RICCATI_MARKS.items()})
    phase("riccati_phases", t0, B=1, **out)
    return out


PHASES = ("kernels", "fd_kernels", "id_sim_kernels", "fixture", "talos_kernels",
          "talos_fixture", "talos_id_sim_kernels", "talos_closed_loop", "line_search_kernels",
          "tick_traces", "talos_tick_kernels", "k6_wide_kernels", "talos_fused", "fd_fused",
          "talos_fd_kernels", "talos_fd_batched", "talos_fd_mpc", "talos_fd_closed_loop",
          "talos_centroidal_kernels", "talos_centroidal_batched", "talos_centroidal_mpc",
          "talos_centroidal_closed_loop", "riccati_kernels", "riccati_phases", "riccati_versus")


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
    sass_job = None if phases is not None else locked_sass_start()

    if phases is not None:
        runs = dict(kernels=phase_kernels, fd_kernels=phase_fd_kernels,
                    id_sim_kernels=lambda d: phase_id_sim_kernels(d, info["log"]),
                    fixture=phase_fixture,
                    talos_kernels=lambda d: phase_talos_kernels(d, info["log"]),
                    talos_fixture=phase_talos_fixture,
                    talos_id_sim_kernels=lambda d: phase_talos_id_sim_kernels(d, info["log"]),
                    talos_closed_loop=lambda d: phase_talos_closed_loop(
                        d, *talos_closed_loop_setup(d)),
                    line_search_kernels=phase_line_search_kernels, tick_traces=phase_tick_traces,
                    talos_tick_kernels=phase_talos_tick_kernels,
                    k6_wide_kernels=phase_k6_wide_kernels,
                    talos_fused=lambda d: (phase_talos_fused(d),
                                           phase_latency(d, *talos_latency_setup(d))),
                    fd_fused=lambda d: (phase_fd_fused(d), phase_latency(d, *fd_latency_setup(d))),
                    talos_fd_kernels=lambda d: phase_talos_fd_kernels(d, info["log"]),
                    talos_fd_batched=lambda d: phase_talos_fd_batched(
                        d, *talos_fd_batched_setup(d)),
                    talos_fd_mpc=phase_talos_fd_mpc,
                    talos_fd_closed_loop=phase_talos_fd_closed_loop,
                    talos_centroidal_kernels=lambda d: phase_talos_centroidal_kernels(
                        d, info["log"]),
                    talos_centroidal_batched=lambda d: phase_talos_centroidal_batched(
                        d, *cent_batched_setup(d)),
                    talos_centroidal_mpc=phase_talos_centroidal_mpc,
                    talos_centroidal_closed_loop=lambda d: (
                        phase_talos_centroidal_closed_loop(d, *cent_loop_setup(d)),
                        phase_talos_centroidal_swing(d, *cent_loop_setup(d)),
                        phase_talos_centroidal_loop_reading(d)),
                    riccati_kernels=lambda d: phase_riccati_kernels(d, info["log"], digest=True),
                    riccati_phases=phase_riccati_phases, riccati_versus=phase_riccati_versus)
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
    tickres = phase_talos_tick_kernels(device)
    phase_k6_wide_kernels(device)
    fdwres = phase_talos_fd_kernels(device, info["log"])
    centres = phase_talos_centroidal_kernels(device, info["log"], sass_job)
    phase_riccati_kernels(device, info["log"])
    launches = drive_main_path(device)
    phase_talos_fd_closed_loop(device)
    phase_talos_centroidal_loop_reading(device)

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
        wide_tick_refs=("tick_wide.cu", "simple_mpc_tpu/mpc/fused.py:175"),
        wide_fd_stage_linearize=("fulldyn_wide.cu", "simple_mpc_tpu/ocp/fulldynamics.py:194"),
        wide_fd_stage_eval=("fulldyn_wide.cu", "simple_mpc_tpu/solver/proxddp.py:183"),
        wide_fd_dynamics=("fulldyn_wide.cu", "simple_mpc_tpu/ops/soa_dyn.py:199"),
        centroidal_stage_linearize=("centroidal.cu", "simple_mpc_tpu/solver/proxddp.py:222"),
        centroidal_stage_eval=("centroidal.cu", "simple_mpc_tpu/solver/proxddp.py:197"),
        centroidal_term_linearize=("centroidal.cu", "simple_mpc_tpu/solver/proxddp.py:352"),
        centroidal_state_derivative=("centroidal.cu", "simple_mpc_tpu/ocp/centroidal.py:251"),
        vector_candidate_integrate=("centroidal.cu", "simple_mpc_tpu/solver/proxddp.py:470"),
        vector_state_difference=("centroidal.cu", "simple_mpc_tpu/solver/proxddp.py:527"),
        centroidal_line_search_select=("linesearch_centroidal.cu",
                                       "simple_mpc_tpu/solver/proxddp.py:529"),
        centroidal_id_assemble=("id_centroidal.cu", "simple_mpc_tpu/id/centroidal_id.py:70"),
    )
    # line_search_select also replaces the terminal AL cost and merit
    # (:207-217) and prim and the BCL update (:546-600)
    also = {k: ["simple_mpc_tpu/solver/proxddp.py:207", "simple_mpc_tpu/solver/proxddp.py:546"]
            for k in ("line_search_select", "wide_line_search_select",
                      "centroidal_line_search_select")}
    # each kernel's readings from the phase that checked it (phase 3's
    # K3 and K4 are Go2's, qp_admm Go2's; the Talos phases' are printed
    # there); the closed loops' kernels at B=1
    checked = (kres["float32"], fdres["float32"], talres["float32"], lsres["float32"],
               tickres["float32"], fdwres["float32"], centres["float32"])
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
                 wide_sim_step=(1, 1), centroidal_id_assemble=(B, 1))
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
