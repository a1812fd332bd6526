#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_mpc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases fd_kernels,fixture,id_sim_kernels

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
               p50/p99 of the tick, of its references (with the ten inner
               steps' interpolated targets), of the inner step (ID and
               simulator) and of the inner step with a tenth of the
               references; the three kernels' times and a trace of 10
               inner steps.
Phases 4-10 and 12 drive the main paths.  The kernels' launch counters are
zeroed just before each of them (after the latency engine's and the closed
loop's set-up, whose first solves run before the path) and read just after
(a `<phase>_launches` line): each must have launched every kernel it runs
(phase 7 the six of the serial tick; phase 8 the same with K6 in place of
K3, and K3 never; phases 9-10 the full-dynamics stage kernels and never the
kinodynamics ones; phase 12 the five solver kernels exactly once a tick and
the three closed-loop kernels exactly once an inner step).  The kernel
summary's `launches` is the sum over those eight runs; the launches of
phases 3 and 11 and of phase 12's timings are not counted.  Its `bound_ms` is the larger of the bytes each
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
SOLVER_KERNELS = ("stage_linearize", "stage_eval", "riccati_backward", "linear_rollout",
                  "term_linearize")
LATENCY_KERNELS = ("stage_linearize", "stage_eval", "parallel_riccati_backward",
                   "linear_rollout", "term_linearize", "tick_refs")
FD_SOLVER_KERNELS = ("fd_stage_linearize", "fd_stage_eval", "riccati_backward",
                     "linear_rollout", "term_linearize")
PATH_KERNELS = dict(batched=SOLVER_KERNELS, fixture=SOLVER_KERNELS, mpc=SOLVER_KERNELS,
                    fused=SOLVER_KERNELS + ("tick_refs",), latency=LATENCY_KERNELS,
                    fd_batched=FD_SOLVER_KERNELS,
                    fd_mpc=FD_SOLVER_KERNELS + ("fd_dynamics",))
PATH_KERNELS["closed_loop"] = SOLVER_KERNELS + ("id_assemble", "qp_admm", "sim_step")
# launches of a closed-loop run: each tick's MPC iteration launches each
# solver kernel once, each inner step each of the three once
PATH_EXACT = dict(closed_loop=lambda ticks: {
    **dict.fromkeys(SOLVER_KERNELS, ticks),
    **dict.fromkeys(("id_assemble", "qp_admm", "sim_step"), 10 * ticks)})
PATH_ABSENT = dict(latency=("riccati_backward",),
                   fd_batched=("stage_linearize", "stage_eval"),
                   fd_mpc=("stage_linearize", "stage_eval"),
                   closed_loop=("parallel_riccati_backward", "tick_refs", "fd_stage_linearize",
                                "fd_stage_eval", "fd_dynamics"))
FD_MPC_T = 50  # examples/go2_fulldynamics.py's horizon
CLOSED_LOOP_T = 50  # examples/go2_kinodynamics.py's horizon
CLOSED_LOOP_TICKS = 160  # tests/test_walking.py:181
# f32 closed-loop kernels vs their twin in f64 (see phase_id_sim_kernels)
F32_ID_TOL = 1e-6
F32_QP_TOL = 2e-2
F32_SIM_TOL = 1e-5
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

        def as64(args):
            """The arguments with every floating tensor (in param tuples too)
            in f64."""
            def leaf(a):
                return a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            return tuple(tree_map(leaf, a) for a in args)

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
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    def walking_mpc(force_cone):
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


def phase_mpc(device):
    """Host MPC loop on the card (examples/go2_kinodynamics.py trot)."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    t0 = time.perf_counter()
    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=torch.float32)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                          max_iters=1, num_threads=1, swing_apex=0.05, T_fly=30,
                          T_contact=10, timestep=0.01, init_max_iters=20), ocp)
    check(not mpc.diverged, "MPC: initial solve diverged")
    setup = time.perf_counter() - t0
    feet = mh.feet_names
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    mpc.generate_cycle_horizon([ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
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


def ptxas_report(log, names):
    """{kernel: {"registers": n, "stack_bytes": n}} of the kernels whose
    mangled names contain one of `names`, read from nvcc's -Xptxas -v log:
    the kernel's "Used" line, whose cumulative stack size counts the stack
    of the device functions it calls (a kernel's own "stack frame" line
    reads 0 where its work sits in a function that was not inlined)."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((n for n in names if n in ln), None)
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


def qp_flops(n, m, iters):
    """Counted FLOPs of one ADMM solve: K = H + sigma I + A' diag(rho) A, its
    Cholesky, per step A'w, the two triangular solves, Ax and ~10 m
    elementwise; the residuals at the end."""
    return (2 * m * n * n + n ** 3 / 3 + iters * (4 * m * n + 2 * n * n + 10 * m)
            + 4 * m * n + 2 * n * n)


def phase_id_sim_kernels(device, ptxas_log=""):
    """K8 (qp_admm, id_assemble) and K10 (sim_step) against their twins on
    the card, at B=1 (the closed loop's shape) and B=128, f32 and f64, on
    perturbed Go2 states (id_sim_case).  Gates: in f64 the kernel within
    1e-10 of the twin (max|a - b| / max(1, max|b|); for l and u over the
    finite rows, the rows off at +-1e20 equal); the QP's residuals within
    1e-10 of the twin's relative to the scale of the sums that form them;
    in f32 the kernel against the twin in f64 on the same inputs within
    F32_ID_TOL, F32_QP_TOL (z and y; the f32 residuals are roundoff and
    printed) and F32_SIM_TOL, the masks of both solves equal to the twin's
    in both types.  Those three are about four to seven times the f32
    twin's own distance to the f64 twin on these inputs (printed beside
    them).  The QP runs on the twin's assembly of each dtype, cold and
    warm-started from its cold solution."""
    from simple_mpc_tpu_torch import kernels

    out = {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        t0 = time.perf_counter()
        errs, abs_err, vs64, times, bounds, masks = {}, {}, {}, {}, {}, {}
        for nb in (1, B):
            ids, sim, idin, simin = id_sim_case(device, dtype, nb, seed=11)

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
                gate("id_assemble", got, want, want64, F32_ID_TOL if f32 else 1e-10)
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
                    gate("qp_admm", got, want, want64, F32_QP_TOL if f32 else 1e-10,
                         keep=(0, 1))
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
                      f"sim_step {dtype} B={nb}: contact masks differ from the twin's")
            gate("sim_step", got[:3], want[:3], want64 and want64[:3],
                 F32_SIM_TOL if f32 else 1e-10)
            masks[f"B{nb}"] = got.active.sum(dim=0).tolist()

            idq = ids[0]
            args = (idin["q"], idin["v"], idin["targets"])
            H, g, A, l, u, M, h, JcT = kernels.id_assemble(idq, *args)
            qp_args = (H, g, A, l, u)
            slow = SLOW_REPS
            times[f"B{nb}"] = dict(
                id_assemble=(cuda_ms(lambda: kernels.id_assemble(idq, *args), REPS),
                             cuda_ms(lambda: idq._assemble_core(*args), slow)),
                qp_admm=(cuda_ms(lambda: kernels.qp_admm(*qp_args, iters=60), REPS),
                         cuda_ms(lambda: kernels.solve_qp(*qp_args, 60), slow)),
                sim_step=(cuda_ms(lambda: kernels.sim_step(sim, *simin), REPS),
                          cuda_ms(lambda: sim.step_plain(*simin), slow)))
            n, m = H.shape[-1], A.shape[-2]
            nr = idq.nu + 6 + 2 * 3 * idq.nk
            nv, nc = idq.nv, 3 * idq.nk
            per = dict(
                id_assemble=(2 * nr * n * n + 2 * nr * n,
                             nbytes((args, H, g, A, l, u, M, h, JcT))),
                qp_admm=(qp_flops(n, m, 60), nbytes((qp_args, cold))),
                sim_step=(2 * k7_flops(nv, nc), nbytes((simin, got[:3]))))
            bounds[f"B{nb}"] = {k: roofline(f * nb, mv) for k, (f, mv) in per.items()}
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times, bounds=bounds)
        phase(f"id_sim_kernels_{name}", t0, tol=dict(
                  id_assemble=F32_ID_TOL, qp_admm=F32_QP_TOL, sim_step=F32_SIM_TOL)
              if f32 else 1e-10, rel_err=errs, max_abs_err=abs_err,
              kernel_and_twin_vs_f64_twin=vs64 or None, masks_active_per_foot=masks,
              ms_kernel_vs_plain=times, bound_ms=bounds if f32 else None,
              ptxas=ptxas_report(ptxas_log, ("qp_admm_kernel", "id_assemble_kernel",
                                             "sim_step_kernel")))
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


def phase_closed_loop(device, mpc, mh, idq):
    """The Go2 kinodynamics closed loop of the port's example
    (examples/go2_kinodynamics.py: T=50, trot 10/30/10/30 at 0.2 m/s, apex
    0.05 m, mu_init 1e-8, the example's IDSettings with qp_iters 60, the
    simulator at dt 1e-3 with 10 inner steps a tick), f32, for
    CLOSED_LOOP_TICKS MPC ticks.  Gates (tests/test_walking.py:184-209):
    finite; base z within 0.08 m of its start; progress > 0.02 m; |v| < 20;
    stance feet slip < 2 cm between ticks.  Prints p50/p99 on the host
    clock of the MPC iteration, of the tick's references (state
    derivatives, reference forces and the 10 interpolated targets), of
    the inner step (ID and simulator: the interpolation is not in it) and
    of the inner step with a tenth of its tick's references (the whole
    1 kHz cost a step), the three kernels' CUDA-event
    medians at the loop's last state, profiler traces of 10 inner steps and
    of one tick's references, and the host time of interpolating one inner
    step's state target against a tick's ten at once."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.examples.go2_kinodynamics import run
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.ops import soa
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator
    from simple_mpc_tpu_torch.utils.interpolator import Interpolator

    t0 = time.perf_counter()
    log = run(mpc, mh, idq, n_steps=CLOSED_LOOP_TICKS, log_every=0)
    wall = time.perf_counter() - t0
    # the loop's launches; those of the timings below are put back out
    loop_launches = {k: k.launches for k in kernels.KERNELS}
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
    tick_ms = 1e3 * np.asarray(log["solve_time"])
    refs_ms = 1e3 * np.asarray(log["refs_time"])
    inner_ms = 1e3 * np.asarray(log["inner_time"])
    # the whole 1 kHz cost a step: the tick's references and targets shared
    # over its 10 inner steps, plus the step (ID and simulator)
    step_all_ms = refs_ms / 10 + inner_ms

    # the three kernels at the loop's last state, and a trace of inner steps
    dev, dt = mpc.xs.device, mpc.xs.dtype
    qd = torch.as_tensor(q[-1], dtype=dt, device=dev)
    vd = torch.as_tensor(v[-1], dtype=dt, device=dev)
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device=dev)
    targets = {k: a[None] for k, a in idq._targets.items()}
    qb, vb = qd[None], vd[None]
    H, g, A, l, u = kernels.id_assemble(idq, qb, vb, targets)[:5]
    tau = idq.solve(0.0, qd, vd)
    kms = dict(id_assemble=cuda_ms(lambda: kernels.id_assemble(idq, qb, vb, targets), REPS),
               qp_admm=cuda_ms(lambda: kernels.qp_admm(H, g, A, l, u, iters=60), REPS),
               sim_step=cuda_ms(lambda: kernels.sim_step(sim, qb, vb, tau[None]), REPS))

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
    phase("closed_loop", t0, T=CLOSED_LOOP_T, ticks=CLOSED_LOOP_TICKS, inner_steps_per_tick=10,
          dtype="float32", wall_s=wall,
          tick_p50_ms=float(np.percentile(tick_ms, 50)),
          tick_p99_ms=float(np.percentile(tick_ms, 99)),
          refs_p50_ms=float(np.percentile(refs_ms, 50)),
          refs_p99_ms=float(np.percentile(refs_ms, 99)),
          inner_step_p50_ms=float(np.percentile(inner_ms, 50)),
          inner_step_p99_ms=float(np.percentile(inner_ms, 99)),
          inner_step_with_refs_p50_ms=float(np.percentile(step_all_ms, 50)),
          inner_step_with_refs_p99_ms=float(np.percentile(step_all_ms, 99)),
          kernel_ms=kms, base_z=[float(q[:, 2].min()), float(q[:, 2].max())],
          progress_m=float(q[-1, 0] - q[0, 0]), max_abs_v=float(np.abs(v).max()),
          max_stance_slip_m=slip_max, ten_inner_steps_trace=trace,
          tick_refs_trace=refs_trace, interpolate_state_host_ms=interp_ms)


def drive_main_path(device):
    """Phases 4-8, each with the launch counters zeroed just before it (after
    its set-up) and read just after; returns the launches of each kernel
    summed over them."""
    from simple_mpc_tpu_torch import kernels

    launches = dict.fromkeys((k.__name__ for k in kernels.KERNELS), 0)
    for path, run, setup in (("batched", phase_batched, None), ("fixture", phase_fixture, None),
                             ("mpc", phase_mpc, None), ("fused", phase_fused, None),
                             ("latency", phase_latency, latency_setup),
                             ("fd_batched", phase_fd_batched, None),
                             ("fd_mpc", phase_fd_mpc, None),
                             ("closed_loop", phase_closed_loop, closed_loop_setup)):
        args = setup(device) if setup else ()
        kernels.reset_launches()
        run(device, *args)
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"the {path} path never launched {name}")
        for name in PATH_ABSENT.get(path, ()):
            check(counts[name] == 0, f"the {path} path launched {name}")
        if path in PATH_EXACT:
            for name, n in PATH_EXACT[path](CLOSED_LOOP_TICKS).items():
                check(counts[name] == n, f"the {path} path launched {name} "
                      f"{counts[name]} times, not {n}")
        print(json.dumps({"phase": f"{path}_launches", "launches": counts}), flush=True)
        for name, n in counts.items():
            launches[name] += n
    return launches


PHASES = ("kernels", "fd_kernels", "id_sim_kernels", "fixture")


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
                    fixture=phase_fixture)
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
    )
    id32 = idres["float32"]
    f32 = {k: {n: {**kres["float32"][n], **fdres["float32"][n]}[k] for n in
               ("abs_err", "times", "bounds")} for k in replaces if k not in id32["errs"]}
    f32.update({k: dict(abs_err=id32["abs_err"][k], times=id32["times"]["B1"][k],
                        bounds=id32["bounds"]["B1"][k]) for k in id32["errs"]})
    shape = dict(parallel_riccati_backward=(1, T), fd_dynamics=(1, 1), qp_admm=(1, 1),
                 id_assemble=(1, 1), sim_step=(1, 1))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simple_mpc_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": f32[name]["abs_err"], "ms": f32[name]["times"][0],
         "plain_ms": f32[name]["times"][1], "bound_ms": f32[name]["bounds"][0],
         "bound_by": f32[name]["bounds"][1], "library_ms": None,
         "B": shape.get(name, (B, T))[0], "T": shape.get(name, (B, T))[1],
         "dtype": "float32"}
        for name, (src, rep) in replaces.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
