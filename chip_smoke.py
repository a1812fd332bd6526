#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_mpc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

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
               K1+K2, K3 and K5 on 3 repetitions).
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
Phases 4-8 drive the main path.  The kernels' launch counters are zeroed
just before each of them (after the latency engine's set-up, whose first
solve is serial) and read just after (a `<phase>_launches` line): each
must have launched every kernel it runs (phase 7 the six of the serial
tick; phase 8 the same with K6 in place of K3, and K3 never).  The kernel
summary's `launches` is the sum over those five runs; the launches of
phase 3 are not counted.  Its `bound_ms` is the larger of the bytes each
kernel moves (inputs read once, outputs written once, at the summary's
shape) over 3.35 TB/s and its counted FLOPs over 67 TFLOP/s (H100 SXM,
FP32 outside the tensor cores); FLOPs of the rigid-body arithmetic of K1,
K2, K5 and K9 are not counted, so their bounds are lower bounds; K6's
count holds the combines a work-efficient scan needs, not the 3.0 times as
many of its own Hillis-Steele schedule.  No single PyTorch call computes
any of these functions (`library_ms` null).  The second-to-last lines are
the kernel summary (JSON) and nvidia-smi's name/power limit; the last line
is {"ok": true, "device": {...}}.
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
REPS = 20
SLOW_REPS = 3  # the torch.func twins of K1+K2 and K5 and the f64 twin of K3
# the kernels each path of the main path must launch, and must not
SOLVER_KERNELS = ("stage_linearize", "stage_eval", "riccati_backward", "linear_rollout",
                  "term_linearize")
LATENCY_KERNELS = ("stage_linearize", "stage_eval", "parallel_riccati_backward",
                   "linear_rollout", "term_linearize", "tick_refs")
PATH_KERNELS = dict(batched=SOLVER_KERNELS, fixture=SOLVER_KERNELS, mpc=SOLVER_KERNELS,
                    fused=SOLVER_KERNELS + ("tick_refs",), latency=LATENCY_KERNELS)
PATH_ABSENT = dict(latency=("riccati_backward",))
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
                cuda_ms(lambda: kernels.riccati_backward_plain(lin0, Vx, Vxx, reg),
                        REPS if dtype == torch.float32 else slow)),
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


def drive_main_path(device):
    """Phases 4-8, each with the launch counters zeroed just before it (after
    its set-up) and read just after; returns the launches of each kernel
    summed over them."""
    from simple_mpc_tpu_torch import kernels

    launches = dict.fromkeys((k.__name__ for k in kernels.KERNELS), 0)
    for path, run, setup in (("batched", phase_batched, None), ("fixture", phase_fixture, None),
                             ("mpc", phase_mpc, None), ("fused", phase_fused, None),
                             ("latency", phase_latency, latency_setup)):
        args = setup(device) if setup else ()
        kernels.reset_launches()
        run(device, *args)
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"the {path} path never launched {name}")
        for name in PATH_ABSENT.get(path, ()):
            check(counts[name] == 0, f"the {path} path launched {name}")
        print(json.dumps({"phase": f"{path}_launches", "launches": counts}), flush=True)
        for name, n in counts.items():
            launches[name] += n
    return launches


def main():
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

    kres = phase_kernels(device)
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
    )
    f32 = kres["float32"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simple_mpc_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": f32["abs_err"][name], "ms": f32["times"][name][0],
         "plain_ms": f32["times"][name][1], "bound_ms": f32["bounds"][name][0],
         "bound_by": f32["bounds"][name][1], "library_ms": None,
         "B": 1 if name == "parallel_riccati_backward" else B, "T": T, "dtype": "float32"}
        for name, (src, rep) in replaces.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
