#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_mpc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1. device  — requires a CUDA card; prints its name and power limit.
  2. build   — compiles the CUDA kernels (csrc/*.cu, nvcc, sm_90a).
  3. kernels — every kernel against its plain PyTorch twin on the card, at
               the main path's shapes (Go2 kinodynamics T=100, B=128, from
               a perturbed standing problem), f32 and f64: K1+K2
               stage_linearize, K5 term_linearize, K3 riccati_backward, K4
               linear_rollout, K1 stage_eval on the candidates, and K9
               tick_refs on 128 fused-tick carries with perturbed
               measurements; times as CUDA-event medians (the slow twins
               of K1+K2, K3 and K5 on 3 repetitions).
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
Phases 4-7 drive the main path.  The kernels' launch counters are zeroed
just before each of them and read just after (a `<phase>_launches` line):
each must have launched every kernel it runs (phase 7 all six).  The
kernel summary's `launches` is the sum over those four runs; the launches
of phase 3 are not counted.  The second-to-last lines are the kernel
summary (JSON) and nvidia-smi's name/power limit; the last line is
{"ok": true, "device": {...}}.
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
# the kernels each path of the main path must launch
SOLVER_KERNELS = ("stage_linearize", "stage_eval", "riccati_backward", "linear_rollout",
                  "term_linearize")
PATH_KERNELS = dict(batched=SOLVER_KERNELS, fixture=SOLVER_KERNELS, mpc=SOLVER_KERNELS,
                    fused=SOLVER_KERNELS + ("tick_refs",))


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


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def phase(name, t0, **fields):
    line = {"phase": name, "seconds": round(time.perf_counter() - t0, 3), **fields}
    print(json.dumps(line), flush=True)


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


def fused_engine(device, dtype=torch.float32):
    """The bench's fused-tick configuration (bench.py:288-303) on the card:
    Go2 T=100, trot 10/30/10/30 at 0.2 m/s, apex 0.15 m, one iteration a
    tick with mu_init 1e-6, serial Riccati.  Returns (fused, carry)."""
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, FusedMPC, MPCSettings
    from simple_mpc_tpu_torch.parallel import BatchedSolver
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=dtype)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, max_iters=1, T_fly=30,
                          T_contact=10, swing_apex=0.15, init_max_iters=2), ocp)
    mpc.solver = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(
        tol=mpc.settings.TOL, mu_init=1e-6, max_iters=1)))
    FL, FR, RL, RR = mh.feet_names
    allc = {n: True for n in mh.feet_names}
    mpc.generate_cycle_horizon([allc] * 10 + [{FL: True, FR: False, RL: False, RR: True}] * 30
                               + [allc] * 10 + [{FL: False, FR: True, RL: True, RR: False}] * 30)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
    fused = FusedMPC(mpc)
    return fused, fused.make_carry(mpc)


def phase_kernels(device):
    """Every kernel against its twin on the card; f32 and f64."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    out = {}
    fused, carry1 = fused_engine(device)
    for dtype, tol_lin, tol_k3, tol_k4, tol_eval, tol_tick in (
            (torch.float32, 1e-4, 1e-4, 1e-5, 1e-5, 1e-6),
            (torch.float64, 1e-10, 1e-10, 1e-10, 1e-10, 1e-12)):
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
        name = str(dtype).replace("torch.", "")
        out[name] = dict(errs=errs, abs_err=abs_err, times=times)
        phase(f"kernels_{name}", t0, B=B, T=T, rel_err=errs, max_abs_err=abs_err,
              ms_kernel_vs_plain=times)
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
          step_p99_ms=float(np.percentile(lat_ms, 99)), step_prim=float(r1.prim_res))


def drive_main_path(device):
    """Phases 4-7, each with the launch counters zeroed just before it and
    read just after; returns the launches of each kernel summed over them."""
    from simple_mpc_tpu_torch import kernels

    launches = dict.fromkeys((k.__name__ for k in kernels.KERNELS), 0)
    for path, run in (("batched", phase_batched), ("fixture", phase_fixture),
                      ("mpc", phase_mpc), ("fused", phase_fused)):
        kernels.reset_launches()
        run(device)
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        for name in PATH_KERNELS[path]:
            check(counts[name] > 0, f"the {path} path never launched {name}")
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
        linear_rollout=("rollout.cu", "simple_mpc_tpu/solver/proxddp.py:458"),
        term_linearize=("linearize.cu", "simple_mpc_tpu/solver/proxddp.py:352"),
        tick_refs=("tick.cu", "simple_mpc_tpu/mpc/fused.py:175"),
    )
    f32 = kres["float32"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simple_mpc_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": f32["abs_err"][name], "ms": f32["times"][name][0],
         "plain_ms": f32["times"][name][1]}
        for name, (src, rep) in replaces.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
