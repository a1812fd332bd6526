"""The Talos fixture's f32 recipe and f64 polish (tests/test_parity_fixtures.py
`test_f32_matches_f64_fixture[talos]`) in the JAX package on a CPU, and the
port's f64 polish from JAX's own f32 point (slow: two JAX compiles of the
T=100 solver, ~8 min).

JAX's f32 pass (BCL 30 iterations, then two rounds of 30 ungated multiplier
iterations) stops short of its f32 floor: max|us - us*| 4.6e-3 against the
fixture (measured on a CPU; that test's gate is 3e-3); six rounds are
printed.  The three f64
multiplier iterations from that point then move the forces to 1.0e-2 of
the fixture, taking no step from the second iteration on (a step size of
0 wins the line search), where that test expects 1e-4.  The port's polish
from the same point follows JAX's to 1e-9 of the largest entry (asserted;
the readings are printed: they depend on the CPU's f32 roundoff).
This is why chip_smoke.py's `talos_fixture` runs the f32 rounds to their
fixed point and gates the f64 path with the fixture generator's own solve.
"""
import os

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 100


@pytest.mark.slow
def test_talos_f64_polish_matches_jax_from_its_f32_point():
    import jax.numpy as jnp

    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings
    from tools.make_parity_fixtures import build_ocp

    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                              "talos_kinodynamics_T100.npz"))
    jocp, jmh = build_ocp("talos")
    mm = dict(tol=1e-7, mu_init=1e-4, max_iters=30)
    s_mm = JSolver(jocp, JSettings(bcl=False, **mm))
    prob32 = jocp.problem.astype(jnp.float32)
    x0 = np.asarray(jmh.reference_state, np.float32)
    res = JSolver(jocp, JSettings(**mm)).run(
        prob32, jnp.tile(jnp.asarray(x0)[None], (T + 1, 1)),
        jnp.tile(jnp.asarray(jocp.get_reference_control(0), jnp.float32)[None], (T, 1)))
    rounds = []
    for _ in range(6):
        res = s_mm.run(prob32, res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term), res.mu)
        rounds.append(np.asarray(res.us, np.float64))
        if len(rounds) == 2:  # the f32 point of tests/test_parity_fixtures.py
            st = {k: np.asarray(getattr(res, k), np.float64)
                  for k in ("xs", "us", "lam_eq", "lam_in", "lam_term", "mu")}
    err32 = np.abs(st["us"] - fx["us"]).max()
    print("JAX f32 max|us - us*| after each round:",
          [float(np.abs(u - fx["us"]).max()) for u in rounds])
    jpol = s_mm.run(jocp.problem.astype(jnp.float64), jnp.asarray(st["xs"]),
                    jnp.asarray(st["us"]), (jnp.asarray(st["lam_eq"]), jnp.asarray(st["lam_in"]),
                                            jnp.asarray(st["lam_term"])),
                    jnp.asarray(st["mu"]), 3)
    jus = np.asarray(jpol.us)

    tocp, _, _ = make_talos_kinodynamics(T, device="cpu", dtype=torch.float64)
    t = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    solver = ProxDDPSolver(tocp, SolverSettings(bcl=False, **mm))
    probs = tile_problem(tocp.problem, 1)
    state = (t(st["xs"]), t(st["us"]), (t(st["lam_eq"]), t(st["lam_in"]), t(st["lam_term"])),
             torch.as_tensor([float(st["mu"])], dtype=torch.float64))
    tpol = solver.run(probs, *state, max_iters=3)
    tus = tpol.us[0].numpy()
    print("f32 point", err32, "polish: JAX", np.abs(jus - fx["us"]).max(),
          "port", np.abs(tus - fx["us"]).max())
    assert np.abs(tus - jus).max() / np.abs(jus).max() < 1e-9
