"""The port's B=1 latency path against the JAX package: the fused tick with
the associative-scan Riccati (`SolverSettings(parallel=True)`, K6),
advanced with `FusedMPC.step_donated`.

One JAX engine (Go2 kinodynamics T=12, the quadruped gait and settings of
tests/test_torch_fused_jax.py, its solver swapped for a `parallel=True`
one as bench.py `_make_fused` does, f64 CPU) is built once for the module;
its carry is handed to the port with `convert.carry_from_numpy`, and both
engines advance two ticks on the same measurements, the port through
`step_donated`, JAX through `step`.  The event queues must agree exactly as
integers.  xs and us must agree to 1e-9 relative to max(1, the largest
entry), or to ten times the reference's own spread where that is larger:
a second JAX engine state, whose warm start xs is multiplied by
(1 + 1e-15 noise), advances beside the first.  At this configuration's AL
penalty (mu = 1.5e-8) the unscaled Quu + reg I of K6 makes the gains
sensitive to roundoff, and the reference moves by us 1.1e-9 / 4.2e-9 and
xs 2.5e-10 / 1.2e-9 (ticks 0 / 1) under that noise; the port differs from
it by us 3.1e-9 / 3.0e-9 and xs at most 1.1e-9 (f64 CPU).  The serial
tick (test_torch_fused_jax.py) holds 1e-9 outright.

This is the only test file that builds a JAX engine with the parallel
solver: its set-up (the JAX host MPC's first solve and the compile of the
fused step) takes minutes on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_fused_mpc import T, make_engine, measurements, quad_gait_plan

TICKS = 2


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp

    from simple_mpc_tpu.configs import make_go2_kinodynamics
    from simple_mpc_tpu.mpc import MPC, MPCSettings
    from simple_mpc_tpu.mpc.fused import FusedMPC as JFused
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.convert import carry_from_numpy
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver

    jocp, jmh, _ = make_go2_kinodynamics(T)
    jmpc = MPC(MPCSettings(support_force=jmh.mass * 9.81, TOL=1e-6, mu_init=1e-8,
                           max_iters=1, swing_apex=0.05, T_fly=4, T_contact=2, T=T,
                           timestep=0.01, init_max_iters=10), jocp)
    jmpc.solver = JSolver(jocp, JSettings(tol=1e-6, mu_init=1e-8, max_iters=1,
                                          parallel=True))
    jmpc.generate_cycle_horizon(quad_gait_plan())
    jmpc.switch_to_walk(np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.05]))
    jfused = JFused(jmpc)
    jcarry = jfused.make_carry(jmpc)

    # the port's engine supplies the solver and settings; its state is
    # replaced by the JAX carry
    _, tfused, _, mh = make_engine(init_max_iters=1)
    tfused.solver = ProxDDPSolver(tfused.ocp, dataclasses.replace(
        tfused.solver.settings, parallel=True))
    tcarry = carry_from_numpy(tfused.ocp, jcarry, "cpu")
    xs_meas = measurements(mh, TICKS)
    xs0 = np.asarray(jcarry.xs)
    noise = 1e-15 * np.random.default_rng(5).standard_normal(xs0.shape)
    jcarry_n = jcarry._replace(xs=jnp.asarray(xs0 * (1 + noise)))
    out = []
    for i in range(TICKS):
        jcarry, jres = jfused.step(jcarry, jnp.asarray(xs_meas[i]))
        jcarry_n, jres_n = jfused.step(jcarry_n, jnp.asarray(xs_meas[i]))
        tcarry, tres = tfused.step_donated(tcarry, torch.as_tensor(xs_meas[i]))
        # the next donated tick overwrites tcarry: keep a copy of this one
        out.append((jcarry, jres, tree_map(torch.clone, tcarry), tres, jres_n))
    return out


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("tick", range(TICKS))
@pytest.mark.parametrize("field", ["xs", "us"])
def test_latency_tick_matches_jax(pair, tick, field):
    _, jres, _, tres, jres_n = pair[tick]
    spread = _rel(getattr(jres_n, field), getattr(jres, field))
    assert _rel(getattr(tres, field), getattr(jres, field)) <= max(1e-9, 10 * spread)


@pytest.mark.parametrize("tick", range(TICKS))
def test_latency_tick_queues_equal_jax(pair, tick):
    from simple_mpc_tpu_torch.kernels import EMPTY

    jcarry, _, tcarry, _, _ = pair[tick]
    for q in ("takeoff", "land"):
        np.testing.assert_array_equal(getattr(tcarry, q).numpy(),
                                      np.asarray(getattr(jcarry, q)))
    assert (np.asarray(jcarry.land) < EMPTY // 2).any()
