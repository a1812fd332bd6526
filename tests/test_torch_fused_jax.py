"""The port's fused MPC tick against the JAX package's `FusedMPC.step`,
serial (K3) and on the B=1 latency path (K6).

One JAX host MPC (Go2 kinodynamics T=12, the quadruped gait and settings of
tests/test_fused_mpc.py, f64 CPU) is built once for the module: its first
solve and the compile of each fused step take minutes on the CPU, so this
file holds both JAX engines over that one MPC (the latency engine with its
solver swapped for a `parallel=True` one, as bench.py `_make_fused` does;
`FusedMPC` keeps the solver the MPC held when it was built).  Each engine's
carry is handed to the port with `convert.carry_from_numpy`, and both sides
advance two ticks on the same measurements.

* The serial tick: xs and us to 1e-9 relative to max(1, the largest entry)
  (the two solvers sum the same float64 products in other orders; forces
  are ~35 N), the event queues exactly as integers, the swing endpoints
  and foot references to 1e-12.
* The latency tick (the port through `FusedMPC.step_donated`, JAX through
  `step`): the event queues exactly; xs and us to 1e-9 relative to max(1,
  the largest entry), or to ten times the reference's own spread where
  that is larger: a second JAX engine state, whose warm start xs is
  multiplied by (1 + 1e-15 noise), advances beside the first.  At this
  configuration's AL penalty (mu = 1.5e-8) the unscaled Quu + reg I of K6
  makes the gains sensitive to roundoff, and the reference moves by us
  1.1e-9 / 4.2e-9 and xs 2.5e-10 / 1.2e-9 (ticks 0 / 1) under that noise;
  the port differs from it by us 3.1e-9 / 3.0e-9 and xs at most 1.1e-9
  (f64 CPU).

This is the only tier-1 file that builds a JAX fused engine; every other
fused test compares the port with itself or with the JAX package's eager
functions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_fused_mpc import T, make_engine, measurements, quad_gait_plan

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TICKS = 2


@pytest.fixture(scope="module")
def engines():
    """The JAX host MPC, built and first solved once, with its serial
    `FusedMPC` and a `parallel=True` one, and each one's carry."""
    from simple_mpc_tpu.configs import make_go2_kinodynamics
    from simple_mpc_tpu.mpc import MPC, MPCSettings
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.mpc.fused import FusedMPC as JFused
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings

    jocp, jmh, _ = make_go2_kinodynamics(T)
    # the JAX solvers with their scans not unrolled (`scan_unroll=1`, a
    # compile setting that leaves the arithmetic as it is and shortens the
    # compiles of the first solve and of the tick)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, s: JSolver(
            ocp, dataclasses.replace(s, scan_unroll=1)))
        jmpc = MPC(MPCSettings(support_force=jmh.mass * 9.81, TOL=1e-6, mu_init=1e-8,
                               max_iters=1, swing_apex=0.05, T_fly=4, T_contact=2, T=T,
                               timestep=0.01, init_max_iters=10), jocp)
    jmpc.generate_cycle_horizon(quad_gait_plan())
    jmpc.switch_to_walk(np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.05]))
    serial = JFused(jmpc)
    jmpc.solver = JSolver(jocp, JSettings(tol=1e-6, mu_init=1e-8, max_iters=1,
                                          parallel=True, scan_unroll=1))
    latency = JFused(jmpc)
    return (serial, serial.make_carry(jmpc)), (latency, latency.make_carry(jmpc))


@pytest.fixture(scope="module")
def pair(engines):
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.convert import carry_from_numpy

    jfused, jcarry = engines[0]
    # the port's engine supplies the solver and settings; its state is
    # replaced by the JAX carry
    _, tfused, _, mh = make_engine(init_max_iters=1)
    tcarry = carry_from_numpy(tfused.ocp, jcarry, "cpu")
    xs_meas = measurements(mh, TICKS)
    out = []
    for i in range(TICKS):
        jcarry, jres = jfused.step(jcarry, jnp.asarray(xs_meas[i]))
        tcarry, tres = tfused.step(tcarry, torch.as_tensor(xs_meas[i]))
        out.append((jcarry, jres, tcarry, tres))
    return out


@pytest.fixture(scope="module")
def latency_pair(engines):
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.convert import carry_from_numpy
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver

    jfused, jcarry = engines[1]
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


def _err(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def _rel(a, b):
    return _err(a, b) / max(float(np.abs(np.asarray(b)).max()), 1.0)


@pytest.mark.parametrize("tick", range(TICKS))
def test_fused_step_matches_jax(pair, tick):
    from simple_mpc_tpu_torch.kernels import EMPTY

    jcarry, jres, tcarry, tres = pair[tick]
    assert _rel(tres.xs, jres.xs) <= 1e-9
    assert _rel(tres.us, jres.us) <= 1e-9
    for q in ("takeoff", "land"):
        np.testing.assert_array_equal(getattr(tcarry, q).numpy(),
                                      np.asarray(getattr(jcarry, q)))
    assert (np.asarray(jcarry.land) < EMPTY // 2).any()
    assert _err(tcarry.p_init, jcarry.p_init) <= 1e-12
    assert _err(tcarry.p_final, jcarry.p_final) <= 1e-12
    assert _err(tcarry.stage_params.foot_ref_p, jcarry.stage_params.foot_ref_p) <= 1e-12


@pytest.mark.parametrize("tick", range(TICKS))
@pytest.mark.parametrize("field", ["xs", "us"])
def test_latency_tick_matches_jax(latency_pair, tick, field):
    _, jres, _, tres, jres_n = latency_pair[tick]
    spread = _rel(getattr(jres_n, field), getattr(jres, field))
    assert _rel(getattr(tres, field), getattr(jres, field)) <= max(1e-9, 10 * spread)


@pytest.mark.parametrize("tick", range(TICKS))
def test_latency_tick_queues_equal_jax(latency_pair, tick):
    from simple_mpc_tpu_torch.kernels import EMPTY

    jcarry, _, tcarry, _, _ = latency_pair[tick]
    for q in ("takeoff", "land"):
        np.testing.assert_array_equal(getattr(tcarry, q).numpy(),
                                      np.asarray(getattr(jcarry, q)))
    assert (np.asarray(jcarry.land) < EMPTY // 2).any()
