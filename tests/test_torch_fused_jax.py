"""The port's fused MPC tick against the JAX package's `FusedMPC.step`.

One JAX engine (Go2 kinodynamics T=12, the quadruped gait and settings of
tests/test_fused_mpc.py, f64 CPU) is built once for the module; its carry
is handed to the port with `convert.carry_from_numpy`, and both engines
advance two ticks on the same measurements.  xs and us to 1e-9 relative to
max(1, the largest entry) (the two solvers sum the same float64 products
in other orders; forces are ~35 N), the event queues exactly as integers,
the swing endpoints and foot references to 1e-12.

This is the only test file that builds a JAX engine: its set-up (the JAX
host MPC's first solve and the compile of the fused step) takes minutes on
the CPU, so every other fused test compares the port with itself or with
the JAX package's eager functions.
"""
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
    from simple_mpc_tpu_torch.convert import carry_from_numpy

    jocp, jmh, _ = make_go2_kinodynamics(T)
    jmpc = MPC(MPCSettings(support_force=jmh.mass * 9.81, TOL=1e-6, mu_init=1e-8,
                           max_iters=1, swing_apex=0.05, T_fly=4, T_contact=2, T=T,
                           timestep=0.01, init_max_iters=10), jocp)
    jmpc.generate_cycle_horizon(quad_gait_plan())
    jmpc.switch_to_walk(np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.05]))
    jfused = JFused(jmpc)
    jcarry = jfused.make_carry(jmpc)

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


def _err(a, b):
    return float(np.abs(a.detach().numpy() - np.asarray(b)).max())


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
