"""The port's fused MPC tick on Talos kinodynamics (23 joints, two 6D quad
feet) against the JAX package's `FusedMPC.step`, f64 CPU.

The port's engine is `configs.make_talos_fused` at T=6 with the biped gait
of tests/test_torch_talos_solver.py scaled to the horizon (2 double / 4
left / 2 double / 4 right support stages, T_fly 4, T_contact 2, apex 0.1
m, walking at 0.1 m/s), its first solve cut to one iteration.  The JAX
engine takes the port's carry as it is (`carry_to_numpy`): the JAX
package's `FusedMPC` reads its settings, OCP, solver and model handler
from the host engine it is given, and nothing else, so it is given those
alone and the JAX host MPC's own first solve is never compiled.  One XLA
program is built for the module, the jitted tick, over a JAX solver with
the tick's settings and its scans not unrolled (`scan_unroll=1`, a compile
setting that leaves the arithmetic as it is and shortens the compile).

Both engines advance four ticks on the measurement stream of
tests/test_torch_fused_mpc.py (the gait's first swing enters the horizon on
the third).  Tolerances, the rule of
tests/test_torch_fused_jax.py: xs, us and the multipliers within 1e-9
relative to max(1, the largest entry), the event queues exactly as
integers, the swing endpoints and foot references within 1e-12; prim_res
within 1e-9 relative to max(1e-6, its value).

Every test here is marked `slow`: each comparison is one XLA compile of a
whole Talos or full-dynamics tick (2.5–8 minutes on a CPU), and with the
Talos fused tick in it the repository's quick suite ran past its time
limit on six workers.  The port's fused tick is held to its own host MPC
on both models in the quick suite (tests/test_torch_fused_wide.py); the
host MPC on Talos is held to JAX's there (tests/test_torch_talos_solver.py).
The latency tick (`parallel=True`, advanced with `step_donated`) and Go2
full dynamics are compared under test_torch_fused_jax.py's latency tolerance,
max(1e-9, ten times the reference's own spread under a 1e-15 warm-start
perturbation).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from test_torch_fused_mpc import measurements, quad_gait_plan

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 6
TICKS = 4
FLOOR = 1e-9
TALOS = dict(T_fly=4, T_contact=2, init_max_iters=1)
FD = dict(T_fly=4, T_contact=2, swing_apex=0.05, init_max_iters=1)


def talos_gait(feet):
    l, r = feet
    return ([{l: True, r: True}] * 2 + [{l: True, r: False}] * 4
            + [{l: True, r: True}] * 2 + [{l: False, r: True}] * 4)


def _rel(a, b, floor=1.0):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def jax_engine(tfused, tcarry, jocp, jmh):
    """The JAX package's FusedMPC with the port engine's settings and
    solver settings over `jocp`, and the port's carry as a JAX carry."""
    import jax.numpy as jnp

    from simple_mpc_tpu.mpc import MPCSettings as JMPCSettings
    from simple_mpc_tpu.mpc.fused import FusedMPC as JFused
    from simple_mpc_tpu.mpc.fused import MPCCarry as JCarry
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.convert import carry_to_numpy

    ts = tfused.solver.settings
    jsolver = JSolver(jocp, JSettings(tol=ts.tol, mu_init=ts.mu_init, max_iters=1,
                                      parallel=ts.parallel, scan_unroll=1))
    host = types.SimpleNamespace(
        cycle_horizon=(), ocp_handler=jocp, solver=jsolver, model_handler=jmh,
        settings=JMPCSettings(**dataclasses.asdict(tfused.settings)))
    jfused = JFused(host)
    sp_t, tp_t = type(jocp.problem.stage_params), type(jocp.problem.term_params)
    leaves = {}
    for f, v in carry_to_numpy(tcarry).items():
        if isinstance(v, dict):
            cls = tp_t if f == "term_params" else sp_t
            leaves[f] = cls(**{k: jnp.asarray(a) for k, a in v.items()})
        else:
            leaves[f] = jnp.asarray(v)
    return jfused, JCarry(**leaves)


def run_pair(tfused, tcarry, jocp, jmh, donated=False):
    """TICKS ticks of the port engine (`step`, or `step_donated`) and of the
    JAX engine on the same measurements, beside a JAX run whose warm start
    xs is moved by 1e-15 (relative)."""
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.ocp.base import tree_map

    jfused, jcarry = jax_engine(tfused, tcarry, jocp, jmh)
    xs0 = np.asarray(jcarry.xs)
    noise = 1e-15 * np.random.default_rng(5).standard_normal(xs0.shape)
    jcarry_n = jcarry._replace(xs=jnp.asarray(xs0 * (1 + noise)))
    xs_meas = measurements(jmh, TICKS)
    out = []
    for i in range(TICKS):
        x = xs_meas[i]
        jcarry, jres = jfused.step(jcarry, jnp.asarray(x))
        jcarry_n, jres_n = jfused.step(jcarry_n, jnp.asarray(x))
        step = tfused.step_donated if donated else tfused.step
        tcarry, tres = step(tcarry, torch.as_tensor(x))
        out.append((jcarry, jres, tree_map(torch.clone, tcarry), tres, jres_n))
    return out


def check_tick(pair, tick, spread_rule):
    from simple_mpc_tpu_torch.kernels import EMPTY

    jcarry, jres, tcarry, tres, jres_n = pair[tick]
    for f in ("xs", "us", "lam_eq", "lam_in"):
        ref = np.asarray(getattr(jres, f))
        tol = max(FLOOR, 10 * _rel(np.asarray(getattr(jres_n, f)), ref)) if spread_rule \
            else FLOOR
        assert _rel(getattr(tres, f), ref) <= tol, (f, _rel(getattr(tres, f), ref), tol)
    prim = float(np.asarray(jres.prim_res))
    assert abs(float(tres.prim_res) - prim) <= FLOOR * max(1e-6, prim), (
        float(tres.prim_res), prim)
    for q in ("takeoff", "land"):
        np.testing.assert_array_equal(getattr(tcarry, q).numpy(), np.asarray(getattr(jcarry, q)))
    assert (np.asarray(jcarry.land) < EMPTY // 2).any()
    for f in ("p_init", "p_final"):
        assert _rel(getattr(tcarry, f), getattr(jcarry, f), 0.0) <= 1e-12
    assert _rel(tcarry.stage_params.foot_ref_p, jcarry.stage_params.foot_ref_p, 0.0) <= 1e-12


def talos_engines(parallel):
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu_torch.configs import TALOS_FEET, make_talos_fused

    from examples.talos_kinodynamics import talos_kinodynamics_config as jconfig

    tfused, tcarry = make_talos_fused(T, device="cpu", dtype=torch.float64, parallel=parallel,
                                      gait=talos_gait(TALOS_FEET), **TALOS)
    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 6, -9.81, False)
    return tfused, tcarry, jocp, jmh


@pytest.fixture(scope="module")
def talos_pair():
    return run_pair(*talos_engines(parallel=False))


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_talos_fused_step_matches_jax(talos_pair, tick):
    check_tick(talos_pair, tick, spread_rule=False)


@pytest.mark.slow
def test_talos_stream_exercises_swings_and_events(talos_pair):
    """The compared ticks are not trivial: the measured state moves the
    swing endpoints and a foot is lifted on some stage."""
    _, _, tcarry, _, _ = talos_pair[-1]
    assert (tcarry.stage_params.contact_active == 0).any()
    assert _rel(talos_pair[0][2].p_final, talos_pair[-1][2].p_final, 0.0) > 0.0


@pytest.fixture(scope="module")
def talos_latency_pair():
    return run_pair(*talos_engines(parallel=True), donated=True)


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_talos_latency_tick_matches_jax(talos_latency_pair, tick):
    check_tick(talos_latency_pair, tick, spread_rule=True)


@pytest.fixture(scope="module")
def fd_pair():
    from simple_mpc_tpu.configs import go2_fulldynamics_config as jconfig
    from simple_mpc_tpu.configs import go2_handler as jhandler
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu_torch.configs import make_go2_fd_fused

    tfused, tcarry = make_go2_fd_fused(T, device="cpu", dtype=torch.float64,
                                       gait=quad_gait_plan(), **FD)
    jmh = jhandler()
    jcfg = jconfig(jmh)
    jcfg["force_cone"] = False
    jocp = JOCP(jcfg, jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 3, -9.81, False)
    return run_pair(tfused, tcarry, jocp, jmh)


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_fd_fused_step_matches_jax(fd_pair, tick):
    check_tick(fd_pair, tick, spread_rule=True)


@pytest.mark.slow
def test_talos_f32_stream_after_the_first_swing_as_in_jax():
    """The f32 Talos tick after the gait's first single-support stage enters
    the horizon (tick 21 of the T=100 biped gait), in the JAX package: the
    engine of `chip_smoke.talos_fused_engine` (the example's settings, first
    solve cut to 20 iterations) made on the CPU in f32, its carry handed to
    JAX's `FusedMPC` in f32 and, cast up, in f64, each self-fed for 40
    ticks (`self_rollout`).  On the card the port's f32 ticks climb from
    1.15e-3 at tick 21 to 7.2e-3 at tick 40 while its f64 ticks fall back
    below 1e-4 (chip_smoke.py `talos_latency`'s long rollout): JAX's own
    f32 tick must climb as well (its prim at tick 40 more than ten times its
    f64 one) for the climb to be the f32 algorithm's and not the port's.
    Measured: JAX f32 1.150e-3 at tick 21, 7.19e-3 at tick 40; JAX f64
    1.054e-3 at tick 21, 6.1e-5 at tick 40.  `slow`: two XLA compiles of
    the T=100 Talos tick (13 min on a CPU).  The readings are printed."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu_torch.configs import make_talos_fused

    from examples.talos_kinodynamics import talos_kinodynamics_config as jconfig

    n = 40
    tfused, tcarry = make_talos_fused(100, device="cpu", dtype=torch.float32,
                                      init_max_iters=20)
    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), 100, 6, -9.81, False)
    prims = {}
    for dtype in (jnp.float32, jnp.float64):
        jfused, jcarry = jax_engine(tfused, tcarry, jocp, jmh)
        jcarry = jax.tree_util.tree_map(
            lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, jcarry)
        _, (_, _, p) = jfused.self_rollout(jcarry, n)
        prims[jnp.dtype(dtype).name] = np.asarray(p, np.float64)
    print("JAX self-fed prim_res, f32:", prims["float32"].tolist())
    print("JAX self-fed prim_res, f64:", prims["float64"].tolist())
    assert prims["float32"].dtype == np.float64 and np.isfinite(prims["float32"]).all()
    assert prims["float32"][-1] > 10 * prims["float64"][-1], prims

