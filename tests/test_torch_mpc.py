"""PyTorch port vs JAX package: the receding-horizon MPC engine.

Go2 kinodynamics, T=20, a trot scaled to the horizon (2 double-support + 6
diagonal-pair stages, twice), walking at 0.2 m/s, 5 ticks each fed the JAX
plan's next state.  The takeoff/land event queues must match exactly as
integers; xs, us and Ks within 1e-8 relative to max(1, largest entry) (the
initial full solve runs 10 iterations, and roundoff in the 24x24 Riccati
solves compounds over them), f64 CPU.  Then the slice as a whole: 2
closed-loop MPC ticks of 10 inner steps (interpolation, the example's
inverse-dynamics QP, the rigid-contact simulator) on both sides, each fed
back its own simulated state, from the same MPCs (a fixture of its own,
so a fault in the closed loop fails only its own tests).
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 20
TICKS = 5
TOL = 1e-8
CLOSED_TICKS = 2
SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, num_threads=1,
                swing_apex=0.05, T_fly=6, T_contact=2, timestep=0.01,
                init_max_iters=10)
WALK = np.array([0.2, 0, 0, 0, 0, 0])


def _gait(feet):
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    return [ds] * 2 + [pair_a] * 6 + [ds] * 2 + [pair_b] * 6


def _err(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _queues(mpc):
    return ({k: list(v) for k, v in mpc.foot_takeoff_times.items()},
            {k: list(v) for k, v in mpc.foot_land_times.items()})


@pytest.fixture(scope="module")
def engines():
    """The JAX and the port MPC driven through the same plan; returns the
    trace of their ticks and the two MPCs with their model handlers."""
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.mpc import MPC as JMPC
    from simple_mpc_tpu.mpc import MPCSettings as JMPCSettings
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    jocp, jmh, _ = jconfigs.make_go2_kinodynamics(T)
    tocp, tmh, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    # the JAX MPC's two solvers with their scans not unrolled
    # (`scan_unroll=1`, a compile setting that leaves the arithmetic as it
    # is and shortens both compiles)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, s: JSolver(
            ocp, dataclasses.replace(s, scan_unroll=1)))
        jm = JMPC(JMPCSettings(support_force=jmh.mass * 9.81, **SETTINGS), jocp)
    tm = MPC(MPCSettings(support_force=tmh.mass * 9.81, **SETTINGS), tocp)
    out = [dict(j=(jm.xs, jm.us, jm.Ks), t=(tm.xs, tm.us, tm.Ks),
                jq=_queues(jm), tq=_queues(tm))]
    for m in (jm, tm):
        m.generate_cycle_horizon(_gait(jmh.feet_names))
        m.switch_to_walk(WALK)
    queues = [(_queues(jm), _queues(tm))]
    for _ in range(TICKS):
        x = np.asarray(jm.xs[1])
        jr = jm.iterate(x)
        tr = tm.iterate(x)
        out.append(dict(j=(jr.xs, jr.us, jr.Ks), t=(tr.xs, tr.us, tr.Ks),
                        jq=_queues(jm), tq=_queues(tm),
                        div=(bool(jr.diverged), bool(tr.diverged))))
        queues.append((_queues(jm), _queues(tm)))
    foot = dict(j=np.stack([jm.foot_trajectories.get_reference(n) for n in jmh.feet_names]),
                t=np.stack([tm.foot_trajectories.get_reference(n) for n in tmh.feet_names]))
    sd = (np.asarray(jm.get_state_derivative(3)), tm.get_state_derivative(3))
    return (out, foot, sd, queues), (jm, jmh, tm, tmh)


def jax_id_warm(JID, mh, settings, rows):
    """A JAX KinodynamicsID whose constructor's dry run starts from a zero
    QP warm start in place of None (the same iterates: `solve_qp` starts
    from zeros either way), so that XLA compiles its `_solve_core` once, for
    the warm-started structure every later solve takes.  `rows`: the QP's
    constraint rows (`kernels._id_rows` of the port's ID)."""
    import jax.numpy as jnp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JID, "solve", lambda self, t, q, v: None)
        jid = JID(mh, 1e-3, settings)
    x = np.asarray(mh.reference_state)
    jid._qp_warm = (jnp.zeros(jid.nz), jnp.zeros(rows))
    jid.solve(0.0, x[: jid.nq], x[jid.nq:])
    return jid


@pytest.fixture(scope="module")
def trace(engines):
    return engines[0]


@pytest.fixture(scope="module")
def closed_loop(engines):
    """The slice as a whole, after the trace's ticks: CLOSED_TICKS MPC
    ticks of 10 inner steps (interpolation, the example's inverse dynamics,
    the simulator) on each side, each feeding its own simulated state back
    to its own MPC, through the JAX package's `examples/loop.py` and the
    port's `examples/loop.py`.  Returns the per-tick q, v of both runs
    under "j" and "t", and `spread()`: JAX's own run from a copy of its MPC
    and ID with the start state moved by 1e-15 (relative), made on the
    first call."""
    import copy

    from examples.loop import foot_height as jfoot_height
    from examples.loop import run_closed_loop as jloop
    from simple_mpc_tpu.id.kinodynamics_id import IDSettings as JIDSettings
    from simple_mpc_tpu.id.kinodynamics_id import KinodynamicsID as JID
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu_torch.examples.go2_kinodynamics import ID_SETTINGS
    from simple_mpc_tpu_torch.examples.loop import run_closed_loop as tloop
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID

    from simple_mpc_tpu_torch.kernels import _id_rows

    jm, jmh, tm, tmh = engines[1]
    tid = KinodynamicsID(tmh, 1e-3, IDSettings(**ID_SETTINGS), device="cpu")
    jid = jax_id_warm(JID, jmh, JIDSettings(**ID_SETTINGS), _id_rows(tid))
    # the JAX run is repeated from a copy of its MPC that shares the
    # (jitted, stateless) solvers, so nothing compiles twice; the ID's and
    # the simulator's state is put back by hand
    shared = {id(x): x for x in (jm.solver, jm._init_solver)}
    jm2, jmh2 = copy.deepcopy(jm, shared), copy.copy(jmh)
    id_state = (dict(jid._targets), jid._qp_warm)
    plant = JSim(jmh.model, jmh.feet_frame_ids,
                 JSimSettings(dt=1e-3, ground_height=jfoot_height(jmh)))
    rng = np.random.default_rng(17)
    x0 = np.asarray(jmh.reference_state)
    jmh2.reference_state = x0 * (1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=x0.shape))
    runs = dict(j=jloop(jm, jmh, id_solver=jid, n_steps=CLOSED_TICKS, log_every=0,
                        plant=plant),
                t=tloop(tm, tmh, id_solver=tid, n_steps=CLOSED_TICKS, log_every=0))
    runs = {k: (np.stack(r["q"]), np.stack(r["v"])) for k, r in runs.items()}
    moved = []

    def spread():
        if not moved:
            jid._targets, jid._qp_warm = id_state
            r = jloop(jm2, jmh2, id_solver=jid, n_steps=CLOSED_TICKS, log_every=0,
                      plant=plant)
            moved.append((np.stack(r["q"]), np.stack(r["v"])))
        return moved[0]

    return runs, spread


def test_event_queues_match_exactly(trace):
    out, _, _, queues = trace
    for step in out:
        assert step["tq"] == step["jq"]
    for jq, tq in queues:
        assert tq == jq
    # the plan really produced events
    assert any(len(v) for v in queues[-1][1][0].values())


@pytest.mark.parametrize("tick", range(TICKS + 1))
def test_plan_matches_jax(trace, tick):
    out = trace[0]
    step = out[tick]
    for a, b in zip(step["t"], step["j"]):
        assert _err(a, b) < TOL
    if "div" in step:
        assert step["div"] == (False, False)


def test_swing_references_and_state_derivative(trace):
    _, foot, sd, _ = trace
    assert _err(foot["t"], foot["j"]) < 1e-12
    assert _err(sd[1], sd[0]) < TOL


@pytest.mark.parametrize("tick", range(CLOSED_TICKS))
def test_closed_loop_matches_jax(closed_loop, tick):
    """The Go2 kinodynamics closed loop (MPC, interpolation, inverse-dynamics
    QP, simulator) through the port and through the JAX package: q and v
    after each MPC tick within max(1e-8, ten times JAX's own response to a
    1e-15 relative move of the start state), relative to max(1, largest
    entry).  Measured (f64 CPU, ticks 0 / 1): q within 2.5e-15 / 4.1e-15
    of JAX, v within 6.5e-13 / 4.9e-13; JAX's own spread 2.1e-15 / 2.1e-15
    (q) and 2.1e-13 / 2.5e-13 (v), so the bound is 1e-8.  The spread run
    (two more JAX MPC ticks) is made only when the error reaches 1e-8:
    below it the bound holds whatever the spread."""
    runs, spread = closed_loop
    for i in range(2):  # q, v
        err = _err(runs["t"][i][tick], runs["j"][i][tick])
        print(f"tick {tick} {'qv'[i]}: port vs JAX {err:.2e}")
        if err >= TOL:
            sp = _err(spread()[i][tick], runs["j"][i][tick])
            print(f"tick {tick} {'qv'[i]}: JAX spread {sp:.2e}")
            assert err < 10 * sp, (err, sp)
    # the robot stood on the ground and moved under the ID's torques
    assert np.abs(runs["t"][1][tick]).max() > 0


def test_foot_trajectory_functions():
    import jax.numpy as jnp

    from simple_mpc_tpu.mpc import foot_trajectory as jft
    from simple_mpc_tpu_torch.mpc import foot_trajectory as tft

    rng = np.random.default_rng(5)
    p0, p1 = rng.normal(size=3), rng.normal(size=3)
    _close = np.testing.assert_allclose
    _close(tft.bezier_control_points(p0, p1, 0.1).numpy(),
           np.asarray(jft.bezier_control_points(jnp.asarray(p0), jnp.asarray(p1), 0.1)),
           rtol=0, atol=1e-15)
    pts = jft.bezier_control_points(jnp.asarray(p0), jnp.asarray(p1), 0.1)
    for s in (0.0, 0.3, 1.0):
        _close(tft.bezier_eval(torch.as_tensor(np.asarray(pts)), s).numpy(),
               np.asarray(jft.bezier_eval(pts, s)), rtol=0, atol=1e-14)
    for land in (-3, 0, 4, 9, 30):
        _close(tft.sample_swing(p0, p1, 0.1, land, 6, T).numpy(),
               np.asarray(jft.sample_swing(jnp.asarray(p0), jnp.asarray(p1), 0.1,
                                           land, 6, T)), rtol=0, atol=1e-14)
