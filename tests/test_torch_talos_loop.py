"""PyTorch port vs JAX package: the Talos kinodynamics closed loop (23
joints, two 6D quad feet), f64 CPU.

Two MPC ticks of 10 inner steps (the tick's two state derivatives and
6D reference wrenches, the interpolated targets, the example's
inverse-dynamics QP with the wrench cones, the rigid-contact simulator at
the two soles) through the port's `examples/talos_kinodynamics.py` and
`examples/loop.py`, and through the JAX package's `examples/loop.py` on
the JAX example's objects, each fed back its own simulated state.  The
example's weights, IDSettings and MPC settings at T=6, with its biped gait
scaled to the horizon (2 double / 4 left / 2 double / 4 right support
stages, T_fly 4, T_contact 2) and the MPC's initial solve cut to one
iteration on both sides (`init_max_iters=1`).  The JAX MPC runs over one
solver wrapper with `scan_unroll=1`, as in tests/test_torch_talos_solver.py,
so XLA compiles the Talos iteration once.

Tolerance (the rule of tests/test_torch_mpc.py::test_closed_loop_matches_jax):
q and v after each tick, the simulator's world contact forces at each
tick's last step, and the two MPCs' plans (xs, us, Ks) after the run
within max(1e-8, ten times JAX's own response to a 1e-15 relative move of
the start state), relative to max(1, largest entry); the spread run is
made only when an error reaches 1e-8.
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 6
TICKS = 2
FLOOR = 1e-8
PLAN = ("xs", "us", "Ks")
MPC_OVERRIDES = dict(T_fly=4, T_contact=2, init_max_iters=1)


def _err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _gait(feet):
    l, r = feet
    return ([{l: True, r: True}] * 2 + [{l: True, r: False}] * 4
            + [{l: True, r: True}] * 2 + [{l: False, r: True}] * 4)


class _OneCompile:
    """The JAX solver with one call signature: run(problem, xs, us, lams,
    mu) with multipliers and penalty always given."""

    def __init__(self, solver):
        self.solver = solver
        self.settings = solver.settings

    def run(self, problem, xs, us, lams=None, mu=None):
        import jax.numpy as jnp

        ocp = self.solver.ocp
        if lams is None:
            lams = (jnp.zeros((T, ocp.n_eq)), jnp.zeros((T, ocp.n_in)),
                    jnp.zeros((ocp.n_term_eq,)))
        if mu is None:
            mu = self.settings.mu_init
        return self.solver.run(problem, xs, us, lams, jnp.asarray(mu, jnp.float64))


@pytest.fixture(scope="module")
def closed_loop():
    """The per-tick q, v of both runs under "j" and "t", and `spread()`:
    JAX's own run from a copy of its MPC and ID with the start state moved
    by 1e-15 (relative), made on the first call."""
    from examples.loop import foot_height as jfoot_height
    from examples.loop import run_closed_loop as jloop
    from examples.talos_kinodynamics import talos_kinodynamics_config as jconfig
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.id.kinodynamics_id import IDSettings as JIDSettings
    from simple_mpc_tpu.id.kinodynamics_id import KinodynamicsID as JID
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.examples import talos_kinodynamics as ex
    from simple_mpc_tpu_torch.kernels import _id_rows
    from test_torch_mpc import jax_id_warm

    settings = {**ex.MPC_SETTINGS, **MPC_OVERRIDES}
    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 6, -9.81, False)
    shared = _OneCompile(JSolver(jocp, JSettings(tol=settings["TOL"],
                                                 mu_init=settings["mu_init"], max_iters=1,
                                                 scan_unroll=1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, settings: shared)
        jm = jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                     **settings), jocp)
    tm, tmh, tid = ex.setup(T, device="cpu", dtype=torch.float64, **MPC_OVERRIDES)
    jid = jax_id_warm(JID, jmh, JIDSettings(**ex.ID_SETTINGS), _id_rows(tid))
    plant = JSim(jmh.model, jmh.feet_frame_ids,
                 JSimSettings(dt=1e-3, ground_height=jfoot_height(jmh)))
    jm2, jmh2 = copy.deepcopy(jm, {id(shared): shared}), copy.copy(jmh)
    id_state = (dict(jid._targets), jid._qp_warm)
    rng = np.random.default_rng(29)
    x0 = np.asarray(jmh.reference_state)
    jmh2.reference_state = x0 * (1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=x0.shape))
    gait = _gait(jmh.feet_names)

    def jax_run(mpc, mh):
        r = jloop(mpc, mh, id_solver=jid, n_steps=TICKS, log_every=0, plant=plant,
                  walk_velocity=ex.WALK, gait=gait)
        return (np.stack(r["q"]), np.stack(r["v"]), np.stack(r["f"]),
                {k: np.asarray(getattr(mpc, k)) for k in PLAN})

    r = ex.run(tm, tmh, tid, n_steps=TICKS, log_every=0, gait=gait)
    runs = dict(j=jax_run(jm, jmh), t=(np.stack(r["q"]), np.stack(r["v"]), np.stack(r["f"]),
                                        {k: getattr(tm, k).numpy() for k in PLAN}))
    moved = []

    def spread():
        if not moved:
            jid._targets, jid._qp_warm = id_state
            moved.append(jax_run(jm2, jmh2))
        return moved[0]

    return runs, spread


@pytest.mark.parametrize("tick", range(TICKS))
def test_talos_closed_loop_matches_jax(closed_loop, tick):
    runs, spread = closed_loop
    for i in range(2):  # q, v
        err = _err(runs["t"][i][tick], runs["j"][i][tick])
        print(f"tick {tick} {'qv'[i]}: port vs JAX {err:.2e}")
        if err >= FLOOR:
            sp = _err(spread()[i][tick], runs["j"][i][tick])
            print(f"tick {tick} {'qv'[i]}: JAX spread {sp:.2e}")
            assert err < 10 * sp, (err, sp)
    # the robot stood on its soles and moved under the ID's torques
    assert np.abs(runs["t"][1][tick]).max() > 0
    assert abs(runs["t"][0][tick][2] - runs["t"][0][0][2]) < 0.1


def _within(closed_loop, get, what):
    """The port's `get(run)` within FLOOR of JAX's, or within ten times
    JAX's own response to the moved start."""
    runs, spread = closed_loop
    err = _err(get(runs["t"]), get(runs["j"]))
    print(f"{what}: port vs JAX {err:.2e}")
    if err >= FLOOR:
        sp = _err(get(spread()), get(runs["j"]))
        print(f"{what}: JAX spread {sp:.2e}")
        assert err < 10 * sp, (err, sp)


@pytest.mark.parametrize("tick", range(TICKS))
def test_talos_closed_loop_forces_match_jax(closed_loop, tick):
    """The simulator's world contact forces at each tick's last inner step."""
    _within(closed_loop, lambda run: run[2][tick], f"tick {tick} f")
    assert closed_loop[0]["t"][2][tick][:, 2].sum() > 0  # the soles bear the robot


@pytest.mark.parametrize("field", PLAN)
def test_talos_closed_loop_plans_match_jax(closed_loop, field):
    """The two MPCs' plans after the run: the MPC stays in step through the
    loop, not only the robot it drives."""
    _within(closed_loop, lambda run: run[3][field], field)
