"""PyTorch port vs JAX package: the Talos centroidal closed loop, f64 CPU.

Two MPC ticks of 10 inner steps (the tick's two state derivatives of the
9-dim ODE and 6D reference wrenches, the centroidal state interpolated
linearly, CentroidalID tracking the CoM and the feet through the example's
adapter, the rigid-contact simulator at the two soles) through the port's
`examples/talos_centroidal.py` and `examples/loop.py`, and through the JAX
package's `examples/loop.py` on the objects of its `examples/talos_centroidal.py`
(its adapter, defined inside its `main`, restated here), each fed back its
own simulated state.  The example's weights, IDSettings, gait and
MPCSettings at T=12, the MPC's first solve cut to one iteration on both
sides (`init_max_iters=1`); the JAX MPC runs over one solver wrapper with
`scan_unroll=1`, as in tests/test_torch_talos_loop.py.

Tolerance (the rule of tests/test_torch_talos_loop.py): q and v after each
tick within max(1e-8, ten times JAX's own response to a 1e-15 relative move
of the start state), relative to max(1, largest entry).  `slow`: the JAX
CentroidalID's solve, the simulator and the solver compile for minutes.
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 12
TICKS = 2
FLOOR = 1e-8


def _err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


class _OneCompile:
    """The JAX solver with one call signature (tests/test_torch_talos_loop.py)."""

    def __init__(self, solver):
        self.solver = solver
        self.settings = solver.settings

    def run(self, problem, xs, us, lams=None, mu=None):
        import jax.numpy as jnp

        ocp = self.solver.ocp
        if lams is None:
            lams = (jnp.zeros((T, 0)), jnp.zeros((T, ocp.n_in)), jnp.zeros((0,)))
        if mu is None:
            mu = self.settings.mu_init
        return self.solver.run(problem, xs, us, lams, jnp.asarray(mu, jnp.float64))


class _JaxAdapter:
    """The JAX example's `_Adapter` (examples/talos_centroidal.py:44-60)."""

    def __init__(self, cid, mpc, mh):
        self.cid, self.mpc, self.mh = cid, mpc, mh

    def set_target(self, x_i, _v, a_t, contacts, f_t):
        feet_pose, feet_vel = [], []
        for name in self.mh.feet_names:
            p = np.asarray(self.mpc.ocp_handler.get_reference_pose(0, name)[1])
            feet_pose.append((np.eye(3), p))
            feet_vel.append(np.zeros(6))
        self.cid.set_target(x_i[:3], x_i[3:6] / self.mh.mass, feet_pose, feet_vel,
                            contacts, f_t)

    def solve(self, t, q, v):
        return self.cid.solve(t, q, v)


@pytest.fixture(scope="module")
def closed_loop():
    from examples.loop import foot_height as jfoot_height
    from examples.loop import run_closed_loop as jloop
    from simple_mpc_tpu.configs import talos_centroidal_config as jconfig
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.id.centroidal_id import CentroidalID as JCID
    from simple_mpc_tpu.id.kinodynamics_id import IDSettings as JIDSettings
    from simple_mpc_tpu.models.handler import RobotDataHandler as JDH
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.ocp.centroidal import CentroidalOCP as JOCP
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.examples import talos_centroidal as ex
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import WALK, biped

    settings = {**ex.MPC_SETTINGS, "init_max_iters": 1}
    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(JDH(jmh).get_centroidal_state()), T, 6, -9.81, False)
    shared = _OneCompile(JSolver(jocp, JSettings(tol=settings["TOL"],
                                                 mu_init=settings["mu_init"], max_iters=1,
                                                 scan_unroll=1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, s: shared)
        jm = jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                     **settings), jocp)
    jcid = JCID(jmh, 1e-3, JIDSettings(**ex.ID_SETTINGS))
    plant = JSim(jmh.model, jmh.feet_frame_ids,
                 JSimSettings(dt=1e-3, ground_height=jfoot_height(jmh)))
    jm2, jmh2 = copy.deepcopy(jm, {id(shared): shared}), copy.copy(jmh)
    id_state = (dict(jcid._targets), jcid._qp_warm)
    rng = np.random.default_rng(29)
    x0 = np.asarray(jmh.reference_state)
    jmh2.reference_state = x0 * (1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=x0.shape))
    gait = biped(jmh.feet_names)

    def jax_run(mpc, mh):
        r = jloop(mpc, mh, id_solver=_JaxAdapter(jcid, mpc, mh), n_steps=TICKS, log_every=0,
                  plant=plant, walk_velocity=WALK, gait=gait)
        return np.stack(r["q"]), np.stack(r["v"])

    tm, tmh, tid = ex.setup(T, device="cpu", dtype=torch.float64, init_max_iters=1)
    r = ex.run(tm, tmh, tid, n_steps=TICKS, log_every=0, gait=gait)
    runs = dict(j=jax_run(jm, jmh), t=(np.stack(r["q"]), np.stack(r["v"])))
    moved = []

    def spread():
        if not moved:
            jcid._targets, jcid._qp_warm = id_state
            moved.append(jax_run(jm2, jmh2))
        return moved[0]

    return runs, spread


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_talos_centroidal_closed_loop_matches_jax(closed_loop, tick):
    runs, spread = closed_loop
    for i in range(2):  # q, v
        err = _err(runs["t"][i][tick], runs["j"][i][tick])
        print(f"tick {tick} {'qv'[i]}: port vs JAX {err:.2e}")
        if err >= FLOOR:
            sp = _err(spread()[i][tick], runs["j"][i][tick])
            print(f"tick {tick} {'qv'[i]}: JAX spread {sp:.2e}")
            assert err < 10 * sp, (err, sp)
    assert np.abs(runs["t"][1][tick]).max() > 0
    assert abs(runs["t"][0][tick][2] - runs["t"][0][0][2]) < 0.1
