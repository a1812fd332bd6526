"""PyTorch port vs JAX package: the Go2 closed loop over a long walk.

The port's `examples/go2_kinodynamics.py` (T=50, the trot at 0.2 m/s, the
example's inverse-dynamics QP, the rigid-contact simulator, 10 inner steps
a tick) and the JAX package's `examples/go2_kinodynamics.py` set-up through
its `examples/loop.py`, both for 160 MPC ticks, f64 on the CPU, each fed
back its own simulated state.  Tick by tick it compares the base height,
the progress along x and the stance feet's slip between ticks; where the
two walks part, the failure names the first tick.

Marked `slow`: the port's 160 ticks run its plain twins on the CPU, and
JAX's run another 160 ticks after its XLA compiles (about an hour in all
on a CPU shared with other work).  Measured: base z within 5.0e-12 m,
progress within 1.5e-11 m, slip within 3.3e-12 m at every tick, both
walks progressing 0.05205 m.
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TICKS = 160  # tests/test_walking.py:181
T = 50
FLOOR = 1e-8  # metres: what the two walks may differ by whatever the spread


def _walk(q, mh):
    """(base z, progress along x, stance slip) a tick from the (ticks, nq)
    base trajectory: the slip of tick i is the largest xy move of a foot
    within 5 mm of the ground at ticks i-1 and i (0 where there is none);
    the ground is the feet's mean height at tick 0."""
    from simple_mpc_tpu_torch.ops import soa

    oR, op = soa.fk_world(mh.model, torch.as_tensor(q.T))
    fp = soa.frame_placements_world(mh.model, oR, op, np.asarray(mh.feet_frame_ids))[1]
    fp = fp.permute(2, 0, 1).numpy()  # (ticks, nk, 3)
    ground = fp[0, :, 2].mean()
    slip = np.zeros(len(q))
    for i in range(1, len(q)):
        on = (fp[i - 1, :, 2] < ground + 0.005) & (fp[i, :, 2] < ground + 0.005)
        if on.any():
            slip[i] = np.linalg.norm(fp[i, :, :2] - fp[i - 1, :, :2], axis=1)[on].max()
    return dict(base_z=q[:, 2], progress=q[:, 0] - q[0, 0], slip=slip)


@pytest.fixture(scope="module")
def walks():
    """Both walks' metrics under "j" and "t", and `spread()`: JAX's own walk
    from a copy of its MPC and ID with the start state moved by 1e-15
    (relative), made on the first call."""
    from examples.loop import foot_height as jfoot_height
    from examples.loop import run_closed_loop as jloop
    from simple_mpc_tpu import IDSettings as JIDSettings
    from simple_mpc_tpu import KinodynamicsID as JID
    from simple_mpc_tpu import KinodynamicsOCP as JOCP
    from simple_mpc_tpu import MPC as JMPC
    from simple_mpc_tpu import MPCSettings as JMPCSettings
    from simple_mpc_tpu.configs import go2_handler as jgo2_handler
    from simple_mpc_tpu.configs import go2_kinodynamics_config as jgo2_config
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu_torch.examples import go2_kinodynamics as ex

    # JAX: examples/go2_kinodynamics.py main() without its file output
    jmh = jgo2_handler()
    jocp = JOCP(jgo2_config(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 3, -9.81, False)
    jm = JMPC(JMPCSettings(support_force=jmh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                           max_iters=1, num_threads=1, swing_apex=0.05, T_fly=30,
                           T_contact=10, timestep=0.01), jocp)
    jid = JID(jmh, 1e-3, JIDSettings(**ex.ID_SETTINGS))
    plant = JSim(jmh.model, jmh.feet_frame_ids,
                 JSimSettings(dt=1e-3, ground_height=jfoot_height(jmh)))
    shared = {id(x): x for x in (jm.solver, jm._init_solver)}
    jm2, jmh2 = copy.deepcopy(jm, shared), copy.copy(jmh)
    id_state = (dict(jid._targets), jid._qp_warm)
    rng = np.random.default_rng(23)
    x0 = np.asarray(jmh.reference_state)
    jmh2.reference_state = x0 * (1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=x0.shape))
    gait = ex.trot(jmh.feet_names)

    def jax_walk(mpc, mh):
        r = jloop(mpc, mh, id_solver=jid, n_steps=TICKS, log_every=0, plant=plant,
                  walk_velocity=ex.WALK, gait=gait)
        return _walk(np.stack(r["q"]), mh)

    tmpc, tmh, tid = ex.setup(T, device="cpu", dtype=torch.float64)
    runs = dict(j=jax_walk(jm, jmh),
                t=_walk(np.stack(ex.run(tmpc, tmh, tid, n_steps=TICKS, log_every=0)["q"]),
                        tmh))
    moved = []

    def spread():
        if not moved:
            jid._targets, jid._qp_warm = id_state
            moved.append(jax_walk(jm2, jmh2))
        return moved[0]

    return runs, spread


@pytest.mark.slow
def test_long_closed_loop_matches_jax(walks):
    """Base z, progress and stance slip of the port's walk within
    max(FLOOR, ten times JAX's own response to a 1e-15 relative move of the
    start state) of JAX's, tick by tick; the spread walk is made only when
    the difference reaches FLOOR.  Both walks meet the walking gates of
    tests/test_walking.py:184-209 (base z within 0.08 m of its start,
    progress > 0.02 m, slip < 2 cm)."""
    runs, spread = walks
    j, t = runs["j"], runs["t"]
    for name in ("base_z", "progress", "slip"):
        err = np.abs(t[name] - j[name])
        print(f"{name}: port vs JAX max {err.max():.3e} (tick {int(err.argmax())}); "
              f"JAX last {j[name][-1]:.6f}, port {t[name][-1]:.6f}")
        if err.max() >= FLOOR:
            sp = np.abs(spread()[name] - j[name])
            bound = np.maximum(FLOOR, 10 * sp)
            parted = np.flatnonzero(err >= bound)
            print(f"{name}: JAX spread max {sp.max():.3e}")
            assert parted.size == 0, (
                f"{name}: the walks part at tick {int(parted[0])}: port vs JAX "
                f"{err[parted[0]]:.3e} >= {bound[parted[0]]:.3e}")
    for w in (j, t):
        assert np.abs(w["base_z"] - w["base_z"][0]).max() < 0.08
        assert w["progress"][-1] > 0.02
        assert w["slip"].max() < 0.02
