"""The Riccati-feedback branch of the port's closed loop
(`examples/loop.py` `riccati_feedback`, the inner loop of the
full-dynamics examples) on Go2 full dynamics, f64, CPU:

  * its torques are the solver's own feedback law, u = us[0] + K0
    difference(xs[0], x) (the convention of the solver's rollout,
    `ProxDDPSolver._candidates`), at a perturbed state;
  * in the rigid-contact simulator, over one MPC tick (10 steps of 1 ms)
    after a push on the base, it keeps the robot closer to the unpushed
    one than the open-loop torques us[0] do, and those closer than the law
    with the difference taken the other way round (the JAX package's
    loop).

Go2 keeps the test small: the branch is model-generic, and the plant's
point feet are the MPC's contacts.
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 2


@pytest.fixture(scope="module")
def standing():
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    ocp, mh, _ = make_go2_fulldynamics(T, device="cpu", dtype=torch.float64)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8, max_iters=1,
                          init_max_iters=1, timestep=0.01), ocp)
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device="cpu")
    return mpc, mh, sim


def _pushed(mpc, nq, seed=0):
    """The plan's first state with the base's velocity moved (a push)."""
    rng = np.random.default_rng(seed)
    x = mpc.xs[0].clone()
    x[nq:nq + 6] += torch.as_tensor(0.1 * rng.standard_normal(6))
    return x[:nq], x[nq:]


def test_feedback_is_the_solvers_law(standing):
    from simple_mpc_tpu_torch.examples.loop import riccati_feedback
    from simple_mpc_tpu_torch.ops import soa

    mpc, mh, _ = standing
    q, v = _pushed(mpc, mh.model.nq)
    x = torch.cat([q, v])
    dx = soa.state_difference(mh.model, mpc.xs[0][:, None], x[:, None])[:, 0]
    assert dx.abs().max() > 0.05
    want = mpc.us[0] + mpc.Ks[0] @ dx
    torch.testing.assert_close(riccati_feedback(mpc, mh.model, q, v), want,
                               rtol=1e-12, atol=1e-12)


def test_feedback_pulls_a_perturbed_robot_back(standing):
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.examples.loop import riccati_feedback
    from simple_mpc_tpu_torch.ops import soa

    mpc, mh, sim = standing
    m = mh.model
    nq = m.nq
    us0, x0 = mpc.us[0], mpc.xs[0]
    q, v = _pushed(mpc, nq)
    # four robots in one batch of the simulator: the unpushed one under the
    # loop's law, and the pushed one under the loop's law, open loop and the
    # law with the difference the other way round
    qs, vs = torch.stack([x0[:nq], q, q, q]), torch.stack([x0[nq:], v, v, v])
    for _ in range(10):
        fb = torch.stack([riccati_feedback(mpc, m, a, b) for a, b in zip(qs, vs)])
        tau = torch.stack([fb[0], fb[1], us0, 2 * us0 - fb[3]])
        qs, vs = kernels.sim_step(sim, qs, vs, tau)[:2]
    X = torch.cat([qs, vs], dim=1).T
    dev = dict(zip(("loop", "open", "reversed"),
                   soa.state_difference(m, X[:, :1].expand(-1, 3), X[:, 1:]).norm(dim=0).tolist()))
    assert dev["loop"] < dev["open"] < dev["reversed"], dev
