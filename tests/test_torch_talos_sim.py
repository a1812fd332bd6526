"""PyTorch port vs JAX package: the Talos closed loop's simulator and the
6D kinodynamics state derivative (23 joints, two 6D quad feet), f64 CPU,
the same numpy inputs made from seeds (moved from
tests/test_torch_talos_id_sim.py, whose ID tests keep their file).

* `Simulator.step_plain` (3D point contacts at the two soles) against
  JAX's `Simulator.step` standing, with the left knee bent (that sole
  lifted) and with the base rising (both contacts pull and are dropped):
  the two contact masks equal, q, v and the world forces within 1e-10.
* The kinodynamics state derivative (`KinodynamicsOCP.state_derivative`,
  the twin of K11) with 6D wrenches against JAX's, at three perturbed
  lanes under one JAX compile: within 1e-12.
"""
import numpy as np
import pytest
import torch

from test_torch_talos_id_sim import TOL, _err, _perturbed

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sims():
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    jmh, tmh = jconfigs.talos_handler(), tconfigs.talos_handler()
    ground = foot_height(tmh)
    return (JSim(jmh.model, jmh.feet_frame_ids, JSimSettings(dt=1e-3, ground_height=ground)),
            Simulator(tmh.model, tmh.feet_frame_ids, SimSettings(dt=1e-3, ground_height=ground),
                      device="cpu"),
            np.asarray(jmh.reference_state), tmh.model.nq, tmh.model.nv)


@pytest.mark.parametrize("case", ["standing", "one_foot_lifted", "pulling_dropped"])
def test_simulator_step_matches_jax(sims, case):
    import jax.numpy as jnp
    from test_torch_id_sim import _jax_masks

    js, ts, x0, nq, nv = sims
    rng = np.random.default_rng(["standing", "one_foot_lifted", "pulling_dropped"].index(case))
    q = x0[:nq].copy()
    v, tau = 0.05 * rng.normal(size=nv), 0.5 * rng.normal(size=nv - 6)
    if case == "one_foot_lifted":
        q[10] += 0.3  # leg_left_4_joint, the left knee
    if case == "pulling_dropped":
        v[2] = 1.0  # the base rises: both soles pull on the ground
    jq, jv, jf = js.step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
    got = ts.step_plain(*(torch.as_tensor(x)[None] for x in (q, v, tau)))
    masks = _jax_masks(js, q, v, tau)
    np.testing.assert_array_equal(got.active[0].numpy(), masks)
    expect = dict(standing=[2, 2], one_foot_lifted=[1, 1], pulling_dropped=[2, 0])[case]
    assert masks.sum(axis=1).tolist() == expect
    for a, b in zip(got[:3], (jq, jv, jf)):
        assert _err(a[0], b) < TOL


@pytest.fixture(scope="module")
def derivatives():
    """The three lanes of test_6d_state_derivative_matches_jax: JAX's
    `KinodynamicsOCP.state_derivative` under one jit (one compile for the
    three lanes), the port's single-lane calls and its N=3 lanes of
    `kernels.state_derivative_plain`."""
    import jax
    import jax.numpy as jnp

    from examples.talos_kinodynamics import talos_kinodynamics_config as jconfig
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import talos_kinodynamics_config
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP

    jmh, tmh = jconfigs.talos_handler(), tconfigs.talos_handler()
    x0 = np.asarray(jmh.reference_state)
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(x0, 2, 6, -9.81, False)
    tocp = KinodynamicsOCP(talos_kinodynamics_config(tmh), tmh, "cpu")
    tocp.create_problem(x0, 2, 6, -9.81, False)
    rng = np.random.default_rng(50)
    nq, nv = tmh.model.nq, tmh.model.nv
    xs = np.stack([np.concatenate([_perturbed(x0, nq, 0.02, rng), 0.2 * rng.normal(size=nv)])
                   for _ in range(3)])
    us = 20.0 * rng.normal(size=(3, tocp.nu)) + np.r_[[0, 0, 450, 0, 0, 0] * 2,
                                                       np.zeros(nv - 6)]
    act = np.array([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])
    jp = jocp.problem.stage_params
    jp = type(jp)(*(a[0] for a in jp))
    jsd = jax.jit(jocp.state_derivative)
    P = tree_map(lambda a: a[0][None].expand((3,) + tuple(a.shape[1:])),
                 tocp.problem.stage_params)._replace(contact_active=torch.as_tensor(act))
    lanes = kernels.state_derivative_plain(tocp, torch.as_tensor(xs), torch.as_tensor(us), P)
    out = []
    for lane in range(3):
        want = jsd(jnp.asarray(xs[lane]), jnp.asarray(us[lane]),
                   jp._replace(contact_active=jnp.asarray(act[lane])))
        tp = tree_map(lambda a: a[0], tocp.problem.stage_params)
        tp = tp._replace(contact_active=torch.as_tensor(act[lane]))
        got = tocp.state_derivative(torch.as_tensor(xs[lane]), torch.as_tensor(us[lane]), tp)
        out.append((np.asarray(want), got, lanes[lane]))
    return out


@pytest.mark.parametrize("lane", range(3))
def test_6d_state_derivative_matches_jax(derivatives, lane):
    """[v; a] of the Talos example's OCP (6D wrenches, the contact torques
    in the centroidal wrench) at perturbed states, controls and contact
    masks, against JAX `KinodynamicsOCP.state_derivative`; the port's N=3
    lanes of `kernels.state_derivative_plain` hold the same numbers."""
    want, got, lane_out = derivatives[lane]
    assert _err(got, want) < 1e-12
    assert _err(lane_out, want) < 1e-12
