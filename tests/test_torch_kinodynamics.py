"""PyTorch port vs JAX package: Go2 handler, problem construction and the
kinodynamics stage bundle (kernel K1, `stage_eval_soa`) on the same numpy
inputs, f64 CPU.

Tolerance 1e-11: same float64 arithmetic on both sides; the bundle chains
FK, a 3x3 SPD solve and weights up to 2000, which costs a few ulps more
than the single ops of test_torch_soa.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_mpc_tpu import configs as jconfigs
from simple_mpc_tpu.models.handler import RobotDataHandler as JData
from simple_mpc_tpu.solver.proxddp import ProxDDPSolver
from simple_mpc_tpu_torch import configs as tconfigs
from simple_mpc_tpu_torch.convert import problem_from_numpy
from simple_mpc_tpu_torch.models.handler import RobotDataHandler as TData
from simple_mpc_tpu_torch.ocp.base import index_params, roll_params

TOL = 1e-11
T = 8


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def pair():
    jocp, jmh, x0 = jconfigs.make_go2_kinodynamics(T)
    tocp, tmh, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    return jocp, jmh, tocp, tmh, x0


def _state(rng, mh, n):
    x = np.repeat(np.asarray(mh.reference_state)[None], n, axis=0)
    x = x + 0.05 * rng.normal(size=x.shape)
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    return x


def test_handler(pair):
    jocp, jmh, tocp, tmh, x0 = pair
    assert tmh.feet_names == jmh.feet_names
    assert tmh.feet_frame_ids == jmh.feet_frame_ids
    assert tmh.feet_ref_frame_ids == jmh.feet_ref_frame_ids
    for fj, ft in zip(jmh.model.frames, tmh.model.frames):
        assert fj.name == ft.name and fj.parent_joint == ft.parent_joint
        _close(ft.R, fj.R)
        _close(ft.p, fj.p)
    assert tmh.mass == pytest.approx(jmh.mass, rel=1e-15)
    x = _state(np.random.default_rng(3), jmh, 1)[0]
    x[jmh.model.nq:] = np.random.default_rng(4).normal(size=jmh.model.nv)
    jd, td = JData(jmh), TData(tmh)
    jd.update(jnp.asarray(x))
    td.update(x)
    for f in ["q", "v", "oR", "op", "fR", "fp", "com", "hg"]:
        _close(getattr(td.data, f), getattr(jd.data, f))
    for k in range(4):
        for a, b in zip(td.get_foot_pose(k), jd.get_foot_pose(k)):
            _close(a, b)
        for a, b in zip(td.get_foot_ref_pose(k), jd.get_foot_ref_pose(k)):
            _close(a, b)
    _close(td.get_centroidal_state(), jd.get_centroidal_state())
    for a, b in zip(td.get_base_frame_pose(), jd.get_base_frame_pose()):
        _close(a, b)
    x2 = _state(np.random.default_rng(5), jmh, 1)[0]
    _close(tmh.difference(x, x2), jmh.difference(x, x2))
    dx = np.random.default_rng(6).normal(size=2 * jmh.model.nv)
    _close(tmh.integrate(x, dx), jmh.integrate(x, dx))


def test_create_problem(pair):
    jocp, jmh, tocp, tmh, x0 = pair
    assert (tocp.nu, tocp.n_eq, tocp.n_in, tocp.n_term_eq) == \
        (jocp.nu, jocp.n_eq, jocp.n_in, jocp.n_term_eq)
    jp, tp = jocp.problem, tocp.problem
    assert tp.horizon == jp.horizon == T
    _close(tp.x0, jp.x0)
    for f in jp.stage_params._fields:
        _close(getattr(tp.stage_params, f), getattr(jp.stage_params, f))
    for f in jp.term_params._fields:
        _close(getattr(tp.term_params, f), getattr(jp.term_params, f))
    np.testing.assert_array_equal(tocp.u_scale, jocp.u_scale)
    assert tocp.get_contact_support(0) == jocp.get_contact_support(0)
    assert tocp.get_contact_state(3) == jocp.get_contact_state(3)


def _stage_inputs(jocp, jmh, rng):
    X = _state(rng, jmh, T).T
    X[jmh.model.nq:] = 0.3 * rng.normal(size=(jmh.model.nv, T))
    U = (np.asarray(jocp.problem.stage_params.u_ref).T
         + rng.normal(size=(jocp.nu, T)))
    sp = jocp.problem.stage_params
    active = np.asarray(sp.contact_active).copy()
    active[::3, 1] = 0.0  # some swing feet
    sp = sp._replace(contact_active=jnp.asarray(active))
    return X, U, sp


def test_stage_eval_soa(pair):
    jocp, jmh, tocp, tmh, x0 = pair
    X, U, sp = _stage_inputs(jocp, jmh, np.random.default_rng(7))
    P = ProxDDPSolver._transpose_params(sp)
    ref = jocp.stage_eval_soa(jnp.asarray(X), jnp.asarray(U), P)
    tprob = problem_from_numpy(tocp, sp, jocp.problem.term_params, x0, "cpu")
    tP = type(tprob.stage_params)._make(a.movedim(0, -1) for a in tprob.stage_params)
    out = tocp.stage_eval_soa(torch.as_tensor(X), torch.as_tensor(U), tP)
    for name, a, b in zip(["r", "w", "geq", "h", "xnext"], out, ref):
        _close(a, b)


def test_terminal_and_state_derivative(pair):
    jocp, jmh, tocp, tmh, x0 = pair
    rng = np.random.default_rng(8)
    x = _state(rng, jmh, 3)
    tp_j = jocp.problem.term_params
    tp_t = tocp.problem.term_params
    for i in range(3):
        rj, wj = jocp.term_residuals(jnp.asarray(x[i]), tp_j)
        rt, wt = tocp.term_residuals(torch.as_tensor(x[i]), tp_t)
        _close(rt, rj)
        _close(wt, wj)
    # batched points with matching leading axes
    tpb = type(tp_t)._make(a.expand((3,) + a.shape) for a in tp_t)
    rb, _ = tocp.term_residuals(torch.as_tensor(x), tpb)
    _close(rb[1], jocp.term_residuals(jnp.asarray(x[1]), tp_j)[0])
    u = np.asarray(jocp.problem.stage_params.u_ref[2]) + rng.normal(size=jocp.nu)
    pj = type(jocp.problem.stage_params)(*[a[2] for a in jocp.problem.stage_params])
    pt = index_params(tocp.problem.stage_params, 2)
    _close(tocp.state_derivative(torch.as_tensor(x[0]), torch.as_tensor(u), pt),
           jocp.state_derivative(jnp.asarray(x[0]), jnp.asarray(u), pj), tol=1e-10)


def test_terminal_dcm_constraint():
    jocp, jmh, x0 = jconfigs.make_go2_kinodynamics(4)
    tocp, tmh, _ = tconfigs.make_go2_kinodynamics(4, device="cpu")
    jp = jocp.make_term_params(jnp.asarray(x0), True)
    tp = tocp.make_term_params(x0, True)
    assert tocp.n_term_eq == jocp.n_term_eq == 3
    x = _state(np.random.default_rng(9), jmh, 1)[0]
    _close(tocp.term_eq_constraints(torch.as_tensor(x), tp),
           jocp.term_eq_constraints(jnp.asarray(x), jp))


def test_setters_and_roll(pair):
    jocp0, jmh, tocp0, tmh, x0 = pair
    jocp, _, _ = jconfigs.make_go2_kinodynamics(T)
    tocp, _, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    rng = np.random.default_rng(10)
    refs = rng.normal(size=(T, 4, 3))
    xr = _state(rng, jmh, 1)[0]
    vb = rng.normal(size=6)
    com = rng.normal(size=3)
    for ocp, conv in ((jocp, jnp.asarray), (tocp, torch.as_tensor)):
        ocp.set_all_foot_translations(conv(refs))
        ocp.set_reference_state(T - 1, conv(xr))
        ocp.set_velocity_base(T - 1, conv(vb))
        ocp.update_terminal_constraint(conv(com))
        ocp.set_reference_control(2, conv(np.arange(24.0)))
    for f in jocp.problem.stage_params._fields:
        _close(getattr(tocp.problem.stage_params, f),
               getattr(jocp.problem.stage_params, f), tol=0)
    _close(tocp.problem.term_params.dcm_ref, jocp.problem.term_params.dcm_ref, tol=0)
    _close(tocp.get_reference_force(2, "FR_foot"),
           jocp.get_reference_force(2, "FR_foot"), tol=0)
    _close(tocp.get_reference_state(T - 1), jocp.get_reference_state(T - 1), tol=0)
    _close(tocp.get_reference_control(2), jocp.get_reference_control(2), tol=0)
    rolled = roll_params(tocp.problem.stage_params,
                         index_params(tocp.problem.stage_params, 0))
    _close(rolled.x_ref[:-1], np.asarray(jocp.problem.stage_params.x_ref)[1:], tol=0)
    with pytest.raises(IndexError):
        tocp.set_reference_state(T + 5, torch.as_tensor(xr))


def test_update_params_and_astype(pair):
    from simple_mpc_tpu.ocp import base as jbase
    from simple_mpc_tpu_torch.ocp.base import update_params

    jocp, jmh, tocp, tmh, x0 = pair
    jsp, tsp = jocp.problem.stage_params, tocp.problem.stage_params
    new_j = jbase.index_params(jsp, 5)
    new_t = index_params(tsp, 5)
    upd_j = jbase.update_params(jsp, 1, new_j)
    upd_t = update_params(tsp, 1, new_t)
    for f in jsp._fields:
        _close(getattr(upd_t, f), getattr(upd_j, f), tol=0)
    # update_params builds new leaves; the problem's own are not written
    _close(tsp.x_ref, jsp.x_ref, tol=0)
    p32 = tocp.problem.astype(torch.float32)
    j32 = jocp.problem.astype(jnp.float32)
    assert p32.x0.dtype == torch.float32 and p32.stage_params.u_ref.dtype == torch.float32
    for f in jsp._fields:
        np.testing.assert_array_equal(_np(getattr(p32.stage_params, f)),
                                      np.asarray(getattr(j32.stage_params, f)))


def test_cones():
    from simple_mpc_tpu.ocp import cones as jcones
    from simple_mpc_tpu_torch.ocp import cones as tcones

    rng = np.random.default_rng(13)
    f3, f6 = rng.normal(size=(5, 3)), rng.normal(size=(5, 6))
    np.testing.assert_array_equal(tcones.friction_cone_mat(0.7), jcones.friction_cone_mat(0.7))
    np.testing.assert_array_equal(tcones.wrench_cone_mat(0.7, 0.1, 0.05),
                                  jcones.wrench_cone_mat(0.7, 0.1, 0.05))
    # the JAX residuals take one force; the port's take leading batch axes
    _close(tcones.friction_cone(torch.as_tensor(f3), 0.7),
           [jcones.friction_cone(jnp.asarray(f), 0.7) for f in f3])
    _close(tcones.wrench_cone(torch.as_tensor(f6), 0.7, 0.1, 0.05),
           [jcones.wrench_cone(jnp.asarray(f), 0.7, 0.1, 0.05) for f in f6])
    lo, hi = np.array([-1.0, -np.inf, 0.0]), np.array([1.0, 2.0, np.inf])
    v = rng.normal(size=(4, 3))
    rt = tcones.box(torch.as_tensor(v), lo, hi)
    rj = jnp.stack([jcones.box(jnp.asarray(x), lo, hi) for x in v])
    np.testing.assert_array_equal(_np(rt), np.asarray(rj))
    mask = rng.random(size=rt.shape) > 0.5
    np.testing.assert_array_equal(_np(tcones.mask_ineq(rt, mask)),
                                  np.asarray(jcones.mask_ineq(rj, mask)))
    np.testing.assert_array_equal(_np(tcones.mask_eq(torch.as_tensor(v), mask[:, :3])),
                                  np.asarray(jcones.mask_eq(jnp.asarray(v), mask[:, :3])))


def test_entry_points_default_to_the_card():
    """The port's entry points build their problem on the card unless the
    caller asks for the CPU (every CPU test passes device="cpu")."""
    import inspect

    from simple_mpc_tpu_torch.configs import (make_go2_fulldynamics, make_go2_fused,
                                              make_go2_kinodynamics)
    from simple_mpc_tpu_torch.ocp.base import OCPHandler
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP
    from simple_mpc_tpu_torch.examples import go2_kinodynamics
    from simple_mpc_tpu_torch.id.kinodynamics_id import KinodynamicsID
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP
    from simple_mpc_tpu_torch.sim.simulator import Simulator
    from simple_mpc_tpu_torch.utils.friction import FrictionCompensation

    for fn in (make_go2_kinodynamics, make_go2_fused, make_go2_fulldynamics,
               KinodynamicsOCP.__init__, FullDynamicsOCP.__init__, OCPHandler.__init__,
               KinodynamicsID.__init__, Simulator.__init__, FrictionCompensation.__init__,
               go2_kinodynamics.setup, go2_kinodynamics.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
