"""PyTorch port vs JAX package: SoA rigid-body ops (`ops/soa.py`,
`ops/soa_dyn.py`, `ops/world.py` tables) on the same numpy inputs, f64 CPU.

Tolerance 1e-12: both sides run the same unrolled float64 arithmetic; only
summation order inside einsums and libm differ.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_mpc_tpu.models import robots as jrobots
from simple_mpc_tpu.ops import soa as jsoa
from simple_mpc_tpu.ops import soa_dyn as jsoa_dyn
from simple_mpc_tpu.ops import world as jworld
from simple_mpc_tpu_torch.models import robots as trobots
from simple_mpc_tpu_torch.ops import soa as tsoa
from simple_mpc_tpu_torch.ops import soa_dyn as tsoa_dyn
from simple_mpc_tpu_torch.ops import world as tworld

TOL = 1e-12
N = 7


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _close(a, b, tol=TOL):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _close(x, y, tol)
        return
    a = np.asarray(a.detach().numpy() if torch.is_tensor(a) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def models():
    return jrobots.load_go2(), trobots.load_go2()


def _rand_rot(rng, n, scale=1.0):
    w = rng.normal(size=(3, n)) * scale
    return np.asarray(jsoa.exp3(jnp.asarray(w)))


def _go2_state(rng, model):
    """Random Go2 q (nq, N) with unit quaternions, v (nv, N)."""
    q = np.repeat(model.reference_configurations["standing"][:, None], N, axis=1)
    q = q + 0.3 * rng.normal(size=q.shape)
    quat = rng.normal(size=(4, N))
    q[3:7] = quat / np.linalg.norm(quat, axis=0, keepdims=True)
    v = rng.normal(size=(model.nv, N))
    return q, v


def _rot_cases(rng):
    """Generic, near-zero and near-pi rotations for log3."""
    R = _rand_rot(rng, N)
    tiny = _rand_rot(rng, N, scale=1e-9)
    axis = rng.normal(size=(3, N))
    axis /= np.linalg.norm(axis, axis=0, keepdims=True)
    near_pi = np.asarray(jsoa.exp3(jnp.asarray(axis * (np.pi - 1e-7))))
    at_pi = np.asarray(jsoa.exp3(jnp.asarray(axis * np.pi)))
    return np.concatenate([R, tiny, near_pi, at_pi, np.eye(3)[..., None]], axis=-1)


SMALL_ALGEBRA = ["mm", "mtm", "mv", "mtv", "cross", "quat_to_rotmat",
                 "rotmat_to_quat", "quat_normalize", "exp3", "log3",
                 "so3_jacobians", "exp6", "log6", "freeflyer_integrate",
                 "freeflyer_difference", "motion_action_inv", "force_action",
                 "motion_cross", "motion_cross_star", "solve_spd3",
                 "solve_spd6", "shift_to_com"]


@pytest.mark.parametrize("name", SMALL_ALGEBRA)
def test_small_algebra(name):
    rng = np.random.default_rng(0)
    R1, R2 = _rand_rot(rng, N), _rand_rot(rng, N)
    v3, w3 = rng.normal(size=(3, N)), rng.normal(size=(3, N))
    v6, f6 = rng.normal(size=(6, N)), rng.normal(size=(6, N))
    quat = rng.normal(size=(4, N))
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    pq = np.concatenate([rng.normal(size=(3, N)), quat], axis=0)
    quat2 = rng.normal(size=(4, N))
    pq2 = np.concatenate([rng.normal(size=(3, N)),
                          quat2 / np.linalg.norm(quat2, axis=0)], axis=0)
    M3 = rng.normal(size=(3, 3, N))
    spd3 = np.einsum("ikn,jkn->ijn", M3, M3) + np.eye(3)[..., None]
    M6 = rng.normal(size=(6, 6, N))
    spd6 = np.einsum("ikn,jkn->ijn", M6, M6) + np.eye(6)[..., None]
    tiny = rng.normal(size=(3, N)) * 1e-9
    args = {
        "mm": (R1, R2), "mtm": (R1, R2), "mv": (R1, v3), "mtv": (R1, v3),
        "cross": (v3, w3), "quat_to_rotmat": (quat,),
        "rotmat_to_quat": (_rot_cases(rng),), "quat_normalize": (3.0 * quat,),
        "exp3": (np.concatenate([v3, tiny], axis=-1),),
        "log3": (_rot_cases(rng),),
        "so3_jacobians": (np.concatenate([v3, tiny], axis=-1),),
        "exp6": (v6,), "log6": (R1, v3), "freeflyer_integrate": (pq, v6),
        "freeflyer_difference": (pq, pq2), "motion_action_inv": (R1, v3, v6),
        "force_action": (R1, v3, f6), "motion_cross": (v6, f6),
        "motion_cross_star": (v6, f6), "solve_spd3": (spd3, v3),
        "solve_spd6": (spd6, v6), "shift_to_com": (f6, v3),
    }[name]
    ref = getattr(jsoa, name)(*[jnp.asarray(a) for a in args])
    out = getattr(tsoa, name)(*[_t(a) for a in args])
    _close(out, ref)


WORLD = ["integrate", "difference", "state_integrate", "state_difference",
         "fk_world", "frame_placements_world", "frame_placements_feet",
         "world_axes", "body_velocities", "com_world", "inertia_apply", "agx",
         "ag6", "composite_rot_inertia", "centroidal_solve6", "bias_hdot",
         "frame_velocities_world"]


@pytest.mark.parametrize("name", WORLD)
def test_world_ops(models, name):
    jm, tm = models
    rng = np.random.default_rng(1)
    q, v = _go2_state(rng, jm)
    q2, _ = _go2_state(rng, jm)
    dq = rng.normal(size=(jm.nv, N))
    x = np.concatenate([q, v], axis=0)
    x2 = np.concatenate([q2, rng.normal(size=v.shape)], axis=0)
    dx = rng.normal(size=(2 * jm.nv, N))
    b6 = rng.normal(size=(6, N))
    feet = [jm.frame_id(f) for f in ["FL_foot", "FR_foot", "RL_foot", "RR_foot"]]

    def chain(S, m):
        """FK -> axes -> velocities -> CoM on side S with model m."""
        qq, vv = (jnp.asarray(q), jnp.asarray(v)) if S is jsoa else (_t(q), _t(v))
        oR, op = S.fk_world(m, qq)
        Sw = S.world_axes(m, oR, op)
        vW = S.body_velocities(m, Sw, vv)
        com = S.com_world(m, oR, op)
        return qq, vv, oR, op, Sw, vW, com

    def run(S, m):
        qq, vv, oR, op, Sw, vW, com = chain(S, m)
        conv = jnp.asarray if S is jsoa else _t
        if name == "integrate":
            return S.integrate(m, qq, conv(dq))
        if name == "difference":
            return S.difference(m, qq, conv(q2))
        if name == "state_integrate":
            return S.state_integrate(m, conv(x), conv(dx))
        if name == "state_difference":
            return S.state_difference(m, conv(x), conv(x2))
        if name == "fk_world":
            return oR, op
        if name == "frame_placements_world":
            return S.frame_placements_world(m, oR, op)
        if name == "frame_placements_feet":
            return S.frame_placements_world(m, oR, op, feet)
        if name == "world_axes":
            return Sw
        if name == "body_velocities":
            return vW
        if name == "com_world":
            return com
        if name == "inertia_apply":
            return S.inertia_apply(m, oR, op, vW)
        if name == "agx":
            return S.agx(m, oR, op, Sw, vv, com)
        if name == "ag6":
            return S.ag6(m, oR, op, Sw, com)
        if name == "composite_rot_inertia":
            return S.composite_rot_inertia(m, oR, op, com)
        if name == "centroidal_solve6":
            return S.centroidal_solve6(m, oR, op, com, conv(b6))
        if name == "bias_hdot":
            return S.bias_hdot(m, oR, op, Sw, vW, vv, com)
        if name == "frame_velocities_world":
            fRw, fpw = S.frame_placements_world(m, oR, op, feet)
            par = jworld.tables(jm).fparent[np.asarray(feet)]
            return S.frame_velocities_world(m, vW, fRw, fpw, par)
        raise KeyError(name)

    _close(run(tsoa, tm), run(jsoa, jm))


def test_world_tables(models):
    jm, tm = models
    jt, tt = jworld.tables(jm), tworld.tables(tm)
    for f in jt._fields:
        a, b = getattr(tt, f), getattr(jt, f)
        if f == "doubling":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tables_rebuild_on_new_frame(models):
    from simple_mpc_tpu_torch.models.model import Frame

    tm = trobots.load_go2()
    n0 = tworld.tables(tm).fparent.shape[0]
    tm.add_frame(Frame("extra", 1, np.eye(3), np.zeros(3)))
    assert tworld.tables(tm).fparent.shape[0] == n0 + 1
    assert tworld.device_tables(tm, torch.float64, "cpu")["fparent"].shape[0] == n0 + 1


@pytest.mark.parametrize("n", [3, 24])
def test_unrolled_cholesky(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(n, n, N))
    A = np.einsum("ikn,jkn->ijn", M, M) + n * np.eye(n)[..., None]
    b = rng.normal(size=(n, N))
    ref = jsoa_dyn.solve_spd(jnp.asarray(A), jnp.asarray(b))
    _close(tsoa_dyn.solve_spd(_t(A), _t(b)), ref)
    Lj = jsoa_dyn.chol_unrolled(jnp.asarray(A))
    Lt = tsoa_dyn.chol_unrolled(_t(A))
    for i in range(n):
        for j in range(i + 1):
            _close(Lt[i][j], Lj[i][j])
    # pivot floor: a singular matrix factors to finite values
    Lz = tsoa_dyn.chol_unrolled(torch.zeros(n, n, 1, dtype=torch.float64))
    assert float(Lz[0][0][0]) == pytest.approx(1e-15)


@pytest.mark.parametrize("name", ["go2", "solo12"])
def test_robot_loaders(name):
    jm, tm = jrobots.load(name), trobots.load(name)
    assert (tm.nq, tm.nv, tm.njoints) == (jm.nq, jm.nv, jm.njoints)
    assert [f.name for f in tm.frames] == [f.name for f in jm.frames]
    np.testing.assert_array_equal(tm.reference_configurations["standing"],
                                  jm.reference_configurations["standing"])
    for f in ("parents", "joint_types", "idx_q", "idx_v", "mass", "com", "inertia",
              "jR", "jp", "axes", "lower_limit", "upper_limit"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)


def test_spaces(models):
    from simple_mpc_tpu.ocp import spaces as jspaces
    from simple_mpc_tpu_torch.ocp import spaces as tspaces

    jm, tm = models
    rng = np.random.default_rng(12)
    q, v = _go2_state(rng, jm)
    q2, v2 = _go2_state(rng, jm)
    x, x2 = np.concatenate([q, v]).T, np.concatenate([q2, v2]).T  # (N, nx)
    dx = rng.normal(size=(N, 2 * jm.nv))
    js, ts = jspaces.MultibodyPhaseSpace(jm), tspaces.MultibodyPhaseSpace(tm)
    assert (ts.nx, ts.ndx, ts.tangent_split) == (js.nx, js.ndx, js.tangent_split)
    _close(ts.difference(_t(x[0]), _t(x2[0])), js.difference(jnp.asarray(x[0]),
                                                             jnp.asarray(x2[0])))
    _close(ts.integrate(_t(x[1]), _t(dx[1])), js.integrate(jnp.asarray(x[1]),
                                                           jnp.asarray(dx[1])))
    # leading batch axes go into the lanes
    _close(ts.integrate(_t(x), _t(dx))[4], js.integrate(jnp.asarray(x[4]),
                                                        jnp.asarray(dx[4])))
    _close(ts.difference_soa(_t(x.T), _t(x2.T)),
           jsoa.state_difference(jm, jnp.asarray(x.T), jnp.asarray(x2.T)))
    jv, tv = jspaces.VectorSpace(5), tspaces.VectorSpace(5)
    a, b = rng.normal(size=5), rng.normal(size=5)
    assert (tv.nx, tv.ndx, tv.tangent_split) == (jv.nx, jv.ndx, jv.tangent_split)
    _close(tv.integrate(_t(a), _t(b)), jv.integrate(jnp.asarray(a), jnp.asarray(b)))
    _close(tv.difference(_t(a), _t(b)), jv.difference(jnp.asarray(a), jnp.asarray(b)))
    _close(tv.neutral(), jv.neutral())


def test_port_does_not_import_jax():
    code = ("import sys, simple_mpc_tpu_torch, simple_mpc_tpu_torch.kernels,"
            " simple_mpc_tpu_torch.ocp.fulldynamics, simple_mpc_tpu_torch.id.qp,"
            " simple_mpc_tpu_torch.id.kinodynamics_id, simple_mpc_tpu_torch.sim.simulator,"
            " simple_mpc_tpu_torch.utils.interpolator, simple_mpc_tpu_torch.utils.friction,"
            " simple_mpc_tpu_torch.examples.loop, simple_mpc_tpu_torch.examples.go2_kinodynamics;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('simple_mpc_tpu.') or m == 'simple_mpc_tpu'];"
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
