"""PyTorch port vs JAX package: Go2 full dynamics (kernel K7 and the
full-dynamics OCP) on the same numpy inputs, f64 CPU.

  * K7's pieces (`ops/soa_dyn.py`: world inertias, CRBA, bias torques,
    contact Jacobians, the constrained dynamics with zero and with vector
    Baumgarte gains over mixed contact masks) on 6 random (q, v), JAX jit'd
    at that N: 1e-10 relative to max(1, |JAX|) (float64 roundoff; the KKT
    chain is two Cholesky solves deep);
  * `FullDynamicsOCP.stage_eval_soa` at T=6 with and without the landing
    constraints, on the inputs of tests/test_soa_fulldynamics.py: 1e-10;
  * the OCP: problem construction, `u_scale`, setters and getters (with
    `IndexError` out of range), `get_contact_forces` and
    `state_derivative` against JAX's at N=1: 1e-10;
  * the linearization twin (`torch.func` tangents over the bundle, with the
    nested jvp that forms J-dot) against central differences of the port's
    own bundle at T=2 with u_scale="auto" (step and tolerance below);
  * the host MPC on full dynamics (T=4): cycle horizon, two ticks and
    `MPC.get_contact_forces`;
  * why chip_smoke.py's full-dynamics solves cut the friction pyramids and
    warm-start from the quasistatic torques: the pyramid geometry at the
    standing posture (a linear programme), and the f32 serial Riccati pass
    from zero torque beside JAX's own (T=100).

The `slow` tests hold the twin (1e-9) and two solver iterations (1e-9, or
ten times the JAX solver's own spread under a 1e-15 relative change of its
warm start where that is larger) to the JAX solver, and show the T=100
standing problem with the pyramids stalling in JAX as in the port; the JAX
full-dynamics linearization takes minutes to compile on the CPU.  The
`cuda` tests hold the three CUDA kernels to their twins on the card; they
import no JAX (on the card: `python -m pytest --noconftest -m cuda
tests/test_torch_fulldynamics.py`).
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-10
N = 6
T_STAGE = 6
# central differences of the bundle: step and tolerance relative to
# max(1, |twin|).  At h = 1e-6 the truncation error is ~h^2 and the
# roundoff ~1e-16 |r| / h; the largest reading is 9.0e-9 (see the test).
FD_STEP = 1e-6
FD_TOL = 1e-7


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max(initial=0.0)))


def _rand_states(nq, nv, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, nq)) * 0.3
    quat = rng.normal(size=(n, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    return q, rng.normal(size=(n, nv))


@pytest.fixture(scope="module")
def jx():
    """The JAX side, built once: handler, the two OCPs (land_cstr False and
    True) at T=6, and the port's counterparts."""
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP as TOCP

    jmh, tmh = jconfigs.go2_handler(), tconfigs.go2_handler()
    ocps = {}
    for land in (False, True):
        jc, tc = jconfigs.go2_fulldynamics_config(jmh), tconfigs.go2_fulldynamics_config(tmh)
        jc["land_cstr"] = tc["land_cstr"] = land
        jocp, tocp = JOCP(jc, jmh), TOCP(tc, tmh, "cpu")
        x0 = np.asarray(jmh.reference_state)
        jocp.create_problem(jnp.asarray(x0), T_STAGE, 3, -9.81, True)
        tocp.create_problem(x0, T_STAGE, 3, -9.81, True)
        ocps[land] = (jocp, tocp)
    return dict(jmh=jmh, tmh=tmh, ocps=ocps, x0=np.asarray(jmh.reference_state))


# ---------------------------------------------------------------------------
# K7's pieces
# ---------------------------------------------------------------------------


def test_inertias_crba_nle_jacobians(jx):
    import jax

    from simple_mpc_tpu.ops import soa as jsoa
    from simple_mpc_tpu.ops import soa_dyn as jdyn
    from simple_mpc_tpu_torch.ops import soa as tsoa
    from simple_mpc_tpu_torch.ops import soa_dyn as tdyn

    jm, tm = jx["jmh"].model, jx["tmh"].model
    fids = list(jx["jmh"].feet_frame_ids)
    q, v = _rand_states(jm.nq, jm.nv, N, seed=1)

    def pieces(mod_soa, mod_dyn, model, qT, vT):
        oR, op = mod_soa.fk_world(model, qT)
        Sw = mod_soa.world_axes(model, oR, op)
        vW = mod_soa.body_velocities(model, Sw, vT)
        IW = mod_dyn.body_inertias_world(model, oR, op)
        J, fR, fp = mod_dyn.contact_jacobians(model, oR, op, Sw, fids, 3)
        return (IW, mod_dyn.crba_world(model, oR, op, Sw),
                mod_dyn.nle_world(model, oR, op, Sw, vW, vT), J, fR, fp)

    ref = jax.jit(lambda a, b: pieces(jsoa, jdyn, jm, a, b))(q.T, v.T)
    out = pieces(tsoa, tdyn, tm, torch.as_tensor(q.T), torch.as_tensor(v.T))
    for name, a, b in zip(["IW", "M", "b", "Jc", "fRw", "fpw"], out, ref):
        _close(a, b)


@pytest.mark.parametrize("gains", ["zero", "vector"])
def test_constrained_dynamics(jx, gains):
    import jax

    from simple_mpc_tpu.ops import soa_dyn as jdyn
    from simple_mpc_tpu_torch.ops import soa_dyn as tdyn

    jm, tm = jx["jmh"].model, jx["tmh"].model
    fids = list(jx["jmh"].feet_frame_ids)
    q, v = _rand_states(jm.nq, jm.nv, N, seed=2)
    rng = np.random.default_rng(3)
    tau = rng.normal(size=(N, jm.nv)) * 5.0
    active = (rng.random((N, 4)) > 0.3).astype(np.float64)
    active[0] = 1.0  # one lane with every foot in contact
    ref_p = np.moveaxis(rng.normal(size=(N, 4, 3)) * 0.1, 0, -1)
    kp, kd = ((0.0, 0.0) if gains == "zero"
              else (np.linspace(5.0, 30.0, 3), np.linspace(0.5, 4.0, 3)))
    ddq0, f0 = jax.jit(lambda a, b, c, d, e: jdyn.constrained_fwd_dynamics_soa(
        jm, a, b, c, fids, d, dim=3, ref_p=e, kp=kp, kd=kd))(
            q.T, v.T, tau.T, active.T, ref_p)
    t = torch.as_tensor
    ddq1, f1 = tdyn.constrained_fwd_dynamics_soa(
        tm, t(q.T), t(v.T), t(tau.T), fids, t(active.T), dim=3, ref_p=t(ref_p),
        kp=kp, kd=kd)
    _close(ddq1, ddq0)
    _close(f1, f0)
    # inactive feet carry no force
    assert np.all(np.moveaxis(_np(f1), 1, -1)[active.T == 0] == 0.0)


# ---------------------------------------------------------------------------
# The OCP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("land", [False, True])
def test_stage_eval_soa(jx, land):
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu_torch.convert import problem_from_numpy

    jocp, tocp = jx["ocps"][land]
    x0 = jx["x0"]
    sp = jocp.problem.stage_params
    rng = np.random.default_rng(7)
    pert = rng.normal(size=(T_STAGE, x0.shape[0])) * 0.05
    pert[:, 3:7] = 0.0
    xs = x0[None] + pert
    us = rng.normal(size=(T_STAGE, jocp.nu))
    act = np.asarray(sp.contact_active).copy()
    act[::2, 1] = 0.0  # some swing feet
    sp = sp._replace(contact_active=jnp.asarray(act))
    if land:
        sp = sp._replace(land=sp.land.at[T_STAGE // 2].set(1.0).at[1, 1].set(1.0))
    ref = jax.jit(jocp.stage_eval_soa)(jnp.asarray(xs.T), jnp.asarray(us.T),
                                       JSolver._transpose_params(sp))
    tprob = problem_from_numpy(tocp, sp, jocp.problem.term_params, x0, "cpu")
    tP = type(tprob.stage_params)._make(a.movedim(0, -1) for a in tprob.stage_params)
    out = tocp.stage_eval_soa(torch.as_tensor(xs.T), torch.as_tensor(us.T), tP)
    assert out[0].shape[0] == 78 and out[3].shape[0] == 68
    assert out[2].shape[0] == (16 if land else 0)
    for a, b in zip(out, ref):
        _close(a, b)


def test_problem_and_u_scale(jx):
    jocp, tocp = jx["ocps"][False]
    assert (tocp.nu, tocp.n_eq, tocp.n_in, tocp.n_term_eq) == \
        (jocp.nu, jocp.n_eq, jocp.n_in, jocp.n_term_eq) == (12, 0, 68, 3)
    jp, tp = jocp.problem, tocp.problem
    _close(tp.x0, jp.x0)
    for f in jp.stage_params._fields:
        _close(getattr(tp.stage_params, f), getattr(jp.stage_params, f))
    for f in jp.term_params._fields:
        _close(getattr(tp.term_params, f), getattr(jp.term_params, f))
    np.testing.assert_array_equal(tocp.u_scale, jocp.u_scale)
    x = np.asarray(jp.x0) + 0.05 * np.random.default_rng(9).normal(size=jp.x0.shape)
    x[3:7] /= np.linalg.norm(x[3:7])
    for a, b in zip(tocp.term_residuals(torch.as_tensor(x), tp.term_params),
                    jocp.term_residuals(x, jp.term_params)):
        _close(a, b)
    _close(tocp.term_eq_constraints(torch.as_tensor(x), tp.term_params),
           jocp.term_eq_constraints(x, jp.term_params))


def test_setters_and_getters(jx):
    import jax.numpy as jnp

    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP as TOCP

    x0 = jx["x0"]
    jocp0, tocp0 = jx["ocps"][False]
    jocp, tocp = JOCP(jocp0.settings, jx["jmh"]), TOCP(tocp0.settings, jx["tmh"], "cpu")
    jocp.create_problem(jnp.asarray(x0), T_STAGE, 3, -9.81, False)
    tocp.create_problem(x0, T_STAGE, 3, -9.81, False)
    rng = np.random.default_rng(11)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    refs = rng.normal(size=(T_STAGE, 4, 3))
    xr = x0 + 0.01 * rng.normal(size=x0.shape)
    for ocp, conv in ((jocp, jnp.asarray), (tocp, torch.as_tensor)):
        ocp.set_reference_poses(2, {"FL_foot": (conv(R), conv(np.array([0.3, 0.1, 0.0])))})
        ocp.set_reference_forces(3, {"RR_foot": conv(np.array([1.0, 2.0, 30.0]))})
        ocp.set_velocity_base(4, conv(np.arange(6.0)))
        ocp.set_pose_base(1, conv(xr[:7]))
        ocp.set_reference_state(5, conv(xr))
        ocp.set_terminal_reference_state(conv(xr))
        ocp.update_terminal_constraint(conv(np.array([0.1, 0.2, 0.3])))
        ocp.set_reference_control(2, conv(np.arange(12.0)))
    for f in jocp.problem.stage_params._fields:
        _close(getattr(tocp.problem.stage_params, f), getattr(jocp.problem.stage_params, f),
               tol=0)
    for f in jocp.problem.term_params._fields:
        _close(getattr(tocp.problem.term_params, f), getattr(jocp.problem.term_params, f),
               tol=0)
    for t in range(T_STAGE):
        for a, b in zip(tocp.get_reference_pose(t, "FL_foot"),
                        jocp.get_reference_pose(t, "FL_foot")):
            _close(a, b, tol=0)
        _close(tocp.get_reference_force(t, "RR_foot"), jocp.get_reference_force(t, "RR_foot"),
               tol=0)
        _close(tocp.get_velocity_base(t), jocp.get_velocity_base(t), tol=0)
        _close(tocp.get_pose_base(t), jocp.get_pose_base(t), tol=0)
        _close(tocp.get_reference_state(t), jocp.get_reference_state(t), tol=0)
    tocp.set_all_foot_translations(refs)
    jocp.set_all_foot_translations(jnp.asarray(refs))
    _close(tocp.problem.stage_params.foot_ref_p, jocp.problem.stage_params.foot_ref_p, tol=0)
    # out of range: the port raises where JAX's .at[] drops the write
    for call in (lambda: tocp.set_reference_pose(T_STAGE + 2, "FL_foot", R, np.zeros(3)),
                 lambda: tocp.set_reference_force(T_STAGE, "FL_foot", np.zeros(3)),
                 lambda: tocp.set_velocity_base(T_STAGE + 1, np.zeros(6)),
                 lambda: tocp.set_pose_base(T_STAGE + 1, x0[:7]),
                 lambda: tocp.set_reference_state(T_STAGE + 5, x0),
                 lambda: tocp.get_reference_force(T_STAGE, "FL_foot"),
                 lambda: tocp.get_reference_pose(T_STAGE, "FL_foot")):
        with pytest.raises(IndexError):
            call()


def test_contact_forces_and_state_derivative(jx):
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.ocp.base import index_params

    jocp, tocp = jx["ocps"][False]
    x0 = jx["x0"]
    rng = np.random.default_rng(13)
    sp_j = jocp.problem.stage_params
    jf = jax.jit(lambda x, u, p: (jocp.get_contact_forces(x, u, p),
                                  jocp.state_derivative(x, u, p)))
    for t, off in ((1, None), (2, 1)):
        x = x0 + 0.05 * rng.normal(size=x0.shape)
        x[3:7] /= np.linalg.norm(x[3:7])
        u = 3.0 * rng.normal(size=jocp.nu)
        pj = jax.tree_util.tree_map(lambda a: a[t], sp_j)
        pt = index_params(tocp.problem.stage_params, t)
        if off is not None:  # a swing foot
            pj = pj._replace(contact_active=pj.contact_active.at[off].set(0.0))
            act = pt.contact_active.clone()
            act[off] = 0.0
            pt = pt._replace(contact_active=act)
        f_ref, xd_ref = jf(jnp.asarray(x), jnp.asarray(u), pj)
        f = tocp.get_contact_forces(torch.as_tensor(x), torch.as_tensor(u), pt)
        xd = tocp.state_derivative(torch.as_tensor(x), torch.as_tensor(u), pt)
        assert f.shape == (4, 3)
        _close(f, f_ref)
        _close(xd, xd_ref)


def test_pyramids_exclude_rest_at_the_standing_posture():
    """The friction pyramids bound the force in the LOCAL foot frame (3D
    LOCAL contacts), and at the Go2 standing posture each foot frame is its
    calf's, pitched by thigh + calf = 0.8 - 1.6 = -0.8 rad (45.8 deg), beyond
    the pyramid's half-angle atan(0.8) (38.7 deg), all four the same way.  A
    linear programme over the twelve force components finds the largest
    world-x force of any set inside the pyramids that carries m g with no
    world-y part: it is m g tan(atan(0.8) - 0.8) < 0, so no admissible set
    holds the robot at rest in that posture.  (The port's foot frames are
    JAX's to 1e-10: `test_inertias_crba_nle_jacobians`.)"""
    from scipy.optimize import linprog

    from simple_mpc_tpu_torch.configs import go2_fulldynamics_config, go2_handler
    from simple_mpc_tpu_torch.ocp.cones import FRICTION_EPS, friction_cone_mat
    from simple_mpc_tpu_torch.ops import soa, soa_dyn

    mh = go2_handler()
    m, mu = mh.model, go2_fulldynamics_config(mh)["mu"]
    q = torch.as_tensor(np.asarray(mh.reference_state)[: m.nq])[:, None]
    oR, op = soa.fk_world(m, q)
    _, fRw, _ = soa_dyn.contact_jacobians(m, oR, op, soa.world_axes(m, oR, op),
                                          list(mh.feet_frame_ids), 3)
    R = _np(fRw[..., 0])  # (4, 3, 3): local -> world
    np.testing.assert_allclose(np.arccos(R[:, 2, 2]), 0.8, rtol=0, atol=1e-12)
    A = friction_cone_mat(mu)
    nk = R.shape[0]
    A_ub = np.kron(np.eye(nk), A)  # A f_k + eps e0 <= 0
    b_ub = np.tile([-FRICTION_EPS, 0, 0, 0, 0], nk)
    A_eq = np.concatenate(list(R[:, 1:]), axis=1)  # sum_k (R_k f_k)_{y,z}
    mg = mh.mass * 9.81
    lp = linprog(-np.concatenate(list(R[:, 0])), A_ub=A_ub, b_ub=b_ub, A_eq=A_eq,
                 b_eq=[0.0, mg], bounds=(None, None), method="highs")
    assert lp.status == 0, lp.message
    max_fx = -lp.fun
    assert max_fx < 0
    np.testing.assert_allclose(max_fx, mg * np.tan(np.arctan(mu) - 0.8), rtol=1e-9)


# ---------------------------------------------------------------------------
# The linearization twin
# ---------------------------------------------------------------------------


def _lin_case(T, seed):
    """Go2 full dynamics at T, one scenario: a perturbed iterate with a swing
    foot, AL multipliers (inequalities half active) and its solver with
    u_scale="auto"."""
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, _, x0 = make_go2_fulldynamics(T, device="cpu")
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None], T + 1, 0) + 0.03 * rng.normal(size=(T + 1, x0.shape[0]))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    us = 2.0 * rng.normal(size=(T, ocp.nu))
    probs = tile_problem(ocp.problem, 1)
    sp = probs.stage_params
    act = sp.contact_active.clone()
    act[0, 0, 2] = 0.0
    sp = sp._replace(contact_active=act)
    lam_in = np.abs(rng.normal(size=(1, T, ocp.n_in)))
    t = torch.as_tensor
    solver = ProxDDPSolver(ocp, SolverSettings(u_scale="auto"))
    return (solver, sp, t(xs[None]), t(us[None]), torch.zeros((1, T, 0), dtype=torch.float64),
            t(lam_in), t(np.array([3e-2])))


def test_linearization_twin_meets_central_differences():
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.kernels import _lanes
    from simple_mpc_tpu_torch.ocp.base import tree_map

    T = 2
    solver, sp, xs, us, lam_eq, lam_in, mu = _lin_case(T, seed=17)
    lin = kernels.fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)

    space, ocp = solver.space, solver.ocp
    nv, nu, ndx = ocp.nv, ocp.nu, space.ndx
    ndir = ndx + nu
    su = torch.as_tensor(ocp.u_scale)[:, None]
    X, U, Xn = _lanes(xs[:, :-1]), _lanes(us), _lanes(xs[:, 1:])
    P, LE, LI = tree_map(_lanes, sp), _lanes(lam_eq), _lanes(lam_in)
    mu_l = mu.repeat_interleave(T)
    # every lane moved by +h and -h along every basis direction, at once
    E = FD_STEP * torch.eye(ndir, dtype=torch.float64)
    steps = torch.cat([E, -E], dim=0)  # (2 ndir, ndir)
    k = steps.shape[0]

    def rep(a):
        return a.repeat_interleave(k, dim=-1)

    D = steps.T.repeat(1, T)  # (ndir, T * 2 ndir), lane-major like rep
    Xp = space.integrate_parts_soa(rep(X), D[:nv], D[nv:ndx])
    r, w, _, _, xnext = solver._stage_bundle_soa(
        Xp, rep(U) + su * D[ndx:], tree_map(rep, P), rep(LE), rep(LI), rep(mu_l))
    gap = space.difference_soa(rep(Xn), xnext)
    r0, w0, _, _, xn0 = solver._stage_bundle_soa(X, U, P, LE, LI, mu_l)
    d0 = space.difference_soa(Xn, xn0)

    def jac(f):  # (rows, T * 2 ndir) -> (T, rows, ndir)
        f = f.reshape(f.shape[0], T, 2, ndir)
        return ((f[:, :, 0] - f[:, :, 1]) / (2 * FD_STEP)).permute(1, 0, 2)

    Jr, Jg = jac(r), jac(gap)
    ws = torch.sqrt(w0).T  # (T, rows)
    Jw = Jr * ws[..., None]
    grad = torch.einsum("tre,tr->te", Jw, ws * r0.T)
    H = Jw.mT @ Jw
    fd = dict(A=Jg[..., :ndx], B=Jg[..., ndx:], d=d0.T, qx=grad[:, :ndx], qu=grad[:, ndx:],
              Qxx=H[:, :ndx, :ndx], Quu=H[:, ndx:, ndx:], Qux=H[:, ndx:, :ndx])
    worst = {}
    for key, ref in fd.items():
        got = lin[key][0]
        worst[key] = float((got - ref).abs().max() / max(1.0, float(got.abs().max())))
    # readings (f64, this case): A 9.0e-9, qx 3.5e-9, Qux 3.3e-9, Qxx 2.8e-9,
    # B 1.9e-11
    assert max(worst.values()) < FD_TOL, worst


# ---------------------------------------------------------------------------
# The host MPC on full dynamics
# ---------------------------------------------------------------------------


def test_host_mpc_ticks_and_contact_forces():
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    T = 4
    ocp, mh, _ = make_go2_fulldynamics(T, device="cpu")
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, max_iters=1, T_fly=2, T_contact=2,
                          swing_apex=0.05, init_max_iters=1), ocp)
    feet = mh.feet_names
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    mpc.generate_cycle_horizon([ds] * 2 + [pair_a] * 2 + [ds] * 2 + [pair_b] * 2)
    # the support force split over the active feet
    f_ref = mpc.cycle_horizon.f_ref
    np.testing.assert_allclose(f_ref[0, :, 2].numpy(), mh.mass * 9.81 / 4, rtol=1e-14)
    np.testing.assert_allclose(f_ref[3, :, 2].numpy(), [mh.mass * 9.81 / 2, 0, 0,
                                                        mh.mass * 9.81 / 2], rtol=1e-14)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
    for _ in range(2):
        res = mpc.iterate(mpc.xs[1])
        assert not mpc.diverged and bool(torch.isfinite(res.xs).all())
    f = mpc.get_contact_forces(0)
    assert f.shape == (4, 3) and bool(torch.isfinite(f).all())
    from simple_mpc_tpu_torch.ocp.base import index_params

    p0 = index_params(ocp.problem.stage_params, 0)
    _close(f, ocp.get_contact_forces(mpc.xs[0], mpc.us[0], p0), tol=0)
    _close(mpc.get_state_derivative(0)[ocp.nv:],
           ocp.state_derivative(mpc.xs[0], mpc.us[0], p0)[ocp.nv:], tol=0)


def test_f32_serial_riccati_from_zero_torque_fails_as_jax_does():
    """Why chip_smoke.py's fd_batched warm-starts from the quasistatic
    torques and not from the reference control (zero torque): on the f32
    linearization of that start (Go2 T=100 standing, 48 inequality rows, as
    fd_batched, mu = the f32 floor), the port's serial Riccati twin (K3) and
    JAX's own f32 `ProxDDPSolver._backward` turn non-finite at the same
    stages, the last ten; the same pass in f64 on the same inputs stays
    finite.  The failure is the f32 function's, not the port's."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    T, f32 = 100, torch.float32
    ocp, _, x0 = make_go2_fulldynamics(T, device="cpu", dtype=f32, force_cone=False)
    probs = tile_problem(ocp.problem, 1)
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6))
    xs = ocp._tensor(x0)[None, None].expand(1, T + 1, -1).clone()
    us = torch.zeros((1, T, ocp.nu), dtype=f32)
    assert float(ocp.get_reference_control(0).abs().max()) == 0.0
    eps = torch.finfo(f32).eps
    mu = torch.full((1,), eps ** 0.5, dtype=f32)
    lin = kernels.fd_stage_linearize(solver, probs.stage_params, xs, us,
                                     torch.zeros((1, T, 0), dtype=f32),
                                     torch.zeros((1, T, ocp.n_in), dtype=f32), mu)
    Vx, Vxx = kernels.term_linearize(solver, xs[:, -1], probs.term_params,
                                     torch.zeros((1, ocp.n_term_eq), dtype=f32), mu)
    reg = 50 * eps
    ks, _, _ = kernels.riccati_backward(lin, Vx, Vxx, reg)

    jmh = jconfigs.go2_handler()
    jocp = JOCP(jconfigs.go2_fulldynamics_config(jmh, force_cone=False), jmh)
    jocp.create_problem(jnp.asarray(x0), T, 3, -9.81, False)
    js = JSolver(jocp, JSettings(mu_init=1e-6))
    kj = np.asarray(jax.jit(js._backward)(
        {k: jnp.asarray(_np(v[0])) for k, v in lin.items()}, jnp.asarray(_np(Vx[0])),
        jnp.asarray(_np(Vxx[0])), jnp.float32(reg))[0])
    assert kj.dtype == np.float32
    bad_port = np.flatnonzero(~np.isfinite(_np(ks[0])).all(-1))
    bad_jax = np.flatnonzero(~np.isfinite(kj).all(-1))
    np.testing.assert_array_equal(bad_port, np.arange(10))
    np.testing.assert_array_equal(bad_jax, bad_port)
    ks64, _, _ = kernels.riccati_backward({k: v.double() for k, v in lin.items()},
                                          Vx.double(), Vxx.double(), reg)
    assert bool(torch.isfinite(ks64).all())


# ---------------------------------------------------------------------------
# Against the JAX solver (slow: its full-dynamics linearization compiles for
# minutes on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_linearization_twin_matches_jax():
    import jax

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import kernels

    T = 2
    solver, sp, xs, us, lam_eq, lam_in, mu = _lin_case(T, seed=19)
    jmh = jconfigs.go2_handler()
    jocp = JOCP(jconfigs.go2_fulldynamics_config(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 3, -9.81, False)
    jprob = jocp.problem
    jprob = type(jprob)(x0=jprob.x0, term_params=jprob.term_params,
                        stage_params=jprob.stage_params._replace(
                            contact_active=sp.contact_active[0].numpy()))
    js = JSolver(jocp, JSettings(u_scale="auto"))
    ref = jax.jit(lambda x, u, le, li, m: js._linearize_traj_soa(jprob, x, u, le, li, m))(
        xs[0].numpy(), us[0].numpy(), lam_eq[0].numpy(), lam_in[0].numpy(), float(mu[0]))
    lin = kernels.fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
    for k in kernels.LIN_KEYS:  # readings: A 1.7e-14, the others <= 8.3e-15
        _close(lin[k][0], np.asarray(ref[k]), tol=1e-9)


@pytest.mark.slow
def test_two_solver_iterations_match_jax():
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    T = 4
    jmh = jconfigs.go2_handler()
    jocp = JOCP(jconfigs.go2_fulldynamics_config(jmh), jmh)
    x0 = np.asarray(jmh.reference_state)
    jocp.create_problem(jnp.asarray(x0), T, 3, -9.81, False)
    xs = np.repeat(x0[None], T + 1, 0)
    us = np.zeros((T, jocp.nu))
    js = JSolver(jocp, JSettings(mu_init=1e-6, max_iters=2))
    jres = js.run(jocp.problem, jnp.asarray(xs), jnp.asarray(us))
    # the reference's own spread: the same run from a warm start moved by a
    # relative 1e-15
    noise = 1e-15 * np.random.default_rng(5).standard_normal(xs.shape)
    jres_n = js.run(jocp.problem, jnp.asarray(xs * (1 + noise)), jnp.asarray(us))
    tocp, _, _ = make_go2_fulldynamics(T, device="cpu")
    bs = BatchedSolver(ProxDDPSolver(tocp, SolverSettings(mu_init=1e-6, max_iters=2)))
    tres = bs.run(tile_problem(tocp.problem, 1), torch.as_tensor(xs[None]),
                  torch.as_tensor(us[None]))

    def rel(a, b):
        a, b = _np(a), np.asarray(b)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    # readings: port vs JAX xs 3.1e-10, us 1.9e-9; JAX's spread xs 2.8e-10,
    # us 4.2e-9
    for field in ("xs", "us"):
        spread = rel(getattr(jres_n, field), getattr(jres, field))
        err = rel(getattr(tres, field)[0], getattr(jres, field))
        assert err <= max(1e-9, 10 * spread), (field, err, spread)


@pytest.mark.slow
@pytest.mark.parametrize("joint_box", [True, False])
def test_pyramid_standing_problem_stalls_in_jax_as_in_the_port(joint_box):
    """The recipe of chip_smoke.py's fd_batched with the friction pyramids
    on: Go2 T=100 standing, warm-started from the standing state and the
    quasistatic torques, mu_init 1e-6, one-iteration calls each fed the last
    result.  The JAX solver and the port stall alike, far above fd_batched's
    gate of 1e-3 (see test_pyramids_exclude_rest_at_the_standing_posture
    for why), with the 24-row joint box and without it.  Port vs JAX: every
    call's prim_res and the last iterate within max(1e-9, 10x JAX's own
    spread under a relative 1e-15 change of its warm start), relative to
    max(1, |JAX|)."""
    import jax.numpy as jnp

    import chip_smoke
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP as TOCP
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    T, calls = 100, 6
    jmh, tmh = jconfigs.go2_handler(), tconfigs.go2_handler()
    jc, tc = jconfigs.go2_fulldynamics_config(jmh), tconfigs.go2_fulldynamics_config(tmh)
    jc["kinematics_limits"] = tc["kinematics_limits"] = joint_box
    jocp, tocp = JOCP(jc, jmh), TOCP(tc, tmh, "cpu")
    x0 = np.asarray(jmh.reference_state)
    jocp.create_problem(jnp.asarray(x0), T, 3, -9.81, False)
    tocp.create_problem(x0, T, 3, -9.81, False)
    assert tocp.n_in == jocp.n_in == (68 if joint_box else 44)
    xs0 = np.repeat(x0[None], T + 1, 0)
    us0 = np.repeat(chip_smoke.standing_torques(tocp, x0)[None], T, 0)
    zeros = (np.zeros((T, 0)), np.zeros((T, jocp.n_in)), np.zeros(jocp.n_term_eq))

    js = JSolver(jocp, JSettings(mu_init=1e-6, max_iters=1, alphas=chip_smoke.ALPHAS))

    def jax_calls(xs):
        xs, us, lams, prims = jnp.asarray(xs), jnp.asarray(us0), zeros, []
        for _ in range(calls):
            res = js.run(jocp.problem, xs, us, tuple(jnp.asarray(a) for a in lams))
            xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
            prims.append(float(res.prim_res))
        return np.asarray(xs), np.asarray(us), prims

    jxs, jus, jprims = jax_calls(xs0)
    noise = 1e-15 * np.random.default_rng(5).standard_normal(xs0.shape)
    nxs, nus, nprims = jax_calls(xs0 * (1 + noise))

    bs = BatchedSolver(ProxDDPSolver(tocp, SolverSettings(mu_init=1e-6, max_iters=1,
                                                          alphas=chip_smoke.ALPHAS)))
    probs = tile_problem(tocp.problem, 1)
    t = torch.as_tensor
    xs, us = t(xs0[None]), t(us0[None])
    lams, tprims = tuple(t(a[None]) for a in zeros), []
    for _ in range(calls):
        res = bs.run(probs, xs, us, lams)
        xs, us, lams = res.xs, res.us, (res.lam_eq, res.lam_in, res.lam_term)
        tprims.append(float(res.prim_res[0]))

    def rel(a, b):
        a, b = _np(a), np.asarray(b)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    readings = dict(prim=(rel(np.array(tprims), jprims), rel(np.array(nprims), jprims)),
                    xs=(rel(xs[0], jxs), rel(nxs, jxs)), us=(rel(us[0], jus), rel(nus, jus)))
    # readings (68 / 44 rows): prim 2.9e-7 / 1.9e-7, xs 3.3e-8 / 2.7e-8, us
    # 3.3e-8 / 3.6e-8; JAX's spread prim 3.4e-7, xs 2.6e-8, us 2.9e-8; both
    # stall at prim 4.06435 from the second call
    for name, (err, spread) in readings.items():
        assert err <= max(1e-9, 10 * spread), (name, readings)
    # stalled: the last calls accept no step and stay far above the gate
    assert jprims[-1] == jprims[-2] == jprims[-3] > 1.0
    assert tprims[-1] == tprims[-2] == tprims[-3] > 1.0


# ---------------------------------------------------------------------------
# The CUDA kernels against their twins (on the card)
# ---------------------------------------------------------------------------


def _kernel_case(dtype, nb, T, seed):
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, _, x0 = make_go2_fulldynamics(T, device="cuda", dtype=dtype)
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None, None], nb, 0).repeat(T + 1, 1)
    xs = xs + 0.03 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = 2.0 * rng.normal(size=(nb, T, ocp.nu))
    probs = tile_problem(ocp.problem, nb)
    act = probs.stage_params.contact_active.clone()
    act[:, ::3, 1] = 0.0
    sp = tree_map(torch.Tensor.contiguous, probs.stage_params._replace(contact_active=act))
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device="cuda")  # noqa: E731
    lam_in = t(np.abs(rng.normal(size=(nb, T, ocp.n_in))))
    mu = t(np.geomspace(1e-2, 1e-3, nb))
    xs_c = np.stack([xs, xs + 1e-3 * rng.normal(size=xs.shape)], 1)
    xs_c[..., 3:7] /= np.linalg.norm(xs_c[..., 3:7], axis=-1, keepdims=True)
    us_c = np.stack([us, us + rng.normal(size=us.shape)], 1)
    return ocp, sp, t(xs), t(us), t(np.zeros((nb, T, 0))), lam_in, mu, t(xs_c), t(us_c)


@pytest.mark.cuda
@pytest.mark.parametrize("u_scale", [None, "auto"])
def test_fd_kernels_match_twins_on_cuda(u_scale):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        ocp, sp, xs, us, le, li, mu, xs_c, us_c = _kernel_case(dtype, 2, 8, 5)
        solver = ProxDDPSolver(ocp, SolverSettings(u_scale=u_scale))
        nb, T = us.shape[:2]
        x = xs[:, :-1].reshape(nb * T, -1).contiguous()
        u = us.reshape(nb * T, -1).contiguous()
        p = tree_map(lambda a: a.reshape((nb * T,) + a.shape[2:]).contiguous(), sp)
        n = [k.launches for k in kernels.KERNELS]
        lin = kernels.fd_stage_linearize(solver, sp, xs, us, le, li, mu)
        ev = kernels.fd_stage_eval(solver, sp, xs_c, us_c, le, li, mu)
        dyn = kernels.fd_dynamics(ocp, x, u, p)
        launched = {k.__name__: k.launches - m for k, m in zip(kernels.KERNELS, n)
                    if k.launches != m}
        assert launched == dict(fd_stage_linearize=1, fd_stage_eval=1, fd_dynamics=1)
        with pytest.raises(ValueError, match="kinodynamics OCP"):
            kernels.stage_linearize(solver, sp, xs, us, le, li, mu)
        lin0 = kernels._linearize_traj_plain(solver, sp, xs, us, le, li, mu)
        ev0 = kernels._eval_traj_plain(solver, sp, xs_c, us_c, le, li, mu)
        dyn0 = kernels.fd_dynamics_plain(ocp, x, u, p)
        torch.cuda.synchronize()

        def rel(a, b):
            return float((a.double() - b.double()).abs().max()
                         / b.double().abs().max().clamp_min(1e-300))

        for k in lin0:
            assert rel(lin[k], lin0[k]) < tol, (dtype, k)
        for a, b in zip(ev, ev0):
            if b.numel():
                assert rel(a, b) < tol, dtype
        for a, b in zip(dyn, dyn0):
            assert rel(a, b) < tol, dtype


@pytest.mark.cuda
def test_fd_kernels_take_6d_contacts_on_the_wide_unit():
    """Go2 with 6D contacts goes to the wide unit (csrc/fulldyn_wide.cu):
    the three wrappers launch its kernels, within 1e-10 of their twins in
    f64 and ten times the f32 twin's own distance from the f64 twin in f32,
    on stages with one foot in contact (four 6D feet on 3-dof legs over-
    constrain the robot: the Delassus matrix is singular up to its proximal
    term).  Beyond the wide unit's limits the wrappers raise
    NotImplementedError: five 6D feet (30 contact rows), and by route more
    joints than WIDE_MAX_JOINTS or a force size other than 3 and 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from types import SimpleNamespace

    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import go2_fulldynamics_config, go2_handler
    from simple_mpc_tpu_torch.models.model import FREE, REVOLUTE
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    def go2_6d(dtype, extra=(), T=4):
        mh = go2_handler()
        for f in extra:
            mh.add_point_foot(f, "base")
        cfg = go2_fulldynamics_config(mh)
        cfg.update(force_size=6, w_forces=np.ones(6), w_frame=np.ones(6), force_cone=True,
                   Kp_correction=np.linspace(5.0, 30.0, 6),
                   Kd_correction=np.linspace(0.5, 4.0, 6))
        ocp = FullDynamicsOCP(cfg, mh, "cuda", dtype)
        ocp.create_problem(np.asarray(mh.reference_state), T, 6, -9.81, False)
        return ocp

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(1.0, float(b.double().abs().max())))

    nb, T = 2, 4
    runs = {}
    for dtype in (torch.float64, torch.float32):
        ocp = go2_6d(dtype)
        assert kernels.stage_route(ocp) == "wide" and ocp.n_in == 24 + 24 + 4 * 17
        rng = np.random.default_rng(5)
        x0 = np.asarray(ocp.model_handler.reference_state)
        xs = np.repeat(x0[None, None], nb, 0).repeat(T + 1, 1)
        xs = xs + 0.03 * rng.normal(size=xs.shape)
        xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
        us = 2.0 * rng.normal(size=(nb, T, ocp.nu))
        sp = tile_problem(ocp.problem, nb).stage_params
        act = torch.zeros_like(sp.contact_active)
        for t in range(T):
            act[:, t, t % 4] = 1.0  # one foot in contact a stage
        sp = tree_map(torch.Tensor.contiguous, sp._replace(contact_active=act))
        c = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device="cuda")  # noqa: E731
        le = c(np.zeros((nb, T, 0)))
        li = c(np.abs(rng.normal(size=(nb, T, ocp.n_in))))
        mu = c(np.geomspace(1e-2, 1e-3, nb))
        xs_c = np.stack([xs, xs + 1e-3 * rng.normal(size=xs.shape)], 1)
        xs_c[..., 3:7] /= np.linalg.norm(xs_c[..., 3:7], axis=-1, keepdims=True)
        us_c = np.stack([us, us + rng.normal(size=us.shape)], 1)
        xs, us, xs_c, us_c = c(xs), c(us), c(xs_c), c(us_c)
        solver = ProxDDPSolver(ocp, SolverSettings())
        x = xs[:, :-1].reshape(nb * T, -1).contiguous()
        u = us.reshape(nb * T, -1).contiguous()
        p = tree_map(lambda a: a.reshape((nb * T,) + a.shape[2:]).contiguous(), sp)
        n = [k.launches for k in kernels.KERNELS]
        got = (list(kernels.fd_stage_linearize(solver, sp, xs, us, le, li, mu).values())
               + list(kernels.fd_stage_eval(solver, sp, xs_c, us_c, le, li, mu))
               + list(kernels.fd_dynamics(ocp, x, u, p)))
        launched = {k.__name__: k.launches - m for k, m in zip(kernels.KERNELS, n)
                    if k.launches != m}
        assert launched == dict(wide_fd_stage_linearize=1, wide_fd_stage_eval=1,
                                wide_fd_dynamics=1)
        assert got[-1].shape == (nb * T, 4, 6)

        def twins(f):
            spc = tree_map(f, sp)
            return (list(kernels._linearize_traj_plain(
                        solver, spc, f(xs), f(us), f(le), f(li), f(mu)).values())
                    + list(kernels._eval_traj_plain(solver, spc, f(xs_c), f(us_c), f(le),
                                                    f(li), f(mu)))
                    + list(kernels.fd_dynamics_plain(ocp, f(x), f(u), tree_map(f, p))))

        runs[dtype] = (got, twins(lambda a: a), twins(torch.Tensor.double))
    got, twin, _ = runs[torch.float64]
    for a, b in zip(got, twin):
        if b.numel():
            assert rel(a, b) < 1e-10
    got, twin, twin64 = runs[torch.float32]
    for a, b, w in zip(got, twin, twin64):
        if b.numel():
            assert rel(a, w) <= 10 * rel(b, w) + 1e-7, (rel(a, w), rel(b, w))

    five = go2_6d(torch.float32, extra=("FL_calf",))
    x = five.problem.x0[None].contiguous()
    p = type(five.problem.stage_params)._make(a[:1] for a in five.problem.stage_params)
    with pytest.raises(NotImplementedError, match="at most 24 contact rows"):
        kernels.fd_dynamics(five, x, torch.zeros((1, five.nu), device="cuda"), p)

    def chain(nj, fs):
        model = SimpleNamespace(njoints=nj, joint_types=(FREE,) + (REVOLUTE,) * (nj - 1),
                                parents=tuple(range(-1, nj - 1)),
                                idx_q=(0,) + tuple(6 + j for j in range(1, nj)),
                                idx_v=(0,) + tuple(5 + j for j in range(1, nj)))
        return SimpleNamespace(model=model, nk=2, fs=fs, nv=nj + 5, nu=nj - 1,
                               full_dynamics=True)

    for ocp, what in ((chain(kernels.WIDE_MAX_JOINTS + 1, 6), "at most 32 joints"),
                      (chain(13, 4), "force size 3 or 6")):
        with pytest.raises(NotImplementedError, match=what):
            kernels.stage_route(ocp)
