"""PyTorch port vs JAX package: Talos centroidal (x = [com; h_lin; h_ang],
two quad feet with 6D wrenches or point forces), f64 CPU.

  * the stage's twins against the JAX solver's generic path at T=12, force
    size 6 and 3, on perturbed iterates, references, contacts and cone
    multipliers: `_linearize_traj_plain` against `_linearize_stage`
    (vmapped), `_eval_traj_plain` against `_eval_traj`,
    `_linearize_term_plain` against `_linearize_term`, within 1e-10
    relative to max(1, the largest entry);
  * the vector-space integrate and initial gap and the select twin
    against JAX's `_candidate` integrate and `_run_impl`'s merit, argmin,
    pick and BCL update (its stages before the line search stubbed, as
    tests/test_torch_line_search.py does), 1e-10;
  * JAX's `test_setters_roundtrip` cases and IndexError out of range;
  * two one-iteration batched calls (B=3) and three host-MPC ticks at
    T=20 with the example's gait and MPCSettings, against one JAX solver
    compile (the MPC's solver replaced by one wrapper, as
    tests/test_torch_talos_solver.py does, `init_max_iters=1` on both
    sides): max(1e-9, ten times JAX's own spread under a 1e-15 move of its
    warm start).
The `cuda` test holds the centroidal kernels to their twins on the card.
"""
import math

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 12
T_MPC = 20
NB = 3
TOL = 1e-10
FLOOR = 1e-9
ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.1)
SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.1, T_fly=80,
                T_contact=20, timestep=0.01, init_max_iters=1)
WALK = np.array([0.1, 0, 0, 0, 0, 0])
LIN = ("A", "B", "d", "qx", "qu", "Qxx", "Quu", "Qux")
FIELDS = ("xs", "us", "Ks", "lam_in", "mu", "prim_res")


def _np(a):
    return a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _err(a, b):
    a, b = _np(a), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _jax_ocp(nT, fs):
    from simple_mpc_tpu.configs import talos_centroidal_config, talos_handler
    from simple_mpc_tpu.models.handler import RobotDataHandler
    from simple_mpc_tpu.ocp.centroidal import CentroidalOCP

    mh = talos_handler()
    cfg = talos_centroidal_config(mh)
    cfg.update(force_size=fs, w_u=np.ones(mh.n_feet * fs) * 1e-4)
    ocp = CentroidalOCP(cfg, mh)
    x0 = np.asarray(RobotDataHandler(mh).get_centroidal_state())
    ocp.create_problem(x0, nT, fs, -9.81, False)
    return ocp, mh, x0


def _inputs(jocp, x0, seed):
    """Perturbed numpy inputs of one scenario: the iterate, the stage and
    terminal params (a foot lifted over stages 3-6), cone multipliers on
    half the rows, mu."""
    rng = np.random.default_rng(seed)
    sp = {k: np.array(v) for k, v in jocp.problem.stage_params._asdict().items()}
    tp = {k: np.array(v) for k, v in jocp.problem.term_params._asdict().items()}
    sp["contact_active"][3:7, 1] = 0.0
    sp["contact_pose"] += 0.02 * rng.standard_normal(sp["contact_pose"].shape)
    for k, s in (("com_ref", 0.1), ("linmom_ref", 1.0), ("angmom_ref", 1.0)):
        sp[k] = s * rng.standard_normal(sp[k].shape)
    tp["linmom_ref"], tp["angmom_ref"] = rng.standard_normal(3), rng.standard_normal(3)
    xs = x0 + np.concatenate([0.01 * rng.standard_normal((T + 1, 3)),
                              0.5 * rng.standard_normal((T + 1, 6))], -1)
    us = sp["u_ref"] + 5.0 * rng.standard_normal(sp["u_ref"].shape)
    lam_in = 10.0 * np.abs(rng.standard_normal((T, jocp.n_in)))
    lam_in[::2] = 0.0
    return dict(sp=sp, tp=tp, xs=xs, us=us, lam_in=lam_in, mu=1e-2)


@pytest.fixture(scope="module", params=[6, 3], ids=["fs6", "fs3"])
def stage(request):
    """The port's twins and JAX's generic path on the same inputs."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.ocp.base import Problem as JProblem
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_talos_centroidal
    from simple_mpc_tpu_torch.convert import _params
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    fs = request.param
    jocp, _, x0 = _jax_ocp(T, fs)
    d = _inputs(jocp, x0, fs)
    jsp = type(jocp.problem.stage_params)(**{k: jnp.asarray(v) for k, v in d["sp"].items()})
    jtp = type(jocp.problem.term_params)(**{k: jnp.asarray(v) for k, v in d["tp"].items()})
    js = JSolver(jocp, JSettings(max_iters=1))
    mu, le = d["mu"], jnp.zeros((T, 0))
    xs, us, li = jnp.asarray(d["xs"]), jnp.asarray(d["us"]), jnp.asarray(d["lam_in"])
    jlin = jax.jit(jax.vmap(lambda x, u, xn, p, l_i: js._linearize_stage(
        x, u, xn, p, jnp.zeros(0), l_i, mu)))(xs[:-1], us, xs[1:], jsp, li)
    jprob = JProblem(x0=jnp.asarray(x0), stage_params=jsp, term_params=jtp)
    jev = jax.jit(lambda a, b, c: js._eval_traj(jprob, a, b, le, c, mu))(xs, us, li)
    jterm = js._linearize_term(xs[-1], jtp, jnp.zeros(0), mu)

    tocp, _, tx0 = make_talos_centroidal(T, device="cpu", force_size=fs)
    ts = ProxDDPSolver(tocp, SolverSettings(max_iters=1))
    sp = _params(tocp.stage_params_type, {k: v[None] for k, v in d["sp"].items()}, "cpu",
                 torch.float64)
    tp = _params(tocp.term_params_type, {k: v[None] for k, v in d["tp"].items()}, "cpu",
                 torch.float64)

    def t(a):
        return torch.as_tensor(np.asarray(a))[None]

    tmu = torch.tensor([mu], dtype=torch.float64)
    tle = torch.zeros((1, T, 0), dtype=torch.float64)
    tlin = kernels._linearize_traj_plain(ts, sp, t(d["xs"]), t(d["us"]), tle, t(d["lam_in"]),
                                         tmu)
    tev = kernels._eval_traj_plain(ts, sp, t(d["xs"])[:, None], t(d["us"])[:, None], tle,
                                   t(d["lam_in"]), tmu)
    tterm = kernels._linearize_term_plain(ts, t(d["xs"][-1]), tp,
                                          torch.zeros((1, 0), dtype=torch.float64), tmu)
    return dict(jlin=jlin, tlin=tlin, jev=jev, tev=tev, jterm=jterm, tterm=tterm,
                x0=(x0, tx0), ocp=tocp)


def test_centroidal_state_and_sizes(stage):
    jx0, tx0 = stage["x0"]
    assert _err(tx0, jx0) < 1e-12
    ocp = stage["ocp"]
    assert (ocp.nu, ocp.n_eq, ocp.n_in, ocp.space.nx) == (
        2 * ocp.fs, 0, 2 * (17 if ocp.fs == 6 else 5), 9)


@pytest.mark.parametrize("key", LIN)
def test_linearize_twin_matches_jax(stage, key):
    assert _err(stage["tlin"][key][0], stage["jlin"][key]) < TOL


@pytest.mark.parametrize("i, key", list(enumerate(("costs", "g", "h", "gap"))))
def test_eval_twin_matches_jax(stage, i, key):
    assert _err(stage["tev"][i][0], stage["jev"][i]) < TOL


@pytest.mark.parametrize("i", [0, 1])
def test_term_twin_matches_jax(stage, i):
    assert _err(stage["tterm"][i][0], stage["jterm"][i]) < TOL


def _jax_iteration(jsolver, nu, ndx):
    """One iteration of the JAX solver's `_run_impl`, vmapped over the
    scenarios, its stages before the line search stubbed to hand it the
    given candidates (found from their step size), stage costs, g, h, gaps
    and dual residual (tests/test_torch_line_search.py)."""
    import jax
    import jax.numpy as jnp

    al = jnp.asarray(jsolver.settings.alphas)

    def one(prob, xs, us, lams, mu, cx, cu, costs, g, h, gap, dual):
        nT = us.shape[0]
        held = {}

        def candidate(xs_, us_, lin, ks, Ks, dx0, alpha):
            held["i"] = jnp.argmin(jnp.abs(al - alpha))
            return cx[held["i"]], cu[held["i"]]

        def evaluate(problem, xs_, us_, lam_eq, lam_in, mu_):
            i = held["i"]
            return costs[i], g[i], h[i], gap[i]

        stubs = dict(
            _linearize_traj_soa=lambda *a: {}, _linearize_stage=lambda *a: {},
            _linearize_term=lambda *a: (0.0, 0.0),
            _backward=lambda *a: (jnp.zeros((nT, nu)), jnp.zeros((nT, nu, ndx)), dual),
            _candidate=candidate, _eval_traj=evaluate)
        for k, f in stubs.items():
            setattr(jsolver, k, f)
        try:
            return jsolver._run_impl(prob, xs, us, lams, mu, 1)
        finally:
            for k in stubs:
                delattr(jsolver, k)

    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def select():
    """The vector-space integrate and gap and the select twin on NB=3
    scenarios (roles: plain with dual residual 1, "neither"; cheapest
    candidate NaN-poisoned with dual 0, "ok"; gaps of ~1 at the mu floor,
    "fail"), against JAX."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.parallel import tile_problem as jtile
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_talos_centroidal
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    jocp, _, x0 = _jax_ocp(T, 6)
    tocp = make_talos_centroidal(T, device="cpu")[0]
    rng = np.random.default_rng(9)
    na, nu = len(ALPHAS), tocp.nu
    xs = x0 + 0.05 * rng.standard_normal((NB, T + 1, 9))
    us = rng.standard_normal((NB, T, nu))
    dxs = 0.03 * rng.standard_normal((NB, na, T + 1, 9))
    dus = rng.standard_normal((NB, na, T, nu))
    ts = ProxDDPSolver(tocp, SolverSettings(alphas=ALPHAS))
    js = JSolver(jocp, JSettings(alphas=ALPHAS, scan_unroll=1))
    xt = torch.as_tensor
    cx, cu = kernels.candidate_integrate_plain(ts, xt(xs), xt(us), xt(dxs), xt(dus))
    jcx = np.asarray(jax.vmap(js.space.integrate)(
        jnp.asarray(np.broadcast_to(xs[:, None], dxs.shape).reshape(-1, 9)),
        jnp.asarray(dxs.reshape(-1, 9)))).reshape(dxs.shape)
    gap0 = kernels.state_difference_plain(ts, xt(xs[:, 0]), xt(np.repeat(x0[None], NB, 0)))
    jgap0 = np.asarray(jax.vmap(js.space.difference)(jnp.asarray(xs[:, 0]),
                                                      jnp.asarray(np.repeat(x0[None], NB, 0))))
    costs = 10.0 * rng.uniform(size=(NB, na, T))
    h = 0.01 * rng.standard_normal((NB, na, T, tocp.n_in))
    gap = 0.01 * rng.standard_normal((NB, na, T, 9))
    costs[1, 1] *= 0.01
    costs[1, 1, T // 2] = np.nan
    gap[2] = 100.0 * gap[2, 1]
    g = np.zeros((NB, na, T, 0))
    lam_in = 0.1 * np.abs(rng.standard_normal((NB, T, tocp.n_in)))
    mu = np.array([1e-3, 1e-2, 1e-8])
    dual = np.array([1.0, 0.0, 0.0])
    st = ts.settings
    tmu = torch.clamp(xt(mu), min=math.sqrt(np.finfo(np.float64).eps))
    probs = tile_problem(tocp.problem, NB)

    def flat(a):
        return xt(a).reshape((NB * na,) + a.shape[2:])

    port = kernels.line_search_select_plain(
        ts, cx, cu, flat(costs), flat(g), flat(h), flat(gap), probs.term_params, probs.x0,
        torch.zeros((NB, T, 0), dtype=torch.float64), xt(lam_in),
        torch.zeros((NB, 0), dtype=torch.float64), tmu,
        torch.clamp(tmu ** st.bcl_alpha, min=st.tol), torch.full((NB,), -1.0,
                                                                  dtype=torch.float64),
        xt(dual), torch.as_tensor(ALPHAS, dtype=torch.float64))
    jres = jax.tree_util.tree_map(np.asarray, _jax_iteration(js, nu, 9)(
        jtile(jocp.problem, NB), jnp.asarray(xs), jnp.asarray(us),
        (jnp.zeros((NB, T, 0)), jnp.asarray(lam_in), jnp.zeros((NB, 0))), jnp.asarray(mu),
        *(jnp.asarray(a) for a in (cx.numpy(), cu.numpy(), costs, g, h, gap, dual))))
    best = [next(a for a in range(na) if np.array_equal(cu[b, a].numpy(), jres.us[b]))
            for b in range(NB)]
    return dict(cx=(cx, jcx), cu=(cu, us[:, None] + dus), gap0=(gap0, jgap0), port=port,
                jres=jres, best=best)


@pytest.mark.parametrize("key", ["cx", "cu", "gap0"])
def test_vector_integrate_and_gap_match_jax(select, key):
    a, b = select[key]
    assert _err(a, b) < TOL


@pytest.mark.parametrize("field, jfield", [
    ("xs", "xs"), ("us", "us"), ("merit", "merit"), ("prim", "prim_res"),
    ("lam_in", "lam_in"), ("mu", "mu")])
def test_select_twin_matches_jax(select, field, jfield):
    assert _err(getattr(select["port"], field), getattr(select["jres"], jfield)) < TOL


def test_select_accepted_steps(select):
    best = [ALPHAS.index(a) for a in _np(select["port"].alpha)]
    assert best == select["best"]
    assert best[1] != 1  # the NaN-poisoned candidate never wins


def test_setters_roundtrip_and_index_error():
    """JAX tests/test_centroidal_solver.py::test_setters_roundtrip (the
    reference's tests/problem.cpp:249-285), and IndexError where the JAX
    package's `.at[]` drops an out-of-range stage."""
    from simple_mpc_tpu_torch.configs import make_talos_centroidal

    ocp = make_talos_centroidal(20, device="cpu")[0]
    l, r = "left_sole_link", "right_sole_link"
    pose = np.array([0.1, 0.2, 0.3])
    ocp.set_reference_pose(3, l, np.eye(3), pose)
    np.testing.assert_allclose(_np(ocp.get_reference_pose(3, l)[1]), pose)
    f = np.arange(6.0)
    ocp.set_reference_force(4, r, f)
    np.testing.assert_allclose(_np(ocp.get_reference_force(4, r)), f)
    v = np.arange(6.0) * 0.1
    ocp.set_velocity_base(5, v)
    np.testing.assert_allclose(_np(ocp.get_velocity_base(5)), v, atol=1e-12)
    c = np.array([0.0, 0.1, 0.9])
    ocp.set_pose_base(6, c)
    np.testing.assert_allclose(_np(ocp.get_pose_base(6)), c)
    xr = np.concatenate([c, v])
    ocp.set_reference_state(7, xr)
    np.testing.assert_allclose(_np(ocp.get_reference_state(7)), xr, atol=1e-12)
    assert ocp.get_contact_state(0) == [True, True]
    assert ocp.get_contact_support(0) == 2
    ocp.set_reference_forces(8, {l: f, r: 2 * f})
    np.testing.assert_allclose(_np(ocp.get_reference_control(8)), np.concatenate([f, 2 * f]))
    with pytest.raises(RuntimeError):
        ocp.compute_control_from_forces({l: f[:3], r: f[:3]})
    for call in (lambda: ocp.set_reference_pose(20, l, np.eye(3), pose),
                 lambda: ocp.set_reference_force(20, r, f),
                 lambda: ocp.set_velocity_base(20, v), lambda: ocp.set_pose_base(20, c),
                 lambda: ocp.set_reference_state(20, xr), lambda: ocp.get_pose_base(20),
                 lambda: ocp.get_reference_force(20, l)):
        with pytest.raises(IndexError):
            call()


def test_ode_dynamics_and_reference_writes_match_jax():
    """The single-state ODE and Euler step and the fused tick's pure
    reference write against JAX's (eager), and `x0_from_measurement`
    against the data handler's centroidal state at a moved state."""
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.configs import make_talos_centroidal
    from simple_mpc_tpu_torch.models.handler import RobotDataHandler

    jocp, _, x0 = _jax_ocp(4, 6)
    tocp, tmh, _ = make_talos_centroidal(4, device="cpu")
    rng = np.random.default_rng(12)
    d = _inputs(jocp, x0, 12)
    p = {k: v[3] for k, v in d["sp"].items()}
    jp = type(jocp.problem.stage_params)(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = type(tocp.problem.stage_params)(**{k: torch.as_tensor(v) for k, v in p.items()})
    x, u = d["xs"][3], d["us"][3]
    for f in ("ode", "dynamics"):
        want = np.asarray(getattr(jocp, f)(jnp.asarray(x), jnp.asarray(u), jp))
        assert _err(getattr(tocp, f)(torch.as_tensor(x), torch.as_tensor(u), tp), want) < TOL
    refs = dict(foot_refs=rng.standard_normal((4, 2, 3)), x_reference=rng.standard_normal(9),
                velocity_base=rng.standard_normal(6), com_ref=rng.standard_normal(3))
    jsp, jtp = jocp.write_references(jocp.problem.stage_params, jocp.problem.term_params,
                                     *(jnp.asarray(v) for v in refs.values()))
    tsp, ttp = tocp.write_references(tocp.problem.stage_params, tocp.problem.term_params,
                                     *(torch.as_tensor(v) for v in refs.values()))
    for a, b in zip(tuple(tsp) + tuple(ttp), tuple(jsp) + tuple(jtp)):
        assert _err(a, np.asarray(b)) < 1e-12
    m = tmh.model
    xm = np.asarray(tmh.reference_state).copy()
    xm[7: m.nq] += 0.1 * rng.standard_normal(m.nq - 7)
    xm[m.nq:] = rng.standard_normal(m.nv)
    dh = RobotDataHandler(tmh)
    dh.update(xm)
    assert _err(tocp.x0_from_measurement(torch.as_tensor(xm)), dh.get_centroidal_state()) < 1e-12


def _gait(feet):
    l, r = feet
    return ([{l: True, r: True}] * 20 + [{l: True, r: False}] * 80
            + [{l: True, r: True}] * 20 + [{l: False, r: True}] * 80)


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
            lams = (jnp.zeros((T_MPC, 0)), jnp.zeros((T_MPC, ocp.n_in)), jnp.zeros((0,)))
        if mu is None:
            mu = self.settings.mu_init
        return self.solver.run(problem, xs, us, lams, jnp.asarray(mu, jnp.float64))


@pytest.fixture(scope="module")
def engines():
    """The JAX MPC over one `_OneCompile` solver (T=20, the example's
    settings, first solve cut to one iteration) and the port's."""
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.examples.talos_centroidal import setup_mpc

    jocp, jmh, _ = _jax_ocp(T_MPC, 6)
    standing = jocp.problem
    shared = _OneCompile(JSolver(jocp, JSettings(tol=SETTINGS["TOL"],
                                                 mu_init=SETTINGS["mu_init"], max_iters=1,
                                                 scan_unroll=1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, settings: shared)
        jm = jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                     **SETTINGS), jocp)
    tm, tmh = setup_mpc(T_MPC, "cpu", torch.float64, **SETTINGS)
    return shared, jm, jmh, tm, standing


@pytest.fixture(scope="module")
def batched(engines):
    """Two one-iteration calls of the port's batched solver on NB=3
    perturbed scenarios of the standing problem, against JAX's solver on
    each scenario (and on its start moved by 1e-15)."""
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.parallel import BatchedSolver
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    shared, _, _, tm, standing = engines
    tocp = tm.ocp_handler
    rng = np.random.default_rng(4)
    x0 = np.asarray(standing.x0)
    xs = x0 + np.concatenate([0.01 * rng.standard_normal((NB, T_MPC + 1, 3)),
                              0.3 * rng.standard_normal((NB, T_MPC + 1, 6))], -1)
    us = np.asarray(standing.stage_params.u_ref) + 5.0 * rng.standard_normal(
        (NB, T_MPC, tocp.nu))
    noisy = xs * (1 + 1e-15 * rng.standard_normal(xs.shape))

    def jax_run(xs0):
        out = []
        for b in range(NB):
            st, runs = (jnp.asarray(xs0[b]), jnp.asarray(us[b]), None, None), []
            for _ in range(2):
                r = shared.run(standing, *st)
                runs.append({f: np.asarray(getattr(r, f)) for f in FIELDS})
                st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
            out.append(runs)
        return out

    from simple_mpc_tpu_torch.parallel import tile_problem

    bs = BatchedSolver(ProxDDPSolver(tocp, SolverSettings(tol=SETTINGS["TOL"],
                                                          mu_init=SETTINGS["mu_init"],
                                                          max_iters=1)))
    probs = tile_problem(tocp.problem, NB)
    st = (torch.as_tensor(xs), torch.as_tensor(us), None, None)
    port = []
    for _ in range(2):
        r = bs.solver.run(probs, *st)
        port.append({f: getattr(r, f) for f in FIELDS})
        st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
    return jax_run(xs), jax_run(noisy), port


@pytest.mark.parametrize("it", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_batched_iterations_match_jax(batched, it, field):
    ref, ref_n, port = batched
    for b in range(NB):
        tol = max(FLOOR, 10 * _err(ref_n[b][it][field], ref[b][it][field]))
        e = _err(port[it][field][b], ref[b][it][field])
        assert e < tol, (b, e, tol)


@pytest.fixture(scope="module")
def ticks(engines):
    """Three ticks of both MPCs (and of a copy of the JAX one whose warm
    start is moved by 1e-15) on the example's gait at 0.1 m/s, each
    measuring the reference state."""
    import copy

    import jax.numpy as jnp

    _, jm, jmh, tm, _ = engines
    for m in (jm, tm):
        m.generate_cycle_horizon(_gait(jmh.feet_names))
        m.switch_to_walk(WALK)
    jm2 = copy.deepcopy(jm, {id(jm.solver): jm.solver})
    xs0 = np.asarray(jm2.xs)
    jm2.xs = jnp.asarray(xs0 * (1 + 1e-15 * np.random.default_rng(6).standard_normal(
        xs0.shape)))
    x = np.asarray(jmh.reference_state)
    out = []
    for _ in range(3):
        jr, jr2, tr = jm.iterate(x), jm2.iterate(x), tm.iterate(x)
        out.append(dict(j=jr, j2=jr2, t=tr, sd=(np.asarray(jm.get_state_derivative(0)),
                                                tm.get_state_derivative(0)),
                        pose=(np.asarray(jm.ocp_handler.problem.stage_params.contact_pose),
                              tm.ocp_handler.problem.stage_params.contact_pose)))
    return out


@pytest.mark.parametrize("tick", range(3))
@pytest.mark.parametrize("field", ["xs", "us", "Ks"])
def test_mpc_ticks_match_jax(ticks, tick, field):
    d = ticks[tick]
    ref = np.asarray(getattr(d["j"], field))
    tol = max(FLOOR, 10 * _err(np.asarray(getattr(d["j2"], field)), ref))
    assert _err(getattr(d["t"], field), ref) < tol, (_err(getattr(d["t"], field), ref), tol)


@pytest.mark.parametrize("tick", range(3))
def test_mpc_references_and_derivative(ticks, tick):
    """The swing references and the state derivative (the 9-dim ODE at
    the plan's stage 0) follow JAX's."""
    d = ticks[tick]
    assert _err(d["pose"][1], d["pose"][0]) < 1e-12
    assert _err(d["sd"][1], d["sd"][0]) < max(FLOOR, 10 * _err(
        np.asarray(d["j2"].us), np.asarray(d["j"].us)))


def test_routes_and_entry_points():
    """On the card the centroidal OCP takes csrc/centroidal.cu's route;
    its entry points default to the card."""
    import inspect

    from simple_mpc_tpu_torch import configs, kernels
    from simple_mpc_tpu_torch.examples import talos_centroidal
    from simple_mpc_tpu_torch.id.centroidal_id import CentroidalID
    from simple_mpc_tpu_torch.ocp.centroidal import CentroidalOCP

    ocp = configs.make_talos_centroidal(4, device="cpu")[0]
    assert kernels.stage_route(ocp) == "centroidal"
    for fn in (configs.make_talos_centroidal, configs.talos_centroidal_mpc, CentroidalOCP,
               CentroidalID, talos_centroidal.setup, talos_centroidal.setup_mpc):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    ocp.fs, ocp.nu = 4, 8
    with pytest.raises(NotImplementedError):
        kernels.stage_route(ocp)


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Each centroidal kernel against its twin on the card, f64, 1e-10: the
    linearization, the candidates, K5, the ODE, the vector integrate and
    gap, and the select (chip_smoke.py `cent_iteration`, B=4, T=100)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    import chip_smoke

    dev = torch.device("cuda")
    ocp, runs = chip_smoke.cent_iteration(dev, torch.float64, 4)
    for name, (kern, twin, args) in runs.items():
        err = chip_smoke.cent_rel(kern(*args), twin(*args),
                                  name == "centroidal_line_search_select")
        assert err < 1e-10, (name, err)
