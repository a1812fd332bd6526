"""PyTorch port vs JAX package: K4 after the rollout, the candidates' Lie
integrate and the line search with the BCL update, f64 CPU.

Four problems: Go2 kinodynamics T=8, the same with the terminal DCM
constraint on (n_term_eq = 3), Go2 full dynamics T=6 and Talos kinodynamics
T=6.  Each has NB=4 scenarios and the five step sizes of the batched cells,
with inputs made from a numpy seed: perturbed iterates, rollout steps,
multipliers, and the stage costs, g, h and gaps K1 would hand the line
search.  Each scenario plays one role:
  0: plain; dual residual 1 (> omega): the BCL "neither" branch;
  1: candidate 1 NaN-poisoned (one stage cost NaN) and otherwise the
     cheapest; dual residual 0: "ok";
  2: candidates 1 and 3 tie exactly at the minimum (the same costs, gaps,
     initial and terminal states; other controls), gaps of ~1 at mu at
     its floor: "fail";
  3: every candidate NaN: index 0, merit +inf; "neither".

`candidate_integrate_plain` is held to `_candidate`'s integrate
(`jax.vmap(space.integrate)` and the u_scale chain back, JAX
proxddp.py:470-475), also with a `u_scale="auto"` solver.
`line_search_select_plain` is held to the JAX solver's own iteration
(`_run_impl`, :498-600, vmapped over the scenarios) for one iteration, with
its linearization, backward pass, rollout and stage evaluation stubbed to
hand it these candidates, their stage costs, g, h, gaps and dual
residual: the JAX code of `_term_al_cost`, `_merit_from`, `try_alpha`, the
argmin, the pick, prim, the BCL schedule and the multiplier updates runs
as it is.  Everything within 1e-12 of JAX relative to the largest entry;
the accepted step (read from which candidate's controls JAX returned)
identical.  eta and omega, which JAX keeps inside its loop, are held to
the schedule's formulas.

The `cuda` test holds the kernels (csrc/linesearch.cu, and
line_search_select's wide instance in csrc/linesearch_wide.cu) to the twins
on the card on the same cases.
"""
import math

import numpy as np
import pytest
import torch

NB = 4
ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.1)
TOL = 1e-12
CASES = ("go2", "go2_term", "fd", "talos")
FIELDS = ("xs", "us", "merit", "prim", "lam_eq", "lam_in", "lam_term", "mu", "dx0")
MU = (1e-3, 1e-2, 1e-8, 1e-4)  # per role; 1e-8 is below the f64 floor
DUAL = (1.0, 0.0, 0.0, 1.0)


def _np(a):
    return a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    """max|a - b| / max|b| over the finite entries of b, which must be
    finite where a is; non-finite entries must be equal."""
    a, b = _np(a), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if not fin.any():
        return 0.0
    return float(np.abs(a[fin] - b[fin]).max() / max(np.abs(b[fin]).max(), 1e-300))


def _port_ocp(name, device, dtype=torch.float64):
    """(port OCP, T) of a case, built on `device` in `dtype`."""
    from simple_mpc_tpu_torch import configs

    if name in ("go2", "go2_term"):
        ocp, _, x0 = configs.make_go2_kinodynamics(8, device=device, dtype=dtype)
        if name == "go2_term":
            ocp.create_problem(x0, 8, 3, -9.81, True)
        return ocp, 8
    if name == "fd":
        return configs.make_go2_fulldynamics(6, device=device, dtype=dtype)[0], 6
    return configs.make_talos_kinodynamics(6, device=device, dtype=dtype)[0], 6


def _make(ocp, T, seed):
    """A case's inputs as numpy arrays (see the module docstring), on a
    CPU f64 OCP; the candidates are the twin's integrate of the steps."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    rng = np.random.default_rng(seed)
    x0 = ocp.problem.x0.double().cpu().numpy()
    nx, ndx, nu, na = x0.shape[0], 2 * ocp.nv, ocp.nu, len(ALPHAS)
    xs = x0 + 0.02 * rng.normal(size=(NB, T + 1, nx))
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = ocp.problem.stage_params.u_ref[0].double().cpu().numpy()
    us = u0 + np.where(np.abs(u0) > 1.0, 20.0, 1.0) * rng.normal(size=(NB, T, nu))
    dxs = 0.03 * rng.normal(size=(NB, na, T + 1, ndx))
    dus = rng.normal(size=(NB, na, T, nu))
    cx, cu = kernels.candidate_integrate_plain(
        ProxDDPSolver(ocp, SolverSettings(alphas=ALPHAS)),
        *(torch.as_tensor(a) for a in (xs, us, dxs, dus)))
    cx, cu = cx.numpy(), cu.numpy()
    n_eq, n_in, n_te = ocp.n_eq, ocp.n_in, ocp.n_term_eq
    costs = 10.0 * rng.uniform(size=(NB, na, T))
    g = 0.01 * rng.normal(size=(NB, na, T, n_eq))
    h = 0.01 * rng.normal(size=(NB, na, T, n_in))
    gap = 0.01 * rng.normal(size=(NB, na, T, ndx))
    # role 1: candidate 1 the cheapest, then poisoned
    costs[1, 1] *= 0.01
    costs[1, 1, T // 2] = np.nan
    # role 2: candidates 1 and 3 tie at the minimum; gaps of ~1
    gap[2] = 100.0 * gap[2, 1]
    gap[2, 1] *= 0.5
    gap[2, 3] = gap[2, 1]
    costs[2, 3] = costs[2, 1]
    # role 3: every candidate NaN
    costs[3, :, 0] = np.nan
    lams = (0.1 * rng.normal(size=(NB, T, n_eq)), 0.1 * np.abs(rng.normal(size=(NB, T, n_in))),
            0.1 * rng.normal(size=(NB, n_te)))
    return dict(xs=xs, us=us, dxs=dxs, dus=dus, cx=cx, cu=cu, costs=costs, g=g, h=h,
                gap=gap, lams=lams, x0=x0, mu=np.array(MU), dual=np.array(DUAL))


def _tie(d, T):
    """Role 2's tie: candidate 3 starts and ends where candidate 1 does."""
    for k in (0, T):
        d["cx"][2, 3, k] = d["cx"][2, 1, k]
    return d


def _port_select(solver, d, device="cpu", dtype=torch.float64, fn=None):
    """The port's line search (the twin, or `fn`) on a case's arrays, with
    the state entering the first iteration of `run`: mu at its floor, eta
    from mu, omega unset."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.parallel import tile_problem

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    st = solver.settings
    na = len(ALPHAS)
    probs = tile_problem(solver.ocp.problem, NB)
    mu = torch.clamp(t(d["mu"]), min=math.sqrt(torch.finfo(dtype).eps))
    eta = torch.clamp(mu ** st.bcl_alpha, min=float(st.tol))
    omega = torch.full((NB,), -1.0, dtype=dtype, device=device)

    def flat(a):
        return t(a).reshape((NB * na,) + a.shape[2:])

    fn = fn or kernels.line_search_select_plain
    return fn(solver, t(d["cx"]), t(d["cu"]), flat(d["costs"]), flat(d["g"]),
              flat(d["h"]), flat(d["gap"]), probs.term_params, probs.x0,
              *(t(a) for a in d["lams"]), mu, eta, omega, t(d["dual"]),
              torch.as_tensor(ALPHAS, dtype=dtype, device=device))


def _jax_case(name):
    """The JAX OCP of a case (T as `_port_ocp`)."""
    import jax.numpy as jnp

    from simple_mpc_tpu import configs

    if name in ("go2", "go2_term"):
        ocp, mh, x0 = configs.make_go2_kinodynamics(8)
        if name == "go2_term":
            ocp.create_problem(x0, 8, 3, -9.81, True)
        return ocp
    if name == "fd":
        from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP

        mh = configs.go2_handler()
        ocp = FullDynamicsOCP(configs.go2_fulldynamics_config(mh), mh)
        ocp.create_problem(jnp.asarray(mh.reference_state), 6, 3, -9.81, False)
        return ocp
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP

    mh = configs.talos_handler()
    ocp = KinodynamicsOCP(configs.talos_kinodynamics_config(mh), mh)
    ocp.create_problem(np.asarray(mh.reference_state), 6, 6, -9.81, False)
    return ocp


def _jax_iteration(jsolver, nu, ndx):
    """One iteration of the JAX solver's `_run_impl`, vmapped over the
    scenarios, with the stages before the line search stubbed: the
    linearization and terminal expansion return nothing, the backward pass
    zero gains and the given dual residual, the rollout the given
    candidate of each step size (found from its alpha; the step sizes are
    distinct) and the stage evaluation its given costs, g, h and gaps."""
    import jax
    import jax.numpy as jnp

    al = jnp.asarray(jsolver.settings.alphas)

    def one(prob, xs, us, lams, mu, cx, cu, costs, g, h, gap, dual):
        T = us.shape[0]
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
            _backward=lambda *a: (jnp.zeros((T, nu)), jnp.zeros((T, nu, ndx)), dual),
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
def cases():
    """Per case: the port's results, JAX's, and the inputs."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.parallel import tile_problem as jtile
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.convert import problem_from_numpy
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    out = {}
    for seed, name in enumerate(CASES):
        jocp = _jax_case(name)
        tocp, T = _port_ocp(name, "cpu")
        jp = jocp.problem
        tocp.problem = problem_from_numpy(tocp, jp.stage_params, jp.term_params, jp.x0, "cpu")
        d = _tie(_make(tocp, T, seed), T)
        tsolver = ProxDDPSolver(tocp, SolverSettings(alphas=ALPHAS))
        port = _port_select(tsolver, d)
        jsolver = JSolver(jocp, JSettings(alphas=ALPHAS, scan_unroll=1))
        ndx, nu = 2 * tocp.nv, tocp.nu
        jres = _jax_iteration(jsolver, nu, ndx)(
            jtile(jp, NB), jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
            tuple(map(jnp.asarray, d["lams"])), jnp.asarray(d["mu"]),
            *(jnp.asarray(d[k]) for k in ("cx", "cu", "costs", "g", "h", "gap", "dual")))
        jres = jax.tree_util.tree_map(np.asarray, jres)
        # the step JAX accepted: the candidate whose controls it returned
        best = np.array([next(a for a in range(len(ALPHAS))
                              if np.array_equal(d["cu"][b, a], jres.us[b]))
                         for b in range(NB)])
        jdx0 = np.asarray(jax.vmap(jsolver.space.difference)(
            jnp.asarray(jres.xs[:, 0]), jnp.asarray(np.repeat(jp.x0[None], NB, 0))))
        ref = dict(xs=jres.xs, us=jres.us, merit=jres.merit, prim=jres.prim_res,
                   lam_eq=jres.lam_eq, lam_in=jres.lam_in, lam_term=jres.lam_term,
                   mu=jres.mu, dx0=jdx0, best=best)
        # the integrate against `_candidate`'s, with and without u_scale
        integ = {}
        for u_scale in (None, "auto"):
            js = JSolver(jocp, JSettings(alphas=ALPHAS, u_scale=u_scale))
            ts = ProxDDPSolver(tocp, SolverSettings(alphas=ALPHAS, u_scale=u_scale))
            nx = d["xs"].shape[-1]
            xr = np.broadcast_to(d["xs"][:, None], d["dxs"].shape[:3] + (nx,))
            jx = np.asarray(jax.jit(jax.vmap(js.space.integrate))(
                jnp.asarray(xr.reshape(-1, nx)), jnp.asarray(d["dxs"].reshape(-1, ndx))))
            dus = d["dus"] if js._u_scale is None else d["dus"] * js._u_scale
            got = kernels.candidate_integrate(
                ts, *(torch.as_tensor(d[k]) for k in ("xs", "us", "dxs", "dus")))
            integ[u_scale] = (got, (jx.reshape(xr.shape), d["us"][:, None] + dus))
        out[name] = dict(port=port, ref=ref, d=d, solver=tsolver, integ=integ)
    return out


@pytest.mark.parametrize("u_scale", [None, "auto"])
@pytest.mark.parametrize("name", CASES)
def test_candidate_integrate_matches_jax(cases, name, u_scale):
    (xs_c, us_c), (jxs, jus) = cases[name]["integ"][u_scale]
    assert _rel(xs_c, jxs) < TOL
    assert _rel(us_c, jus) < TOL


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", CASES)
def test_line_search_select_matches_jax(cases, name, field):
    c = cases[name]
    assert _rel(getattr(c["port"], field), c["ref"][field]) < TOL


@pytest.mark.parametrize("name", CASES)
def test_same_accepted_step_and_edge_cases(cases, name):
    c = cases[name]
    best = np.array([ALPHAS.index(a) for a in _np(c["port"].alpha)])
    np.testing.assert_array_equal(best, c["ref"]["best"])
    # a NaN-poisoned candidate never wins; the first of a tie wins; an
    # all-NaN scenario picks index 0 with an infinite merit
    assert best[1] != 1 and best[2] == 1 and best[3] == 0
    merit = _np(c["port"].merit)
    assert np.isfinite(merit[:3]).all() and merit[3] == np.inf


@pytest.mark.parametrize("name", CASES)
def test_bcl_branches(cases, name):
    """Roles 0 and 3 "neither", 1 "ok", 2 "fail", with the schedule's
    eta, omega and mu (JAX proxddp.py:565-596)."""
    c = cases[name]
    st = c["solver"].settings
    p = c["port"]
    floor = math.sqrt(np.finfo(np.float64).eps)
    mu = np.maximum(np.array(MU), floor)
    eta = np.maximum(mu ** st.bcl_alpha, st.tol)
    omega = np.maximum(np.array(DUAL) * st.bcl_omega_init, st.tol)
    prim = _np(p.prim)
    assert prim[1] <= eta[1] and prim[2] > eta[2]
    want_mu = mu.copy()
    want_mu[2] = max(mu[2] * st.bcl_mu_factor, floor)
    want_eta = eta.copy()
    want_eta[1] = max(eta[1] * st.bcl_eta_shrink, st.tol)
    want_eta[2] = max(want_mu[2] ** st.bcl_alpha, st.tol)
    want_omega = omega.copy()
    want_omega[1] = max(omega[1] * st.bcl_omega_shrink, st.tol)
    want_omega[2] = omega[2] / st.bcl_mu_factor
    np.testing.assert_allclose(_np(p.mu), want_mu, rtol=1e-15)
    np.testing.assert_allclose(_np(p.eta), want_eta, rtol=1e-14)
    np.testing.assert_allclose(_np(p.omega), want_omega, rtol=1e-15)
    # the multipliers move only where the schedule said ok
    lam_eq = c["d"]["lams"][0]
    moved = [not np.array_equal(_np(p.lam_eq)[b], lam_eq[b]) for b in range(NB)]
    assert moved == [False, True, False, False] or lam_eq.shape[-1] == 0


def test_state_difference_and_twins_count_no_launch():
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, _ = _port_ocp("go2", "cpu")
    solver = ProxDDPSolver(ocp, SolverSettings(alphas=ALPHAS))
    d = _tie(_make(ocp, 8, 0), 8)
    before = {k.__name__: k.launches for k in kernels.KERNELS}
    x1 = torch.as_tensor(d["xs"][:, 0])
    x2 = ocp.problem.x0[None].expand(NB, -1)
    assert torch.equal(kernels.state_difference(solver, x1, x2),
                       solver.space.difference(x1, x2))
    _port_select(solver, d, fn=kernels.line_search_select)
    kernels.candidate_integrate(solver, *(torch.as_tensor(d[k])
                                          for k in ("xs", "us", "dxs", "dus")))
    assert {k.__name__: k.launches for k in kernels.KERNELS} == before


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda():
    """The three kernels against their twins on the card, f64 within 1e-10
    with identical picks, f32 finite with identical picks and the BCL
    schedule within 1e-6 of the f32 twin's, on the four cases
    (line_search_select's wide instance on Talos)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    for seed, name in enumerate(CASES):
        cpu_ocp, T = _port_ocp(name, "cpu")
        d = _tie(_make(cpu_ocp, T, seed), T)
        for dtype in (torch.float64, torch.float32):
            ocp = _port_ocp(name, "cuda", dtype)[0]
            solver = ProxDDPSolver(ocp, SolverSettings(alphas=ALPHAS, u_scale="auto"))
            wide = kernels._ls_route(ocp) == "wide"
            sel = kernels.wide_line_search_select if wide else kernels.line_search_select
            n0 = sel.launches
            got = _port_select(solver, d, "cuda", dtype, fn=kernels.line_search_select)
            want = _port_select(solver, d, "cuda", dtype)
            assert sel.launches == n0 + 1
            torch.testing.assert_close(got.alpha, want.alpha, rtol=0, atol=0)
            ints = [torch.as_tensor(d[k], dtype=dtype, device="cuda")
                    for k in ("xs", "us", "dxs", "dus")]
            ci = kernels.candidate_integrate(solver, *ints)
            ci0 = kernels.candidate_integrate_plain(solver, *ints)
            x1, x2 = ints[0][:, 0], ocp.problem.x0[None].expand(NB, -1)
            sd = kernels.state_difference(solver, x1, x2)
            sd0 = solver.space.difference(x1, x2)
            if dtype == torch.float64:
                for f in got._fields:
                    assert _rel(getattr(got, f), _np(getattr(want, f))) < 1e-10, (name, f)
                for a, b in zip(ci + (sd,), ci0 + (sd0,)):
                    assert _rel(a, _np(b)) < 1e-10, name
            else:
                assert all(torch.isfinite(a).all() for a in (got.xs, got.us, got.prim))
                # the schedule in f32 (its mu floor sqrt(eps) of f32): a few
                # f32 operations apart from the twin's, pow within 2 ulp
                for f in ("mu", "eta", "omega"):
                    torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-6,
                                               atol=0, msg=f"{name} {f}")
