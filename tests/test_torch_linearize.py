"""PyTorch port vs JAX package: the stage kernels' twins on the branches the
CUDA kernels support beyond the flagship configuration.

Go2 kinodynamics T=5 with friction pyramids, land-height equalities, the
terminal DCM equality and control scaling (`u_scale="auto"`), two scenarios
with distinct perturbed iterates, multipliers and penalties, f64:
  * K1+K2 (`kernels.stage_linearize`) and K5 (`kernels.term_linearize`)
    against the JAX package's `_linearize_traj_soa` / `_linearize_term`;
  * K1 on the candidates (`kernels.stage_eval`) against `_eval_traj`.
Tolerance 1e-10 relative to the largest entry (float64 roundoff of the
forward tangents and the Gauss-Newton sums, taken in another order).

The `cuda`-marked test holds the CUDA kernels to their twins on the card
in both configurations (flagship and this one); it needs no JAX (run it
there with `python -m pytest --noconftest -m cuda tests/test_torch_linearize.py`).
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 5
NB = 2
NA = 3
TOL = 1e-10
MU = (1e-2, 3e-3)


def _rel(a, b):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().double().cpu().numpy() if torch.is_tensor(b) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _variant_ocp(T, dtype=torch.float64, device="cpu"):
    """Go2 kinodynamics with cones, land rows and the terminal constraint;
    a few stages have a foot off the ground and land flags set."""
    from simple_mpc_tpu_torch.configs import go2_handler, go2_kinodynamics_config
    from simple_mpc_tpu_torch.ocp.base import Problem
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP

    mh = go2_handler()
    cfg = go2_kinodynamics_config(mh)
    cfg.update(force_cone=True, land_cstr=True)
    ocp = KinodynamicsOCP(cfg, mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 3, -9.81, True)
    sp = ocp.problem.stage_params
    land, act = sp.land.clone(), sp.contact_active.clone()
    land[1::2, :2] = 1.0
    act[::3, 1] = 0.0
    ocp.problem = Problem(x0=ocp.problem.x0, term_params=ocp.problem.term_params,
                          stage_params=sp._replace(land=land, contact_active=act))
    return ocp, mh, x0


def _iterate(rng, ocp, x0, nb, T, na=None):
    """Perturbed iterates, multipliers (and candidates when na is given)."""
    lead = (nb,) if na is None else (nb, na)
    xs = np.broadcast_to(x0, lead + (T + 1, x0.shape[0])).copy()
    xs = xs + 0.02 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = ocp.get_reference_control(0).double().cpu().numpy()
    us = np.broadcast_to(u0, lead + (T, u0.shape[0])) + rng.normal(size=lead + (T, ocp.nu))
    lam_eq = 0.1 * rng.normal(size=(nb, T, ocp.n_eq))
    lam_in = np.abs(0.1 * rng.normal(size=(nb, T, ocp.n_in)))
    lam_term = 0.1 * rng.normal(size=(nb, ocp.n_term_eq))
    return xs, us, lam_eq, lam_in, lam_term


@pytest.fixture(scope="module")
def case():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.configs import go2_handler as jhandler
    from simple_mpc_tpu.configs import go2_kinodynamics_config as jconfig
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.convert import problem_from_numpy
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    tocp, _, x0 = _variant_ocp(T)
    jmh = jhandler()
    cfg = jconfig(jmh)
    cfg.update(force_cone=True, land_cstr=True)
    jocp = JOCP(cfg, jmh)
    jocp.create_problem(x0, T, 3, -9.81, True)
    tsp = tocp.problem.stage_params
    jprob = dataclasses.replace(jocp.problem, stage_params=jocp.problem.stage_params._replace(
        land=jnp.asarray(tsp.land.numpy()), contact_active=jnp.asarray(tsp.contact_active.numpy())))
    js = JSolver(jocp, JSettings(u_scale="auto"))
    ts = ProxDDPSolver(tocp, SolverSettings(u_scale="auto"))

    rng = np.random.default_rng(21)
    xs, us, lam_eq, lam_in, lam_term = _iterate(rng, tocp, x0, NB, T)
    xs_c, us_c = _iterate(rng, tocp, x0, NB, T, NA)[:2]
    lin_j = jax.jit(lambda x, u, le, li, m: js._linearize_traj_soa(jprob, x, u, le, li, m))
    term_j = jax.jit(lambda x, lt, m: js._linearize_term(x, jprob.term_params, lt, m))
    eval_j = jax.jit(lambda x, u, le, li, m: js._eval_traj(jprob, x, u, le, li, m))
    ref = dict(lin=[], term=[], ev=[])
    for b in range(NB):
        ref["lin"].append({k: np.asarray(v) for k, v in
                           lin_j(xs[b], us[b], lam_eq[b], lam_in[b], MU[b]).items()})
        ref["term"].append([np.asarray(v) for v in term_j(xs[b, -1], lam_term[b], MU[b])])
        for a in range(NA):
            ref["ev"].append([np.asarray(v) for v in
                              eval_j(xs_c[b, a], us_c[b, a], lam_eq[b], lam_in[b], MU[b])])
    tprob = tile_problem(problem_from_numpy(tocp, jprob.stage_params, jprob.term_params,
                                            x0, "cpu"), NB)
    t = lambda a: torch.as_tensor(np.array(a, np.float64))  # noqa: E731
    return dict(ts=ts, tprob=tprob, xs=t(xs), us=t(us), lam_eq=t(lam_eq),
                lam_in=t(lam_in), lam_term=t(lam_term), mu=t(MU), xs_c=t(xs_c),
                us_c=t(us_c), ref=ref)


def test_variant_linearization_matches_jax(case):
    from simple_mpc_tpu_torch import kernels

    c = case
    lin = kernels.stage_linearize(c["ts"], c["tprob"].stage_params, c["xs"], c["us"],
                                  c["lam_eq"], c["lam_in"], c["mu"])
    for k in lin:
        ref = np.stack([r[k] for r in c["ref"]["lin"]])
        assert _rel(lin[k], ref) < TOL, k
    Vx, Vxx = kernels.term_linearize(c["ts"], c["xs"][:, -1], c["tprob"].term_params,
                                     c["lam_term"], c["mu"])
    assert _rel(Vx, np.stack([r[0] for r in c["ref"]["term"]])) < TOL
    assert _rel(Vxx, np.stack([r[1] for r in c["ref"]["term"]])) < TOL


@pytest.mark.parametrize("field", ["costs", "g", "h", "gap"])
def test_candidate_eval_matches_jax(case, field):
    from simple_mpc_tpu_torch import kernels

    c = case
    out = kernels.stage_eval(c["ts"], c["tprob"].stage_params, c["xs_c"], c["us_c"],
                             c["lam_eq"], c["lam_in"], c["mu"])
    i = ["costs", "g", "h", "gap"].index(field)
    ref = np.stack([r[i] for r in c["ref"]["ev"]])  # (NB*NA, T, ...)
    assert _rel(out[i], ref) < TOL


def test_cpu_tensors_reach_the_twins(case):
    """Every new wrapper takes its twin on CPU tensors and counts no
    launch."""
    from simple_mpc_tpu_torch import kernels

    c = case
    before = [k.launches for k in kernels.KERNELS]
    kernels.stage_linearize(c["ts"], c["tprob"].stage_params, c["xs"], c["us"],
                            c["lam_eq"], c["lam_in"], c["mu"])
    kernels.stage_eval(c["ts"], c["tprob"].stage_params, c["xs_c"], c["us_c"],
                       c["lam_eq"], c["lam_in"], c["mu"])
    kernels.term_linearize(c["ts"], c["xs"][:, -1], c["tprob"].term_params,
                           c["lam_term"], c["mu"])
    assert [k.launches for k in kernels.KERNELS] == before


def test_stage_kernels_refuse_6d_contacts():
    """The CUDA stage kernels take point feet only: a 6D-contact OCP is
    refused when its constants are packed (on the card: before any
    launch)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import go2_handler, go2_kinodynamics_config
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP

    mh = go2_handler()
    cfg = go2_kinodynamics_config(mh)
    cfg.update(force_size=6, w_u=np.ones(4 * 6 + mh.model.nv - 6))
    ocp = KinodynamicsOCP(cfg, mh, "cpu")
    ocp.create_problem(np.asarray(mh.reference_state), 2, 6, -9.81, False)
    with pytest.raises(NotImplementedError, match="point feet"):
        kernels._stage_consts(ocp, torch.float64, torch.device("cpu"))


def _kernel_case(ocp, x0, dtype, nb, seed):
    from simple_mpc_tpu_torch.parallel import tile_problem

    T_ = ocp.problem.horizon
    rng = np.random.default_rng(seed)
    xs, us, lam_eq, lam_in, lam_term = _iterate(rng, ocp, x0, nb, T_)
    xs_c, us_c = _iterate(rng, ocp, x0, nb, T_, NA)[:2]
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device="cuda")  # noqa: E731
    mu = t(np.geomspace(1e-2, 1e-3, nb))
    return (tile_problem(ocp.problem, nb), t(xs), t(us), t(lam_eq), t(lam_in),
            t(lam_term), mu, t(xs_c), t(us_c))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["go2", "variant"])
def test_stage_kernels_match_twins_on_cuda(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        if config == "go2":
            ocp, _, x0 = make_go2_kinodynamics(8, device="cuda", dtype=dtype)
            solver = ProxDDPSolver(ocp, SolverSettings())
        else:
            ocp, _, x0 = _variant_ocp(8, dtype, "cuda")
            solver = ProxDDPSolver(ocp, SolverSettings(u_scale="auto"))
        probs, xs, us, le, li, lt, mu, xs_c, us_c = _kernel_case(ocp, x0, dtype, 3, 5)
        sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
        tp = tree_map(torch.Tensor.contiguous, probs.term_params)
        n = [k.launches for k in kernels.KERNELS]
        lin = kernels.stage_linearize(solver, sp, xs, us, le, li, mu)
        ev = kernels.stage_eval(solver, sp, xs_c, us_c, le, li, mu)
        term = kernels.term_linearize(solver, xs[:, -1], tp, lt, mu)
        launched = {k.__name__: k.launches - m for k, m in zip(kernels.KERNELS, n)
                    if k.launches != m}
        assert launched == dict(stage_linearize=1, stage_eval=1, term_linearize=1)
        lin0 = kernels._linearize_traj_plain(solver, sp, xs, us, le, li, mu)
        ev0 = kernels._eval_traj_plain(solver, sp, xs_c, us_c, le, li, mu)
        term0 = kernels._linearize_term_plain(solver, xs[:, -1], tp, lt, mu)
        torch.cuda.synchronize()
        for k in lin0:
            assert _rel(lin[k], lin0[k]) < tol, (config, dtype, k)
        for a, b in zip(ev, ev0):
            assert _rel(a, b) < (tol if dtype == torch.float64 else 1e-5), (config, dtype)
        for a, b in zip(term, term0):
            assert _rel(a, b) < tol, (config, dtype)


@pytest.mark.cuda
def test_6d_contacts_raise_on_cuda():
    """The kernels of csrc/linearize.cu refuse 6D contacts before any
    launch; `stage_linearize` hands such an OCP to the wide kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import go2_handler, go2_kinodynamics_config
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver

    mh = go2_handler()
    cfg = go2_kinodynamics_config(mh)
    cfg.update(force_size=6, w_u=np.ones(4 * 6 + mh.model.nv - 6))
    ocp = KinodynamicsOCP(cfg, mh, "cuda", torch.float32)
    ocp.create_problem(np.asarray(mh.reference_state), 2, 6, -9.81, False)
    probs = tile_problem(ocp.problem, 1)
    xs = ocp.problem.x0[None, None].expand(1, 3, -1).contiguous()
    us = torch.zeros((1, 2, ocp.nu), device="cuda")
    lam = (torch.zeros((1, 2, ocp.n_eq), device="cuda"),
           torch.zeros((1, 2, ocp.n_in), device="cuda"))
    args = (ProxDDPSolver(ocp), probs.stage_params, xs, us, *lam, torch.ones(1, device="cuda"))
    with pytest.raises(NotImplementedError):
        kernels._linearize_cuda(*args)
    n = kernels.wide_stage_linearize.launches
    kernels.stage_linearize(*args)
    assert kernels.wide_stage_linearize.launches == n + 1
