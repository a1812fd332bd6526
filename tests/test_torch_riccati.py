"""PyTorch port vs JAX package: the linearization (K1/K2), the Riccati
backward passes (K3, and K6 of `parallel=True`) and the linear rollout (K4)
of one ProxDDP iteration, Go2 kinodynamics T=8, two scenarios with
distinct perturbed iterates, f64.

The JAX side runs as the JAX tests run it (CPU, x64).  The K3/K4/K6 twins
take the JAX package's own linearization, carried across with
`convert.lin_from_numpy`, so each kernel's twin is held to its JAX
counterpart alone.  Tolerance 1e-10 relative to the largest entry for K3
and K4 (the Riccati pass solves 24x24 systems whose condition number
amplifies float64 roundoff by a few decades); 1e-9 for K6, whose scan
composes in another tree than `lax.associative_scan` and solves the
unscaled Quu + reg I, where Go2's 1e-5 joint-acceleration weights lie six
decades below the force weights.

`test_kernels_match_twins_on_cuda` holds the CUDA kernels to the twins on
the card; it needs no JAX (run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_riccati.py`).
"""
import numpy as np
import pytest
import torch

from simple_mpc_tpu_torch.testing import random_lq

T = 8
NB = 2
MU = 1e-2
TOL = 1e-10


def _rel(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _warm_start(rng, x0, u0, n_eq, n_in):
    xs = np.repeat(x0[None, None], NB, 0).repeat(T + 1, 1)
    xs = xs + 0.02 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = np.repeat(u0[None, None], NB, 0).repeat(T, 1)
    us = us + rng.normal(size=us.shape)
    lam_eq = 0.1 * rng.normal(size=(NB, T, n_eq))
    lam_in = np.abs(0.1 * rng.normal(size=(NB, T, n_in)))
    return xs, us, lam_eq, lam_in


@pytest.fixture(scope="module")
def case():
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.solver.parallel_riccati import parallel_backward
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.convert import problem_from_numpy
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    jocp, jmh, x0 = jconfigs.make_go2_kinodynamics(T)
    tocp, _, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    js = JSolver(jocp, JSettings())
    ts = ProxDDPSolver(tocp, SolverSettings())
    prob = jocp.problem
    rng = np.random.default_rng(11)
    xs, us, lam_eq, lam_in = _warm_start(
        rng, x0, np.asarray(prob.stage_params.u_ref[0]), jocp.n_eq, jocp.n_in)
    lam_term = np.zeros((NB, 0))

    lin_j = jax.jit(lambda x, u, le, li: js._linearize_traj_soa(prob, x, u, le, li, MU))
    term_j = jax.jit(lambda x: js._linearize_term(x, prob.term_params, jnp.zeros(0), MU))
    back_j = jax.jit(lambda lin, vx, vxx: js._backward(lin, vx, vxx, 1e-9))
    par_j = jax.jit(lambda lin, vx, vxx: parallel_backward(lin, vx, vxx, 1e-9))
    alphas = np.asarray(JSettings().alphas)
    cand_j = jax.jit(lambda x, u, lin, ks, Ks, dx0: jax.vmap(
        lambda a: js._candidate(x, u, lin, ks, Ks, dx0, a))(jnp.asarray(alphas)))
    ref = []
    for b in range(NB):
        lin = lin_j(xs[b], us[b], lam_eq[b], lam_in[b])
        vx, vxx = term_j(xs[b, -1])
        ks, Ks, dual = back_j(lin, vx, vxx)
        ks_p, Ks_p, dual_p = par_j(lin, vx, vxx)
        dx0 = js.space.difference(jnp.asarray(xs[b, 0]), prob.x0)
        xs_c, us_c = cand_j(xs[b], us[b], lin, ks, Ks, dx0)
        ref.append(dict(lin={k: np.asarray(v) for k, v in lin.items()},
                        Vx=np.asarray(vx), Vxx=np.asarray(vxx), ks=np.asarray(ks),
                        Ks=np.asarray(Ks), dual=float(dual), dx0=np.asarray(dx0),
                        ks_p=np.asarray(ks_p), Ks_p=np.asarray(Ks_p),
                        dual_p=float(dual_p),
                        xs_c=np.asarray(xs_c), us_c=np.asarray(us_c)))
    stack = {k: np.stack([r[k] for r in ref]) for k in ref[0] if k != "lin"}
    stack["lin"] = {k: np.stack([r["lin"][k] for r in ref]) for k in ref[0]["lin"]}
    tprob = tile_problem(problem_from_numpy(
        tocp, prob.stage_params, prob.term_params, x0, "cpu"), NB)
    t = lambda a: torch.as_tensor(np.array(a, np.float64))  # noqa: E731
    return dict(ts=ts, tprob=tprob, xs=t(xs), us=t(us), lam_eq=t(lam_eq),
                lam_in=t(lam_in), lam_term=t(lam_term), ref=stack, t=t,
                alphas=t(alphas))


def test_linearization_matches_jax(case):
    from simple_mpc_tpu_torch import kernels

    ts, c = case["ts"], case
    mu = torch.full((NB,), MU, dtype=torch.float64)
    lin = kernels.stage_linearize(ts, c["tprob"].stage_params, c["xs"], c["us"],
                                  c["lam_eq"], c["lam_in"], mu)
    for k, v in c["ref"]["lin"].items():
        assert _rel(lin[k], v) < TOL, k
    Vx, Vxx = kernels.term_linearize(ts, c["xs"][:, -1], c["tprob"].term_params,
                                     c["lam_term"], mu)
    assert _rel(Vx, c["ref"]["Vx"]) < TOL
    assert _rel(Vxx, c["ref"]["Vxx"]) < TOL


def test_riccati_twin_matches_jax_backward(case):
    from simple_mpc_tpu_torch import kernels

    r, t = case["ref"], case["t"]
    lin = {k: t(v) for k, v in r["lin"].items()}
    ks, Ks, dual = kernels.riccati_backward(lin, t(r["Vx"]), t(r["Vxx"]), 1e-9)
    assert _rel(ks, r["ks"]) < TOL
    assert _rel(Ks, r["Ks"]) < TOL
    assert _rel(dual, r["dual"]) < TOL


def test_parallel_twin_matches_jax_on_go2(case):
    """K6's twin on the Go2 linearization (measured: ks 1.1e-13, Ks 2.6e-13,
    dual 1.7e-14 relative; K6 and K3 differ by 1e-5 on these data, as they
    regularize differently)."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.convert import lin_from_numpy

    r, t = case["ref"], case["t"]
    ks, Ks, dual = kernels.parallel_riccati_backward(
        lin_from_numpy(r["lin"], "cpu"), t(r["Vx"]), t(r["Vxx"]), 1e-9)
    assert _rel(ks, r["ks_p"]) < 1e-9
    assert _rel(Ks, r["Ks_p"]) < 1e-9
    assert _rel(dual, r["dual_p"]) < 1e-9


def test_rollout_twin_matches_jax_candidate(case):
    r, t, ts = case["ref"], case["t"], case["ts"]
    lin = {k: t(v) for k, v in r["lin"].items()}
    xs_c, us_c = ts._candidates(case["xs"], case["us"], lin, t(r["ks"]),
                                t(r["Ks"]), t(r["dx0"]), case["alphas"])
    assert _rel(xs_c, r["xs_c"]) < TOL
    assert _rel(us_c, r["us_c"]) < TOL


def test_twins_on_cpu_tensors_never_count_launches():
    from simple_mpc_tpu_torch import kernels

    lin, Vx, Vxx, dx0 = random_lq(2, 3, 36, 24, torch.float64, "cpu")
    n3, n4 = kernels.riccati_backward.launches, kernels.linear_rollout.launches
    ks, Ks, dual = kernels.riccati_backward(lin, Vx, Vxx, 1e-9)
    alphas = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float64)
    dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks, Ks, dx0, alphas)
    assert dxs.shape == (2, 3, 4, 36) and dus.shape == (2, 3, 3, 24)
    assert (kernels.riccati_backward.launches, kernels.linear_rollout.launches) == (n3, n4)
    # alpha = 0 rolls out the pure feedback response from dx0
    assert torch.equal(dxs[:, 0, 0], dx0)


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels

    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        lin, Vx, Vxx, dx0 = random_lq(4, 12, 36, 24, dtype, "cuda")
        n3 = kernels.riccati_backward.launches
        ks, Ks, dual = kernels.riccati_backward(lin, Vx, Vxx, 1e-9)
        assert kernels.riccati_backward.launches == n3 + 1
        ks0, Ks0, Qus0 = kernels.riccati_backward_plain(lin, Vx, Vxx, 1e-9)
        torch.cuda.synchronize()
        assert _rel(ks, ks0.cpu().numpy()) < tol
        assert _rel(Ks, Ks0.cpu().numpy()) < tol
        alphas = torch.tensor([0.0, 1.0, 0.5, 0.25, 0.1], dtype=dtype, device="cuda")
        dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks0, Ks0,
                                          dx0, alphas)
        dxs0, dus0 = kernels.linear_rollout_plain(lin["A"], lin["B"], lin["d"],
                                                  ks0, Ks0, dx0, alphas)
        torch.cuda.synchronize()
        assert _rel(dxs, dxs0.cpu().numpy()) < tol
        assert _rel(dus, dus0.cpu().numpy()) < tol
