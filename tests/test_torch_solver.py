"""PyTorch port vs JAX package: the batched ProxDDP solver.

Go2 kinodynamics T=8, B=2 scenarios with distinct perturbed warm starts
(iterate and multipliers), f64 CPU.  The port's `BatchedSolver.run` is held
to the JAX package's `BatchedSolver.run` (a vmap of the single-problem
solver) after 1 and 5 iterations, within 1e-9 relative to max(1, largest
entry): xs, us, ks, Ks, the multipliers, mu, prim, dual and merit.

The step size JAX accepted in the last iteration is identified by matching
the JAX iterate against the port's candidates of that iteration (one per
step size, computed from the port's iterate before it); the candidates of
different step sizes lie orders of magnitude further apart than the two
packages' iterates.
"""
import numpy as np
import pytest
import torch

T = 8
NB = 2
TOL = 1e-9
ITERS = (1, 5)
# a start far enough out that iteration 5 still takes real steps (|k| ~ 3e-3):
# at convergence the step sizes tie in merit at roundoff level
SETTINGS = dict(mu_init=1e-2, tol=1e-7)


def _err(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.parallel import BatchedSolver as JBatched
    from simple_mpc_tpu.parallel import tile_problem as jtile
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.convert import (lams_from_numpy, problem_from_numpy,
                                              results_to_numpy)
    from simple_mpc_tpu_torch.parallel import BatchedSolver, tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    jocp, jmh, x0 = jconfigs.make_go2_kinodynamics(T)
    tocp, _, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    prob = jocp.problem
    rng = np.random.default_rng(21)
    xs = np.repeat(x0[None, None], NB, 0).repeat(T + 1, 1)
    xs = xs + 0.05 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = np.asarray(prob.stage_params.u_ref[0])
    us = (np.repeat(u0[None, None], NB, 0).repeat(T, 1)
          + 5.0 * rng.normal(size=(NB, T, jocp.nu)))
    lam_eq = 0.01 * rng.normal(size=(NB, T, jocp.n_eq))
    lam_in = np.zeros((NB, T, jocp.n_in))
    lam_term = np.zeros((NB, 0))

    jbs = {n: JBatched(JSolver(jocp, JSettings(max_iters=n, **SETTINGS)))
           for n in ITERS}
    jprobs = jtile(prob, NB)
    jl = (jnp.asarray(lam_eq), jnp.asarray(lam_in), jnp.asarray(lam_term))
    jres = {n: jax.tree_util.tree_map(np.asarray, b.run(jprobs, jnp.asarray(xs),
                                                         jnp.asarray(us), jl))
            for n, b in jbs.items()}

    tprobs = tile_problem(problem_from_numpy(
        tocp, prob.stage_params, prob.term_params, x0, "cpu"), NB)
    tl = lams_from_numpy(lam_eq, lam_in, lam_term, "cpu")
    txs, tus = torch.as_tensor(xs), torch.as_tensor(us)
    tres, alpha_j = {}, {}
    for n in ITERS:
        solver = ProxDDPSolver(tocp, SolverSettings(max_iters=n, **SETTINGS))
        tres[n] = results_to_numpy(BatchedSolver(solver).run(tprobs, txs, tus, tl))
        # the port's state entering iteration n, and its candidates there
        if n == 1:
            st = (txs, tus, tl, torch.full((NB,), SETTINGS["mu_init"], dtype=torch.float64))
        else:
            r = solver.run(tprobs, txs, tus, tl, max_iters=n - 1)
            st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
        xs_c = _candidates(solver, tprobs, *st).numpy()  # (B, nA, T+1, nx)
        dist = np.abs(xs_c - jres[n].xs[:, None]).max(axis=(2, 3))
        pick = np.argmin(dist, axis=1)
        assert (dist[np.arange(NB), pick] < 1e-8).all(), dist
        alpha_j[n] = np.asarray(solver.settings.alphas)[pick]
    return jres, tres, alpha_j


def _candidates(solver, probs, xs, us, lams, mu):
    """The port's line-search candidates of one iteration from (xs, us)."""
    from simple_mpc_tpu_torch import kernels

    lam_eq, lam_in, lam_term = lams
    lin = kernels.stage_linearize(solver, probs.stage_params, xs, us, lam_eq, lam_in, mu)
    Vx, Vxx = kernels.term_linearize(solver, xs[:, -1], probs.term_params, lam_term, mu)
    ks, Ks, _ = solver._backward(lin, Vx, Vxx, 1e-9)
    dx0 = solver.space.difference(xs[:, 0], probs.x0)
    alphas = torch.as_tensor(solver.settings.alphas, dtype=xs.dtype)
    return solver._candidates(xs, us, lin, ks, Ks, dx0, alphas)[0]


@pytest.mark.parametrize("n", ITERS)
@pytest.mark.parametrize("field", ["xs", "us", "ks", "Ks", "lam_eq", "lam_in",
                                   "lam_term", "mu", "prim_res", "dual_res", "merit"])
def test_batched_solver_matches_jax(runs, n, field):
    jres, tres, _ = runs
    assert _err(tres[n][field], getattr(jres[n], field)) < TOL


@pytest.mark.parametrize("n", ITERS)
def test_same_accepted_step_and_flags(runs, n):
    jres, tres, alpha_j = runs
    np.testing.assert_array_equal(tres[n]["alpha"], alpha_j[n])
    np.testing.assert_array_equal(tres[n]["diverged"], np.asarray(jres[n].diverged))
    assert not tres[n]["diverged"].any()
