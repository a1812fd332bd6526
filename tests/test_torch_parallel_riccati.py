"""PyTorch port vs JAX package: the parallel-in-time Riccati backward pass
(K6) and the solver that runs it (`SolverSettings(parallel=True)`), f64 CPU.

* The twin (`solver/parallel_riccati.py`, reached through
  `kernels.parallel_riccati_backward` on CPU tensors) against JAX
  `parallel_backward` on random LQ problems made with numpy from a seed
  (`testing.random_lq`, the kernels' generator), at ndx=8, nu=3
  (tests/test_parallel_riccati.py's size) and at the main path's ndx=36,
  nu=24, over 3 seeds; ks, Ks and the dual residual to 1e-9 relative to the
  largest entry (measured: at most 1.5e-15; the twin scans in
  Hillis-Steele order, `lax.associative_scan` in another tree).
* Failures: a stage whose Quu + reg I is indefinite gives NaN exactly where
  JAX gives NaN.
* The port's `BatchedSolver.run` with `parallel=True` against JAX
  `BatchedSolver.run` of `ProxDDPSolver(SolverSettings(parallel=True))`:
  Go2 kinodynamics T=12, 2 scenarios, 2 iterations; xs, us, ks, Ks, prim
  and dual to 1e-9 relative to max(1, the largest entry).
* `run_donated` equals `run` and hands back the tensors it was given.

K6 in float32 on the Go2 T=100 linearization is held against JAX's own
float32 pass in tests/test_torch_parallel_riccati_f32.py.

`test_kernel_matches_twin_on_cuda` holds the CUDA kernel to the twin on the
card; it needs no JAX (run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_parallel_riccati.py`).
"""
import numpy as np
import pytest
import torch

from simple_mpc_tpu_torch.testing import random_lq as _random_lq

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-9
REG = 1e-9
T_SOLVER = 12
NB = 2
ITERS = 2
SETTINGS = dict(mu_init=1e-2, tol=1e-7)


def _rel(a, b):
    """max|a - b| relative to the largest entry of b."""
    a = a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def random_lq(nb, T, ndx, nu, seed):
    """The kernels' synthetic LQ problem (`testing.random_lq`, Gauss-Newton
    stage Hessians, near-identity dynamics) in float64, as numpy arrays."""
    lin, Vx_T, Vxx_T, _ = _random_lq(nb, T, ndx, nu, torch.float64, "cpu", seed)
    return {k: v.numpy() for k, v in lin.items()}, Vx_T.numpy(), Vxx_T.numpy()


def _jax_backward(lin, Vx_T, Vxx_T, dual_scale=None):
    """JAX `parallel_backward` per scenario: (ks, Ks, dual) stacked."""
    import jax

    from simple_mpc_tpu.solver.parallel_riccati import parallel_backward

    fn = jax.jit(lambda l, vx, vxx, s: parallel_backward(l, vx, vxx, REG, dual_scale=s))
    out = [fn({k: v[b] for k, v in lin.items()}, Vx_T[b], Vxx_T[b], dual_scale)
           for b in range(Vx_T.shape[0])]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(3))


def _port_backward(lin, Vx_T, Vxx_T, dual_scale=None):
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.convert import lin_from_numpy

    t = torch.as_tensor
    return kernels.parallel_riccati_backward(
        lin_from_numpy(lin, "cpu"), t(Vx_T), t(Vxx_T), REG,
        dual_scale=None if dual_scale is None else t(dual_scale))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T,ndx,nu", [(25, 8, 3), (12, 36, 24)])
def test_parallel_twin_matches_jax_on_random_lq(T, ndx, nu, seed):
    lin, Vx_T, Vxx_T = random_lq(2, T, ndx, nu, seed)
    # physical-unit dual residual under control scaling on one of the sizes
    scale = np.linspace(0.5, 2.0, nu) if seed == 1 else None
    ks, Ks, dual = _port_backward(lin, Vx_T, Vxx_T, scale)
    jks, jKs, jdual = _jax_backward(lin, Vx_T, Vxx_T, scale)
    assert _rel(ks, jks) < TOL
    assert _rel(Ks, jKs) < TOL
    assert _rel(dual, jdual) < TOL


def test_parallel_twin_fails_where_jax_fails():
    """An indefinite Quu + reg I at one stage: the Cholesky of JAX (and of
    the twin) returns NaN, which the scan carries to every earlier stage."""
    lin, Vx_T, Vxx_T = random_lq(2, 6, 8, 3, seed=5)
    lin["Quu"][1, 2] = -np.eye(3)
    ks, Ks, _ = _port_backward(lin, Vx_T, Vxx_T)
    jks, jKs, _ = _jax_backward(lin, Vx_T, Vxx_T)
    for a, b in ((ks, jks), (Ks, jKs)):
        nan = np.isnan(b)
        assert nan[1, :2].all() and not nan[0].any()
        np.testing.assert_array_equal(torch.isnan(a).numpy(), nan)
        assert _rel(a[torch.as_tensor(~nan)], b[~nan]) < TOL


def test_cpu_tensors_never_count_launches_and_other_devices_raise():
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.convert import lin_from_numpy

    lin, Vx_T, Vxx_T = random_lq(1, 3, 8, 3, seed=0)
    n6 = kernels.parallel_riccati_backward.launches
    ks, Ks, dual = _port_backward(lin, Vx_T, Vxx_T)
    assert ks.shape == (1, 3, 3) and Ks.shape == (1, 3, 3, 8) and dual.shape == (1,)
    assert kernels.parallel_riccati_backward.launches == n6
    meta = {k: v.to("meta") for k, v in lin_from_numpy(lin, "cpu").items()}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.parallel_riccati_backward(meta, torch.empty((1, 8), device="meta"),
                                          torch.empty((1, 8, 8), device="meta"), REG)


@pytest.mark.parametrize("batched", [False, True])
def test_lin_from_numpy_round_trip_is_exact(batched):
    from simple_mpc_tpu_torch.convert import lin_from_numpy

    lin, _, _ = random_lq(2, 4, 8, 3, seed=2)
    src = lin if batched else {k: v[1] for k, v in lin.items()}
    got = lin_from_numpy(src, "cpu")
    for k, v in src.items():
        assert got[k].dtype == torch.float64 and got[k].shape[:2] == (
            (2, 4) if batched else (1, 4))
        back = got[k].numpy() if batched else got[k][0].numpy()
        np.testing.assert_array_equal(back, v)


@pytest.fixture(scope="module")
def solver_runs():
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

    T = T_SOLVER
    jocp, _, x0 = jconfigs.make_go2_kinodynamics(T)
    tocp, _, _ = tconfigs.make_go2_kinodynamics(T, device="cpu")
    prob = jocp.problem
    rng = np.random.default_rng(31)
    xs = np.repeat(x0[None, None], NB, 0).repeat(T + 1, 1)
    xs = xs + 0.05 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    u0 = np.asarray(prob.stage_params.u_ref[0])
    us = (np.repeat(u0[None, None], NB, 0).repeat(T, 1)
          + 5.0 * rng.normal(size=(NB, T, jocp.nu)))
    lams = (0.01 * rng.normal(size=(NB, T, jocp.n_eq)), np.zeros((NB, T, jocp.n_in)),
            np.zeros((NB, 0)))

    # scans not unrolled: a compile setting, the arithmetic as it is
    jbs = JBatched(JSolver(jocp, JSettings(max_iters=ITERS, parallel=True, scan_unroll=1,
                                           **SETTINGS)))
    jres = jax.tree_util.tree_map(np.asarray, jbs.run(
        jtile(prob, NB), jnp.asarray(xs), jnp.asarray(us), tuple(map(jnp.asarray, lams))))

    tprobs = tile_problem(problem_from_numpy(
        tocp, prob.stage_params, prob.term_params, x0, "cpu"), NB)
    bs = BatchedSolver(ProxDDPSolver(tocp, SolverSettings(max_iters=ITERS, parallel=True,
                                                          **SETTINGS)))
    tres = bs.run(tprobs, torch.as_tensor(xs), torch.as_tensor(us),
                  lams_from_numpy(*lams, "cpu"))
    return dict(jres=jres, tres=results_to_numpy(tres), res=tres, bs=bs, tprobs=tprobs,
                start=(xs, us, lams))


@pytest.mark.parametrize("field", ["xs", "us", "ks", "Ks", "prim_res", "dual_res"])
def test_parallel_solver_matches_jax(solver_runs, field):
    got, want = solver_runs["tres"][field], np.asarray(getattr(solver_runs["jres"], field))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < TOL
    assert not solver_runs["tres"]["diverged"].any()


def test_run_donated_matches_run_and_reuses_the_buffers(solver_runs):
    from simple_mpc_tpu_torch.convert import lams_from_numpy

    xs, us, lams = solver_runs["start"]
    xs_b, us_b = torch.as_tensor(xs.copy()), torch.as_tensor(us.copy())
    lams_b = lams_from_numpy(*lams, "cpu")
    ptrs = [a.data_ptr() for a in (xs_b, us_b, *lams_b)]
    res = solver_runs["bs"].run_donated(solver_runs["tprobs"], xs_b, us_b, lams_b)
    got = [res.xs, res.us, res.lam_eq, res.lam_in, res.lam_term]
    assert [a.data_ptr() for a in got] == ptrs
    assert res.xs is xs_b and res.us is us_b
    for f, a in zip(("xs", "us", "lam_eq", "lam_in", "lam_term"), got):
        assert torch.equal(a, getattr(solver_runs["res"], f)), f
    for f in ("ks", "Ks", "prim_res", "dual_res", "merit", "mu"):
        assert torch.equal(getattr(res, f), getattr(solver_runs["res"], f)), f


@pytest.mark.cuda
def test_kernel_matches_twin_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain twin")

    plain = kernels.parallel_riccati_backward_plain
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for nb, T, ndx, nu in ((3, 12, 36, 24), (1, 100, 36, 24), (2, 9, 8, 3)):
            # the main path's structure: near-identity dynamics, Gauss-Newton
            # stage Hessians
            lin, Vx_T, Vxx_T, _ = _random_lq(nb, T, ndx, nu, dtype, "cuda", seed=T)
            n6 = kernels.parallel_riccati_backward.launches
            with monkeypatch.context() as m:
                m.setattr(kernels, "parallel_riccati_backward_plain", refuse)
                ks, Ks, dual = kernels.parallel_riccati_backward(lin, Vx_T, Vxx_T, REG)
            assert kernels.parallel_riccati_backward.launches == n6 + 1
            ks0, Ks0, Qus0 = plain(lin, Vx_T, Vxx_T, REG)
            torch.cuda.synchronize()
            assert _rel(ks, ks0.cpu().numpy()) < tol
            assert _rel(Ks, Ks0.cpu().numpy()) < tol
            assert _rel(dual, Qus0.abs().amax(dim=(1, 2)).cpu().numpy()) < tol
