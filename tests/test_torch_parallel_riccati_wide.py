"""PyTorch port vs JAX package: the parallel-in-time Riccati backward pass
(K6) at the widths of the Talos and full-dynamics latency ticks, f64 CPU.

* The twin (`solver/parallel_riccati.py`, through
  `kernels.parallel_riccati_backward` on CPU tensors) against JAX
  `parallel_backward` on two real linearizations at T=8, made by the
  port's stage twins: Talos kinodynamics (nx=56, nu=34; `chip_smoke.talos_case`,
  feet lifted in turns, perturbed warm start and multipliers) and Go2 full
  dynamics (nx=36, nu=12; all 68 inequality rows, the quasistatic torques
  perturbed); AL penalty mu = sqrt(eps) of f32, the solver's f32 floor.
  Tolerance (the rule of
  tests/test_torch_fused_jax.py's latency tick): max(1e-9, ten times JAX's own spread
  under a 1e-15 relative move of its inputs), relative to the largest
  entry: without Jacobi scaling Quu + reg I spans the AL weights 1/mu and
  the small control weights.
* The same on random LQ problems (`testing.random_lq`) at those widths,
  beside tests/test_torch_parallel_riccati.py's (12, 36, 24): 1e-9.
* JAX's own float32 pass against its float64 value on both linearizations
  rounded to float32, the twin's beside it (the counterpart of
  tests/test_torch_parallel_riccati_f32.py's Go2 witness).
* On the 68-row full-dynamics linearization at T=100 the unscaled pass
  fails its Cholesky in JAX at exactly the twin's entries.
* The wrapper's width check: `parallel_riccati_smem` gives the three
  kernels' shared memory a block (csrc/parallel_riccati.cu's formulas),
  and a width whose largest exceeds the device's opt-in maximum is refused
  with NotImplementedError before the library is loaded (the opt-in
  mocked here).

`test_kernel_matches_twin_at_wide_widths_on_cuda` holds the CUDA kernel to
the twin at T=100 on the card (`python -m pytest --noconftest -m cuda
tests/test_torch_parallel_riccati_wide.py`).
"""
import functools

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 8
NB = 2
MU = float(np.finfo(np.float32).eps) ** 0.5  # the solver's f32 penalty floor
FLOOR = 1e-9


def _rel(a, b):
    """max|a - b| relative to the largest entry of b."""
    a = a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _linearization(robot):
    """NB scenarios of a T-stage linearization by the port's f64 twins at
    the AL penalty MU, with the terminal Vx, Vxx and the regularization the
    solver gives K6 in f64."""
    import chip_smoke
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_go2_fulldynamics
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    dtype = torch.float64
    if robot == "talos":
        ocp, probs, xs, us, lam_eq, lam_in = chip_smoke.talos_case("cpu", dtype, NB, T, seed=9)
    else:
        ocp, _, x0 = make_go2_fulldynamics(T, device="cpu", dtype=dtype)
        probs = tile_problem(ocp.problem, NB)
        rng = np.random.default_rng(5)
        xs = np.repeat(x0[None, None], NB, 0).repeat(T + 1, 1)
        xs = xs + 0.01 * rng.normal(size=xs.shape)
        xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
        us = chip_smoke.standing_torques(ocp, x0) + rng.normal(size=(NB, T, ocp.nu))
        lam_in = 0.1 * np.abs(rng.normal(size=(NB, T, ocp.n_in)))
        t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
        xs, us, lam_in = t(xs), t(us), t(lam_in)
        lam_eq = torch.zeros((NB, T, ocp.n_eq), dtype=dtype)
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=MU))
    mu = torch.full((NB,), MU, dtype=dtype)
    sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
    tp = tree_map(torch.Tensor.contiguous, probs.term_params)
    lin = kernels._linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    Vx, Vxx = kernels._linearize_term_plain(
        solver, xs[:, -1], tp, torch.zeros((NB, ocp.n_term_eq), dtype=dtype), mu)
    reg = max(solver.settings.reg_init, 50 * torch.finfo(dtype).eps)
    return {k: lin[k] for k in kernels.LIN_KEYS}, Vx, Vxx, reg


@functools.lru_cache(maxsize=None)
def _jax_backward(reg):
    import jax

    from simple_mpc_tpu.solver.parallel_riccati import parallel_backward

    return jax.jit(lambda l, vx, vxx: parallel_backward(l, vx, vxx, reg))


def _jax(lin, Vx, Vxx, reg, dtype=np.float64):
    """JAX `parallel_backward` per scenario on numpy copies of the inputs in
    `dtype`: (ks, Ks, dual) stacked."""
    import jax
    import jax.numpy as jnp

    fn = _jax_backward(reg)
    out = []
    for b in range(Vx.shape[0]):
        args = ({k: np.asarray(v[b], dtype) for k, v in lin.items()},
                np.asarray(Vx[b], dtype), np.asarray(Vxx[b], dtype))
        out.append([np.asarray(a) for a in fn(*jax.tree_util.tree_map(jnp.asarray, args))])
    return tuple(np.stack([o[i] for o in out]) for i in range(3))


def _numpy(lin, Vx, Vxx):
    return {k: v.numpy() for k, v in lin.items()}, Vx.numpy(), Vxx.numpy()


@pytest.fixture(scope="module", params=["talos", "fd"])
def real(request):
    """A real linearization of each formulation, the twin's result, JAX's
    result and JAX's result on inputs moved by 1e-15 (relative)."""
    from simple_mpc_tpu_torch import kernels

    lin, Vx, Vxx, reg = _linearization(request.param)
    twin = kernels.parallel_riccati_backward(lin, Vx, Vxx, reg)
    lin_n, Vx_n, Vxx_n = _numpy(lin, Vx, Vxx)
    rng = np.random.default_rng(7)
    noisy = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape)) for k, v in lin_n.items()}
    return dict(robot=request.param, lin=lin, nx=Vx.shape[1], nu=lin["B"].shape[-1],
                twin=twin, jax=_jax(lin_n, Vx_n, Vxx_n, reg),
                jax_noisy=_jax(noisy, Vx_n, Vxx_n, reg))


def test_twin_matches_jax_on_real_linearizations(real):
    assert (real["nx"], real["nu"]) == {"talos": (56, 34), "fd": (36, 12)}[real["robot"]]
    for name, a, b, n in zip(("ks", "Ks", "dual"), real["twin"], real["jax"],
                             real["jax_noisy"]):
        assert np.isfinite(b).all()
        tol = max(FLOOR, 10 * _rel(n, b))
        assert _rel(a, b) <= tol, (name, _rel(a, b), tol)


@pytest.mark.parametrize("seed", [0, pytest.param(1, marks=pytest.mark.slow)])
@pytest.mark.parametrize("ndx,nu", [(56, 34), (36, 12)])
def test_twin_matches_jax_on_random_lq_at_wide_widths(ndx, nu, seed):
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.testing import random_lq

    lin, Vx, Vxx, _ = random_lq(NB, T, ndx, nu, torch.float64, "cpu", seed)
    got = kernels.parallel_riccati_backward(lin, Vx, Vxx, FLOOR)
    want = _jax(*_numpy(lin, Vx, Vxx), FLOOR)
    for a, b in zip(got, want):
        assert _rel(a, b) < FLOOR


@pytest.mark.parametrize("robot", ["talos", "fd"])
def test_f32_witness(robot):
    """K6 in float32 on each real linearization rounded to float32 (at the
    solver's f32 penalty floor, as the f32 ticks run it), each pass
    against float64 on the same rounded inputs (max over ks and Ks).  The
    readings of each scenario are in the assertion's message and in
    PERF.md: on Talos the function keeps about three digits whoever
    evaluates it, on full dynamics, as on the Go2 kinodynamics data
    (tests/test_torch_parallel_riccati_f32.py), one.  The twin stays
    within 1e-2 on Talos and 50 % on full dynamics, the two f64 passes
    within 1e-8."""
    from simple_mpc_tpu_torch import kernels

    lin, Vx, Vxx, _ = _linearization(robot)
    lin32 = {k: v.float() for k, v in lin.items()}
    Vx32, Vxx32 = Vx.float(), Vxx.float()
    reg = max(1e-9, 50 * float(np.finfo(np.float32).eps))
    up = ({k: v.double() for k, v in lin32.items()}, Vx32.double(), Vxx32.double())
    twin32 = kernels.parallel_riccati_backward_plain(lin32, Vx32, Vxx32, reg)[:2]
    twin64 = kernels.parallel_riccati_backward_plain(*up, reg)[:2]
    jax32 = _jax(*_numpy(lin32, Vx32, Vxx32), reg, np.float32)[:2]
    jax64 = _jax(*_numpy(*up), reg)[:2]
    assert jax32[0].dtype == np.float32
    for b in range(NB):
        err = dict(
            jax32=max(_rel(a[b], c[b]) for a, c in zip(jax32, jax64)),
            twin32=max(_rel(a[b], c[b]) for a, c in zip(twin32, twin64)),
            twin64=max(_rel(a[b], c[b]) for a, c in zip(twin64, jax64)))
        assert np.isfinite(list(err.values())).all(), err
        assert err["twin64"] < 1e-8, err
        if robot == "talos":
            assert err["jax32"] < 1e-2 and err["twin32"] < 1e-2, err
        else:
            assert err["jax32"] > 0.05, err  # the reference loses these digits too
            assert err["twin32"] < 0.5, err


@pytest.mark.slow
def test_pyramid_rows_break_the_unscaled_pass_in_jax_as_in_the_twin():
    """On the full-dynamics linearization of the card's K6 check with all
    68 rows (`chip_smoke.k6_case("fd_pyramids")`: T=100, f32, mu =
    sqrt(eps)), Quu + reg I without Jacobi scaling fails its Cholesky: JAX
    `parallel_backward` and the twin give non-finite gains at the same
    entries (measured: 1,188 of 1,200 ks and 42,768 of 43,200 Ks), where
    the serial pass with its Jacobi scaling (K3's twin) stays finite.
    `slow`: the full-dynamics linearization twin at T=100, kept out of the
    quick suite for its time limit."""
    import chip_smoke
    from simple_mpc_tpu_torch import kernels

    saved = chip_smoke.B
    chip_smoke.B = 1
    try:
        lin, Vx, Vxx, reg = chip_smoke.k6_case("cpu", torch.float32, "fd_pyramids", 1)
    finally:
        chip_smoke.B = saved
    twin = kernels.parallel_riccati_backward_plain(lin, Vx, Vxx, reg)[:2]
    jax32 = _jax(*_numpy(lin, Vx, Vxx), reg, np.float32)[:2]
    for a, b in zip(twin, jax32):
        assert int((~torch.isfinite(a)).sum()) > 0
        np.testing.assert_array_equal(torch.isfinite(a).numpy(), np.isfinite(b))
    assert torch.isfinite(kernels.riccati_backward_plain(lin, Vx, Vxx, reg)[1]).all()


def test_width_check_refuses_what_does_not_fit(monkeypatch):
    """The shared memory of csrc/parallel_riccati.cu's three kernels at the
    new widths (the combine's 7 nx^2 + 3 nx elements is the largest), and
    the refusal of a width beyond the device's opt-in maximum before the
    library is loaded: with a mocked 100 kB opt-in, Talos's f64 combine
    (176,960 B) is refused and its f32 one (88,480 B) goes on to the
    launch."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.testing import random_lq

    assert kernels.parallel_riccati_smem(56, 34, torch.float64) == dict(
        eliminate=95_808, combine=176_960, gains=105_840)
    assert kernels.parallel_riccati_smem(36, 12, torch.float64) == dict(
        eliminate=25_536, combine=73_440, gains=32_640)
    assert kernels.parallel_riccati_smem(56, 34, torch.float32)["combine"] == 88_480

    class Launched(Exception):
        pass

    def library():
        raise Launched

    monkeypatch.setattr(kernels, "smem_optin", lambda device: 100_000)
    monkeypatch.setattr(kernels, "_library", library)
    for dtype, fits in ((torch.float64, False), (torch.float32, True)):
        lin, Vx, Vxx, _ = random_lq(1, 3, 56, 34, dtype, "cpu")
        with pytest.raises(Launched if fits else NotImplementedError):
            kernels._parallel_riccati_cuda(lin, Vx, Vxx, FLOOR)
    lin, Vx, Vxx, _ = random_lq(1, 3, 36, 12, torch.float64, "cpu")
    with pytest.raises(Launched):
        kernels._parallel_riccati_cuda(lin, Vx, Vxx, FLOOR)


@pytest.mark.cuda
def test_kernel_matches_twin_at_wide_widths_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.testing import random_lq

    for ndx, nu in ((56, 34), (36, 12)):
        lin, Vx, Vxx, _ = random_lq(2, 100, ndx, nu, torch.float64, "cuda", seed=1)
        n = kernels.parallel_riccati_backward.launches
        got = kernels.parallel_riccati_backward(lin, Vx, Vxx, FLOOR)
        assert kernels.parallel_riccati_backward.launches == n + 1
        want = kernels.parallel_riccati_backward(
            {k: v.cpu() for k, v in lin.items()}, Vx.cpu(), Vxx.cpu(), FLOOR)
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-10
