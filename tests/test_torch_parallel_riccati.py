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
* float32 on the Go2 T=100 linearization: JAX's own `parallel_backward`
  loses most digits there too; the twin stays within a limit set from the
  measured readings.
* The port's `BatchedSolver.run` with `parallel=True` against JAX
  `BatchedSolver.run` of `ProxDDPSolver(SolverSettings(parallel=True))`:
  Go2 kinodynamics T=12, 2 scenarios, 2 iterations; xs, us, ks, Ks, prim
  and dual to 1e-9 relative to max(1, the largest entry).
* `run_donated` equals `run` and hands back the tensors it was given.

`test_kernel_matches_twin_on_cuda` holds the CUDA kernel to the twin on the
card; it needs no JAX (run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_parallel_riccati.py`).
"""
import numpy as np
import pytest
import torch

from simple_mpc_tpu_torch.testing import random_lq as _random_lq

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
def go2_f32():
    """The Go2 T=100 linearization of the card's kernel check
    (`chip_smoke.standing_case`, seed 3: scenarios 0 and 1, mu = sqrt(eps))
    in float32, with the twin's f32 and f64 results and JAX
    `parallel_backward`'s f32 and f64 results on the same inputs."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from simple_mpc_tpu.solver.parallel_riccati import parallel_backward
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    f32, nb = torch.float32, 2
    ocp, probs, xs, us = chip_smoke.standing_case("cpu", f32, seed=3)
    xs, us = xs[:nb], us[:nb]
    T = us.shape[1]
    solver = ProxDDPSolver(ocp, SolverSettings(mu_init=1e-6))
    eps = torch.finfo(f32).eps
    mu = torch.full((nb,), eps ** 0.5, dtype=f32)
    sp = tree_map(lambda a: a[:nb].contiguous(), probs.stage_params)
    tp = tree_map(lambda a: a[:nb].contiguous(), probs.term_params)
    lin = kernels._linearize_traj_plain(
        solver, sp, xs, us, torch.zeros((nb, T, ocp.n_eq), dtype=f32),
        torch.zeros((nb, T, ocp.n_in), dtype=f32), mu)
    lin = {k: lin[k] for k in kernels.LIN_KEYS}
    Vx, Vxx = kernels._linearize_term_plain(
        solver, xs[:, -1], tp, torch.zeros((nb, ocp.n_term_eq), dtype=f32), mu)
    reg = max(solver.settings.reg_init, 50 * eps)

    twin32 = kernels.parallel_riccati_backward_plain(lin, Vx, Vxx, reg)
    twin64 = kernels.parallel_riccati_backward_plain(
        {k: v.double() for k, v in lin.items()}, Vx.double(), Vxx.double(), reg)
    fn = jax.jit(lambda l, vx, vxx: parallel_backward(l, vx, vxx, reg)[:2])
    jax32, jax64 = [], []
    for b in range(nb):
        args = [{k: v[b].numpy() for k, v in lin.items()}, Vx[b].numpy(), Vxx[b].numpy()]
        jax32.append([np.asarray(a) for a in fn(*jax.tree_util.tree_map(jnp.asarray, args))])
        assert jax32[-1][0].dtype == np.float32
        jax64.append([np.asarray(a) for a in fn(*jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), args))])
    return dict(nb=nb, lin=lin, Vx=Vx, Vxx=Vxx, reg=reg, twin32=twin32, twin64=twin64,
                jax32=jax32, jax64=jax64)


def test_f32_error_on_go2_data_is_the_functions(go2_f32):
    """K6 in float32 on the Go2 T=100 linearization, each against float64
    on the same inputs.  Quu + reg I is not Jacobi-scaled and spans the 1e-5
    joint-acceleration weights and the AL weights 1/mu, so the function
    keeps few digits in float32 whoever evaluates it: JAX
    `parallel_backward` is 11.8 % and 10.7 % off (max over ks and Ks), the
    twin, whose Hillis-Steele scan does about 2.9 times the combines of
    `lax.associative_scan`, 22.2 % and 30.2 % (measured; over scenarios 0-5:
    JAX 10.1-12.7 %, the twin 17.5-30.2 %).  In float64 the two agree to
    8.0e-10."""
    c = go2_f32
    for b in range(c["nb"]):
        err = dict(
            jax32=max(_rel(a, b_) for a, b_ in zip(c["jax32"][b], c["jax64"][b])),
            twin32=max(_rel(a[b], b_[b].numpy())
                       for a, b_ in zip(c["twin32"][:2], c["twin64"][:2])),
            twin64=max(_rel(a[b], b_) for a, b_ in zip(c["twin64"][:2], c["jax64"][b])))
        assert err["jax32"] > 0.05, err  # the reference loses these digits too
        assert err["twin32"] < 0.5, err
        assert err["twin64"] < 1e-8, err


def _tree_suffix_scan(elems):
    """Suffix composition in the pairing of `lax.associative_scan(fn,
    reverse=True)` (test only): the sequence is reversed, adjacent pairs are
    combined, the odd entries scanned recursively and the even ones
    combined from them, and the result reversed back.  In the reversed
    sequence the first operand is the later stage, so each pair composes as
    `combine(second, first)`, as JAX `_combine_batched` does."""
    from simple_mpc_tpu_torch.solver.parallel_riccati import combine

    def comb(a, b):
        return combine(b, a)

    def scan(el):
        n = el[0].shape[1]
        if n < 2:
            return el
        odd = scan(comb(tuple(e[:, 0:n - 1:2] for e in el), tuple(e[:, 1::2] for e in el)))
        if n % 2 == 0:
            even = comb(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in el))
        else:
            even = comb(odd, tuple(e[:, 2::2] for e in el))
        even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(el, even))
        out = []
        for ev, od in zip(even, odd):  # interleave: even, odd, even, ...
            full = torch.empty((ev.shape[0], n) + ev.shape[2:], dtype=ev.dtype)
            full[:, 0::2], full[:, 1::2] = ev, od
            out.append(full)
        return tuple(out)

    flip = tuple(torch.flip(e, dims=(1,)) for e in elems)
    return tuple(torch.flip(e, dims=(1,)) for e in scan(flip))


def test_f32_scan_order_is_not_the_cause(go2_f32):
    """Does the twin's Hillis-Steele order cause its larger f32 error on the
    Go2 data?  The same elimination, combine and gain recovery with the
    scan paired as `lax.associative_scan(reverse=True)` pairs it (in f64 it
    meets the Hillis-Steele twin to 1e-8, the bound the twin meets JAX to
    above; measured 6.8e-10 and 2.2e-10): in f32 it is 22.1 % and 30.2 %
    off the f64 value (scenarios 0 and 1), the Hillis-Steele twin 22.2 %
    and 30.2 %, JAX 11.8 % and 10.7 %.  So the scan order is not the cause:
    with JAX's own pairing the port's arithmetic loses as much as with its
    own, and the gap to JAX lies in the elimination, combine or gain
    arithmetic (torch's LU and Cholesky against XLA's), which this test
    does not settle."""
    from simple_mpc_tpu_torch.solver.parallel_riccati import eliminate, gains

    c = go2_f32

    def tree_backward(lin, Vx, Vxx):
        _, _, _, eta, J = _tree_suffix_scan(eliminate(lin, Vx, Vxx, c["reg"]))
        return gains(lin, J[:, 1:], -eta[:, 1:], c["reg"])[:2]

    lin64 = {k: v.double() for k, v in c["lin"].items()}
    tree64 = tree_backward(lin64, c["Vx"].double(), c["Vxx"].double())
    tree32 = tree_backward(c["lin"], c["Vx"], c["Vxx"])
    for b in range(c["nb"]):
        assert max(_rel(a[b], b_[b].numpy()) for a, b_ in zip(tree64, c["twin64"][:2])) < 1e-8
        err = dict(
            jax32=max(_rel(a, b_) for a, b_ in zip(c["jax32"][b], c["jax64"][b])),
            tree32=max(_rel(a[b], b_[b].numpy()) for a, b_ in zip(tree32, c["twin64"][:2])),
            hs32=max(_rel(a[b], b_[b].numpy())
                     for a, b_ in zip(c["twin32"][:2], c["twin64"][:2])))
        assert err["tree32"] > 1.5 * err["jax32"], err
        assert abs(err["tree32"] - err["hs32"]) < 0.1 * err["hs32"], err


def _jax_stages(reg):
    """JAX's three stages of `parallel_backward` as separate jitted
    functions on one scenario: the elimination, `lax.associative_scan` and
    the gain recovery, written as simple_mpc_tpu/solver/parallel_riccati.py
    writes them."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_solve

    from simple_mpc_tpu.solver.parallel_riccati import _combine_batched

    @jax.jit
    def elim(lin, Vx_T, Vxx_T):
        A, B, Quu, Qux, qu = lin["A"], lin["B"], lin["Quu"], lin["Qux"], lin["qu"]
        nx, nu = A.shape[1], B.shape[2]
        Lq = jnp.linalg.cholesky(Quu + reg * jnp.eye(nu, dtype=A.dtype)[None])
        sol = jax.vmap(lambda L, r: cho_solve((L, True), r))(
            Lq, jnp.concatenate([Qux, qu[..., None], B.swapaxes(1, 2)], axis=-1))
        Ui_Qux, Ui_qu, Ui_Bt = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
        Ce = B @ Ui_Bt
        Je = lin["Qxx"] - Qux.swapaxes(1, 2) @ Ui_Qux
        zm = jnp.zeros((1, nx, nx), A.dtype)
        return (jnp.concatenate([A - B @ Ui_Qux, zm]),
                jnp.concatenate([lin["d"] - (B @ Ui_qu[..., None])[..., 0],
                                 jnp.zeros((1, nx), A.dtype)]),
                jnp.concatenate([0.5 * (Ce + Ce.swapaxes(1, 2)), zm]),
                jnp.concatenate([-(lin["qx"] - (Ui_Qux.swapaxes(1, 2) @ qu[..., None])[..., 0]),
                                 -Vx_T[None]]),
                jnp.concatenate([0.5 * (Je + Je.swapaxes(1, 2)), Vxx_T[None]]))

    @jax.jit
    def scan(elems):
        return jax.lax.associative_scan(_combine_batched, elems, reverse=True)

    @jax.jit
    def gains(lin, S1, v1):
        def one(A, B, d, qu, Qux, Quu, S, v):
            Qu = qu + B.T @ (v + S @ d)
            L = jnp.linalg.cholesky(Quu + B.T @ S @ B + reg * jnp.eye(B.shape[1], dtype=B.dtype))
            kK = cho_solve((L, True), jnp.concatenate([Qu[:, None], Qux + B.T @ S @ A], axis=1))
            return -kK[:, 0], -kK[:, 1:]
        return jax.vmap(one)(lin["A"], lin["B"], lin["d"], lin["qu"], lin["Qux"], lin["Quu"],
                             S1, v1)

    return elim, scan, gains


def test_f32_loss_is_the_combines_lu_roundoff(go2_f32, monkeypatch):
    """Where does the twin lose more than JAX in float32 on the Go2 data?
    The three stages are cross-fed between JAX and the port in f32 (E the
    elimination, S the suffix scan, G the gain recovery; j = JAX's, p = the
    port's), each run's ks and Ks held against JAX in f64 on the same
    inputs.  Measured on scenarios 0 / 1:

        E S G = j j j   11.8 % / 10.7 %   (JAX's own)
                p j j   11.6 % / 11.0 %
                j p j   18.6 % / 16.0 %

    so the port's scan carries the extra loss, and its elimination and
    gains do not.  Inside the scan, the two LU solves of each combine carry
    all of it: with only those solves in f64 the port's scan is 0.10 % /
    0.11 % off.  With scipy's LAPACK LU (`lu_factor`/`lu_solve`, the
    routine JAX's CPU backend calls) in place of torch's
    `linalg.solve_ex` (MKL here), the port's scan gives 13.9 % / 16.8 %,
    the same as with `jnp.linalg.solve` itself: the two LU routines round
    differently and (I + C1 J2) amplifies it, while the port's op order is
    JAX's.  JAX's own f32 error moves by as much when its f32 inputs move
    by one ulp (scenario 0: 9.0-18.8 % over the four draws below, scenario
    1: 11.6-14.9 %).  So the gap is the LU routine's roundoff, which the
    port has no arithmetic to align; the f32 error belongs to the
    function."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sl

    import simple_mpc_tpu_torch.solver.parallel_riccati as pr
    from simple_mpc_tpu.solver.parallel_riccati import parallel_backward

    c = go2_f32
    elim, scan, gains = _jax_stages(c["reg"])
    lin32 = {k: v.numpy() for k, v in c["lin"].items()}
    Vx32, Vxx32 = c["Vx"].numpy(), c["Vxx"].numpy()
    jsolve = jax.jit(jnp.linalg.solve)

    def run(b, E, S):
        """ks, Ks of scenario b in f32 with stage E and S from JAX ("j") or
        the port ("p"), and JAX's gain recovery."""
        lin = {k: v[b] for k, v in lin32.items()}
        if E == "j":
            el = [np.asarray(e) for e in elim(lin, Vx32[b], Vxx32[b])]
        else:
            el = [e[0].numpy() for e in pr.eliminate(
                {k: torch.as_tensor(v[None]) for k, v in lin.items()},
                torch.as_tensor(Vx32[b:b + 1]), torch.as_tensor(Vxx32[b:b + 1]), c["reg"])]
        if S == "j":
            sc = [np.asarray(e) for e in scan(tuple(map(jnp.asarray, el)))]
        else:
            sc = [e[0].numpy() for e in pr.suffix_scan(
                tuple(torch.as_tensor(np.array(e[None])) for e in el))]
        return [np.asarray(a) for a in gains(lin, sc[4][1:], -sc[3][1:])]

    def err(b, out):
        return max(_rel(a, r) for a, r in zip(out, c["jax64"][b]))

    def scipy_lu(M, R):
        out = np.empty(R.shape, np.float32)
        for i in np.ndindex(M.shape[:-2]):
            out[i] = sl.lu_solve(sl.lu_factor(M[i].numpy()), R[i].numpy())
        return torch.as_tensor(out)

    plain_solve = pr.solve
    solves = dict(
        f64=lambda M, R: plain_solve(M.double(), R.double()).float(),
        scipy=scipy_lu,
        jax=lambda M, R: torch.as_tensor(np.asarray(jsolve(M.numpy(), R.numpy()))))
    fn = jax.jit(lambda l, vx, vxx: parallel_backward(l, vx, vxx, c["reg"])[:2])
    rng = np.random.default_rng(0)
    for b in range(c["nb"]):
        e = {f"{E}{S}j": err(b, run(b, E, S)) for E, S in ("jj", "pj", "jp")}
        for name, s in solves.items():
            monkeypatch.setattr(pr, "solve", s)
            e[f"jpj_{name}_lu"] = err(b, run(b, "j", "p"))
        monkeypatch.setattr(pr, "solve", plain_solve)
        # JAX's own f32 error when its inputs move by one ulp
        ulp = []
        for _ in range(4):
            lin = {k: v[b] * (1 + 2.0 ** -23 * rng.integers(-1, 2, size=v[b].shape))
                   for k, v in lin32.items()}
            Vxx = Vxx32[b] * (1 + 2.0 ** -23 * rng.integers(-1, 2, size=Vxx32[b].shape))
            args = (lin, Vx32[b], 0.5 * (Vxx + Vxx.T))
            ref = fn(*jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), args))
            got = fn(*jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), args))
            ulp.append(max(_rel(np.asarray(g), np.asarray(r)) for g, r in zip(got, ref)))
        print(f"scenario {b}:", {k: round(v, 4) for k, v in e.items()},
              "jax_one_ulp:", [round(u, 4) for u in ulp])
        assert e["jjj"] == pytest.approx(max(_rel(a, r) for a, r in zip(
            c["jax32"][b], c["jax64"][b])), rel=1e-3), e
        assert e["jpj"] > 1.3 * e["jjj"] and e["pjj"] < 1.15 * e["jjj"], e
        assert e["jpj_f64_lu"] < 1e-2, e
        assert e["jpj_scipy_lu"] == pytest.approx(e["jpj_jax_lu"], rel=1e-3), e
        assert abs(e["jpj_scipy_lu"] - e["jpj"]) > 0.02 * e["jpj"], e
        assert max(ulp) - min(ulp) > 0.02, ulp


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

    jbs = JBatched(JSolver(jocp, JSettings(max_iters=ITERS, parallel=True, **SETTINGS)))
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
