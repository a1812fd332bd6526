"""PyTorch port vs JAX package: the solver and the host MPC on Talos
kinodynamics (23 joints, two 6D quad feet), T=6, f64 CPU.

  * two ProxDDP iterations (two one-iteration calls, each warm-started from
    the last: iterate, multipliers and penalty) from a perturbed start;
  * two host-MPC ticks on the biped gait of examples/talos_kinodynamics.py
    scaled to the horizon (2 double / 4 left / 2 double / 4 right support
    stages, T_fly 4, T_contact 2, apex 0.1 m, walking at 0.1 m/s), each fed
    the JAX plan's next state; the takeoff/land queues must agree exactly.
Tolerance (the rule of the latency tick in tests/test_torch_fused_jax.py): max(1e-9, ten
times the reference's own spread), relative to max(1, largest entry); the
spread is how far the JAX result moves when its warm start xs is
multiplied by (1 + 1e-15 noise).  At mu = 1.5e-8 (the MPC's mu_init at its
f64 floor) the Riccati gains respond to roundoff.

One JAX solver serves everything here: the JAX package's MPC is built with
its ProxDDPSolver replaced by `_OneCompile`, which wraps one solver with
the MPC's tick settings and calls it with one argument structure (zero
multipliers and mu_init where the caller gives none), so XLA compiles the
Talos iteration once instead of three times, with its scans not unrolled
(`scan_unroll=1`, a JAX compile setting that leaves the arithmetic as it
is and shortens the compile).  The MPC's initial solve is cut to that one
iteration on both sides (`init_max_iters=1`).
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 6
TICKS = 2
ITERS = 2
FLOOR = 1e-9
SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.1, T_fly=4,
                T_contact=2, timestep=0.01, init_max_iters=1)
WALK = np.array([0.1, 0, 0, 0, 0, 0])
FIELDS = ("xs", "us", "Ks", "lam_eq", "lam_in", "mu", "prim_res")


def _err(a, b):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _gait(feet):
    l, r = feet
    return ([{l: True, r: True}] * 2 + [{l: True, r: False}] * 4
            + [{l: True, r: True}] * 2 + [{l: False, r: True}] * 4)


def _queues(mpc):
    return ({k: list(v) for k, v in mpc.foot_takeoff_times.items()},
            {k: list(v) for k, v in mpc.foot_land_times.items()})


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
            lams = (jnp.zeros((T, ocp.n_eq)), jnp.zeros((T, ocp.n_in)),
                    jnp.zeros((ocp.n_term_eq,)))
        if mu is None:
            mu = self.settings.mu_init
        return self.solver.run(problem, xs, us, lams, jnp.asarray(mu, jnp.float64))


@pytest.fixture(scope="module")
def engines():
    """The JAX MPC (over one `_OneCompile` solver), the port MPC, and the
    standing problems they were built on."""
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.configs import talos_kinodynamics_config as jconfig
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.configs import make_talos_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, MPCSettings

    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 6, -9.81, False)
    tocp, tmh, _ = make_talos_kinodynamics(T, device="cpu")
    standing = (jocp.problem, tocp.problem)
    shared = _OneCompile(JSolver(jocp, JSettings(tol=SETTINGS["TOL"],
                                                 mu_init=SETTINGS["mu_init"], max_iters=1,
                                                 scan_unroll=1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, settings: shared)
        jm = jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                     **SETTINGS), jocp)
    tm = MPC(MPCSettings(support_force=tmh.mass * 9.81, **SETTINGS), tocp)
    return shared, jm, jmh, tm, standing


@pytest.fixture(scope="module")
def iterations(engines):
    """ITERS one-iteration solves from a perturbed start on the standing
    problem: the JAX results, the JAX results from the start with xs moved
    by 1e-15 (relative), and the port's."""
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.convert import lams_from_numpy
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    shared, _, jmh, tm, (jprob, tprob) = engines
    tocp = tm.ocp_handler
    rng = np.random.default_rng(4)
    x0 = np.asarray(jmh.reference_state)
    xs = x0 + 0.02 * rng.normal(size=(T + 1, x0.shape[0]))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    u0 = np.asarray(jprob.stage_params.u_ref[0])
    us = u0 + np.where(np.abs(u0) > 1.0, 20.0, 1.0) * rng.normal(size=(T,) + u0.shape)
    lams = (0.01 * rng.normal(size=(T, tocp.n_eq)), np.zeros((T, tocp.n_in)),
            np.zeros((0,)))
    noisy = xs * (1 + 1e-15 * rng.standard_normal(xs.shape))

    def jax_run(xs0):
        out, st = [], (jnp.asarray(xs0), jnp.asarray(us), tuple(map(jnp.asarray, lams)), 1e-2)
        for _ in range(ITERS):
            r = shared.run(jprob, *st)
            out.append({f: np.asarray(getattr(r, f)) for f in FIELDS})
            st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
        return out

    solver = ProxDDPSolver(tocp, SolverSettings(tol=SETTINGS["TOL"],
                                                mu_init=SETTINGS["mu_init"], max_iters=1))
    probs = tile_problem(tprob, 1)
    st = (torch.as_tensor(xs)[None], torch.as_tensor(us)[None],
          tuple(a[None] for a in lams_from_numpy(*lams, "cpu")),
          torch.full((1,), 1e-2, dtype=torch.float64))
    port = []
    for _ in range(ITERS):
        r = solver.run(probs, *st)
        port.append({f: getattr(r, f)[0] for f in FIELDS})
        st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
    return jax_run(xs), jax_run(noisy), port


@pytest.mark.parametrize("it", range(ITERS))
@pytest.mark.parametrize("field", FIELDS)
def test_iterations_match_jax(iterations, it, field):
    ref, ref_n, port = iterations
    tol = max(FLOOR, 10 * _err(ref_n[it][field], ref[it][field]))
    assert _err(port[it][field], ref[it][field]) < tol, (
        _err(port[it][field], ref[it][field]), tol)


@pytest.fixture(scope="module")
def ticks(engines):
    """TICKS ticks of both MPCs (and of a copy of the JAX one whose warm
    start xs is moved by 1e-15) on the gait, each fed the JAX plan's next
    state."""
    import jax.numpy as jnp

    _, jm, jmh, tm, _ = engines
    for m in (jm, tm):
        m.generate_cycle_horizon(_gait(jmh.feet_names))
        m.switch_to_walk(WALK)
    jm2 = copy.deepcopy(jm, {id(jm.solver): jm.solver})
    xs0 = np.asarray(jm2.xs)
    jm2.xs = jnp.asarray(xs0 * (1 + 1e-15 * np.random.default_rng(6).standard_normal(
        xs0.shape)))
    out = []
    for _ in range(TICKS):
        x = np.asarray(jm.xs[1])
        jr, jr2, tr = jm.iterate(x), jm2.iterate(x), tm.iterate(x)
        out.append(dict(j=jr, j2=jr2, t=tr, jq=_queues(jm), tq=_queues(tm),
                        div=(bool(jr.diverged), bool(tr.diverged)),
                        foot_ref_R=(np.asarray(jm.ocp_handler.problem.stage_params.foot_ref_R),
                                    tm.ocp_handler.problem.stage_params.foot_ref_R)))
    return out


@pytest.mark.parametrize("tick", range(TICKS))
@pytest.mark.parametrize("field", ["xs", "us", "Ks"])
def test_mpc_ticks_match_jax(ticks, tick, field):
    d = ticks[tick]
    ref = np.asarray(getattr(d["j"], field))
    tol = max(FLOOR, 10 * _err(np.asarray(getattr(d["j2"], field)), ref))
    assert _err(getattr(d["t"], field), ref) < tol, (_err(getattr(d["t"], field), ref), tol)


@pytest.mark.parametrize("tick", range(TICKS))
def test_mpc_queues_and_feet(ticks, tick):
    """The event queues agree exactly; the plan is finite; the 6D stance
    references keep the standing rotations (`set_all_foot_translations`
    writes foot_ref_p only)."""
    d = ticks[tick]
    assert d["jq"] == d["tq"]
    assert d["div"] == (False, False)
    assert torch.isfinite(d["t"].us).all()
    jR, tR = d["foot_ref_R"]
    assert _err(tR, jR) < 1e-12
    np.testing.assert_array_equal(tR.numpy(), np.broadcast_to(tR[0, None].numpy(), tR.shape))
