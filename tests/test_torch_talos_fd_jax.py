"""PyTorch port vs JAX package on Talos full dynamics (23 joints, two 6D
quad feet, 22 joint torques), f64 CPU, T=2 (`slow`: JAX runs eagerly,
under `jax.disable_jit()`, because XLA's compile of its Talos
full-dynamics iteration holds more than 16 GB of host memory at any
horizon; eagerly one iteration takes about six minutes and 3.3 GB).

  * two ProxDDP iterations (two one-iteration calls of the port's batched
    `ProxDDPSolver.run` at B=1, each warm-started from the last: iterate,
    multipliers and penalty) from a perturbed start on the example's
    standing problem;
  * two host-MPC ticks on examples/talos_fulldynamics.py's biped gait
    scaled down (2 double / 4 left / 2 double / 4 right support stages,
    T_fly 4, T_contact 2, apex 0.1 m, walking at 0.1 m/s), each fed
    the JAX plan's next state, with the stage-0 contact wrenches
    (`get_contact_forces`) and state derivatives;
  * two ticks of the example's closed loop (Riccati feedback
    us[0] - Ks[0] difference(x, xs[0]) at 1 kHz into the rigid-contact
    simulator) through the port's `examples/talos_fulldynamics.py` and
    `examples/loop.py`, and through the JAX package's `examples/loop.py`
    with `id_solver=None`, each fed back its own simulated state.  The JAX
    loop takes the difference the other way round (examples/loop.py:90-92,
    difference(xs[0], x)), which feeds the error back with the wrong sign
    (the robot leaves the ground within the first tick); the reference
    (talos_fulldynamics.py:203-205) and the port take difference(x,
    xs[0]), so the JAX loop runs here with the `state_difference` it
    imports given its arguments in the reference's order.

Tolerances (the rule of tests/test_torch_talos_solver.py and
tests/test_torch_talos_loop.py): max(floor, ten times the reference's own
spread), relative to max(1, largest entry); the spread is how far the JAX
result moves when its warm start (the solver and the MPC) or its start
state (the loop) is moved by 1e-15 relative noise.  Floor 1e-9, 1e-8 for
the loop.

One JAX solver serves everything: the JAX MPCs are built with their
ProxDDPSolver replaced by `_OneCompile`, which wraps one solver with the
MPC's tick settings and calls it with one argument structure.  The MPCs'
initial solve is cut to that one iteration on both sides
(`init_max_iters=1`).
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 2
TICKS = 2
ITERS = 2
FLOOR = 1e-9
LOOP_FLOOR = 1e-8
MPC_OVERRIDES = dict(T_fly=4, T_contact=2, init_max_iters=1)
FIELDS = ("xs", "us", "Ks", "lam_in", "mu", "prim_res")


def _err(a, b):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _gait(feet):
    l, r = feet
    return ([{l: True, r: True}] * 2 + [{l: True, r: False}] * 4
            + [{l: True, r: True}] * 2 + [{l: False, r: True}] * 4)


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


@pytest.fixture(scope="module", autouse=True)
def eager():
    """Every JAX call of the module runs eagerly (see the module's note)."""
    import jax

    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def engines():
    """The shared JAX solver, a JAX MPC factory over it, the JAX handler
    and OCP, and the port's MPC settings."""
    from examples.talos_fulldynamics import talos_fulldynamics_config as jconfig
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.examples import talos_kinodynamics as kex

    settings = {**kex.MPC_SETTINGS, **MPC_OVERRIDES}
    jmh = jhandler()
    jocp = JOCP(jconfig(jmh), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 6, -9.81, False)
    shared = _OneCompile(JSolver(jocp, JSettings(tol=settings["TOL"],
                                                 mu_init=settings["mu_init"], max_iters=1,
                                                 scan_unroll=1)))
    standing = copy.deepcopy(jocp.problem)

    def jax_mpc():
        jocp.problem = standing
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmpc_module, "ProxDDPSolver", lambda ocp, s: shared)
            return jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                           **settings), jocp)

    return dict(shared=shared, jax_mpc=jax_mpc, jmh=jmh, jocp=jocp, standing=standing,
                settings=settings)


@pytest.fixture(scope="module")
def iterations(engines):
    """ITERS one-iteration solves from a perturbed start on the standing
    problem: the JAX results, the JAX results from the start with xs moved
    by 1e-15 (relative), and the port's."""
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics
    from simple_mpc_tpu_torch.convert import lams_from_numpy
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    shared, jmh, jprob = engines["shared"], engines["jmh"], engines["standing"]
    tocp, _, x0 = make_talos_fulldynamics(T, device="cpu")
    rng = np.random.default_rng(4)
    xs = x0 + 0.01 * rng.normal(size=(T + 1, x0.shape[0]))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    us = 5.0 * rng.normal(size=(T, tocp.nu))
    lams = (np.zeros((T, 0)), 0.01 * np.abs(rng.normal(size=(T, tocp.n_in))), np.zeros((0,)))
    noisy = xs * (1 + 1e-15 * rng.standard_normal(xs.shape))

    def jax_run(xs0):
        out, st = [], (jnp.asarray(xs0), jnp.asarray(us), tuple(map(jnp.asarray, lams)), 1e-2)
        for _ in range(ITERS):
            r = shared.run(jprob, *st)
            out.append({f: np.asarray(getattr(r, f)) for f in FIELDS})
            st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
        return out

    s = engines["settings"]
    solver = ProxDDPSolver(tocp, SolverSettings(tol=s["TOL"], mu_init=s["mu_init"],
                                                max_iters=1))
    probs = tile_problem(tocp.problem, 1)
    st = (torch.as_tensor(xs)[None], torch.as_tensor(us)[None],
          tuple(a[None] for a in lams_from_numpy(*lams, "cpu")),
          torch.full((1,), 1e-2, dtype=torch.float64))
    port = []
    for _ in range(ITERS):
        r = solver.run(probs, *st)
        port.append({f: getattr(r, f)[0] for f in FIELDS})
        st = (r.xs, r.us, (r.lam_eq, r.lam_in, r.lam_term), r.mu)
    return jax_run(xs), jax_run(noisy), port


@pytest.mark.slow
@pytest.mark.parametrize("it", range(ITERS))
@pytest.mark.parametrize("field", FIELDS)
def test_batched_iterations_match_jax(iterations, it, field):
    ref, ref_n, port = iterations
    tol = max(FLOOR, 10 * _err(ref_n[it][field], ref[it][field]))
    assert _err(port[it][field], ref[it][field]) < tol, (
        _err(port[it][field], ref[it][field]), tol)


@pytest.fixture(scope="module")
def ticks(engines, iterations):
    """TICKS ticks of the JAX MPC, of a copy of it whose warm start xs is
    moved by 1e-15, and of the port's (`configs.talos_fd_mpc`), each fed
    the JAX plan's next state; with each tick's stage-0 contact wrenches
    and state derivative."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu_torch.configs import talos_fd_mpc

    jm, jmh = engines["jax_mpc"](), engines["jmh"]
    jm.generate_cycle_horizon(_gait(jmh.feet_names))
    jm.switch_to_walk(np.array([0.1, 0, 0, 0, 0, 0]))
    tm = talos_fd_mpc(T, device="cpu", dtype=torch.float64, gait=_gait(jmh.feet_names),
                      **MPC_OVERRIDES)
    jm2 = copy.deepcopy(jm, {id(jm.solver): jm.solver, id(jm._init_solver): jm._init_solver})
    xs0 = np.asarray(jm2.xs)
    jm2.xs = jnp.asarray(xs0 * (1 + 1e-15 * np.random.default_rng(6).standard_normal(
        xs0.shape)))
    jf = jax.jit(lambda x, u, p: (jm.ocp_handler.get_contact_forces(x, u, p),
                                  jm.ocp_handler.state_derivative(x, u, p)))
    out = []
    for _ in range(TICKS):
        x = np.asarray(jm.xs[1])
        jr, jr2, tr = jm.iterate(x), jm2.iterate(x), tm.iterate(x)
        p0 = jax.tree_util.tree_map(lambda a: a[0], jm.ocp_handler.problem.stage_params)
        jfw, jxd = jf(jr.xs[0], jr.us[0], p0)
        jfw2, jxd2 = jf(jr2.xs[0], jr2.us[0], p0)
        out.append(dict(j=jr, j2=jr2, t=tr, jf=np.asarray(jfw), jxd=np.asarray(jxd),
                        jf2=np.asarray(jfw2), jxd2=np.asarray(jxd2),
                        tf=tm.get_contact_forces(0), txd=tm.get_state_derivative(0),
                        div=(bool(jr.diverged), bool(tr.diverged))))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
@pytest.mark.parametrize("field", ["xs", "us", "Ks"])
def test_mpc_ticks_match_jax(ticks, tick, field):
    d = ticks[tick]
    ref = np.asarray(getattr(d["j"], field))
    tol = max(FLOOR, 10 * _err(np.asarray(getattr(d["j2"], field)), ref))
    assert _err(getattr(d["t"], field), ref) < tol, (_err(getattr(d["t"], field), ref), tol)


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_mpc_contact_wrenches_match_jax(ticks, tick):
    """The stage-0 wrenches and state derivative at each plan's own first
    node (through K7 alone) under the same spread rule, the spread being
    the wrenches and derivative at the moved JAX copy's plan; the wrenches
    6D and unilateral in their force."""
    d = ticks[tick]
    assert d["tf"].shape == (2, 6) and d["div"] == (False, False)
    for got, ref, moved in ((d["tf"], d["jf"], d["jf2"]), (d["txd"], d["jxd"], d["jxd2"])):
        tol = max(FLOOR, 10 * _err(moved, ref))
        assert _err(got, ref) < tol, (_err(got, ref), tol)
    assert d["tf"].numpy()[:, 2].min() > -1e-6


@pytest.fixture(scope="module")
def closed_loop(engines, ticks):
    """The per-tick q, v of the port's and JAX's closed loops under "j" and
    "t", and `spread()`: JAX's own run from a copy of its MPC with the
    start state moved by 1e-15 (relative), made on the first call."""
    import examples.loop as jloop_module
    from examples.loop import foot_height as jfoot_height
    from examples.loop import run_closed_loop as jloop
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu_torch.examples import talos_fulldynamics as ex
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import WALK

    jm, jmh = engines["jax_mpc"](), engines["jmh"]
    plant = JSim(jmh.model, jmh.feet_frame_ids,
                 JSimSettings(dt=1e-3, ground_height=jfoot_height(jmh)))
    jm2, jmh2 = copy.deepcopy(jm, {id(jm.solver): jm.solver,
                                   id(jm._init_solver): jm._init_solver}), copy.copy(jmh)
    rng = np.random.default_rng(29)
    x0 = np.asarray(jmh.reference_state)
    jmh2.reference_state = x0 * (1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=x0.shape))
    gait = _gait(jmh.feet_names)

    jdifference = jloop_module.state_difference

    def reference_order(model, x1, x2):
        return jdifference(model, x2, x1)

    def jax_run(mpc, mh):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jloop_module, "state_difference", reference_order)
            r = jloop(mpc, mh, id_solver=None, n_steps=TICKS, log_every=0, plant=plant,
                      walk_velocity=WALK, gait=gait)
        return np.stack(r["q"]), np.stack(r["v"])

    tm, tmh = ex.setup(T, device="cpu", dtype=torch.float64, **MPC_OVERRIDES)
    r = ex.run(tm, tmh, n_steps=TICKS, log_every=0, gait=gait)
    runs = dict(j=jax_run(jm, jmh), t=(np.stack(r["q"]), np.stack(r["v"])))
    moved = []

    def spread():
        if not moved:
            moved.append(jax_run(jm2, jmh2))
        return moved[0]

    return runs, spread


@pytest.mark.slow
@pytest.mark.parametrize("tick", range(TICKS))
def test_riccati_feedback_closed_loop_matches_jax(closed_loop, tick):
    runs, spread = closed_loop
    for i in range(2):  # q, v
        err = _err(runs["t"][i][tick], runs["j"][i][tick])
        print(f"tick {tick} {'qv'[i]}: port vs JAX {err:.2e}")
        if err >= LOOP_FLOOR:
            sp = _err(spread()[i][tick], runs["j"][i][tick])
            print(f"tick {tick} {'qv'[i]}: JAX spread {sp:.2e}")
            assert err < 10 * sp, (err, sp)
    # the robot moved under the Riccati feedback and stood on its soles
    assert np.abs(runs["t"][1][tick]).max() > 0
    assert abs(runs["t"][0][tick][2] - runs["t"][0][0][2]) < 0.1
