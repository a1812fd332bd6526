"""PyTorch port vs JAX package: the Go2 full-dynamics trot on the host MPC,
T=50, f64 CPU, through tick 30 (`slow`).

The configuration is `configs.go2_fd_mpc`'s (examples/go2_fulldynamics.py:
T=50, trot 10/30/10/30 at 0.2 m/s, apex 0.05 m, mu_init 1e-8, one
iteration a tick, the friction pyramids off) with the first solve cut to 20
iterations, as the card's full-dynamics tick phases run it.  On the card
the port's prim_res jumps to 3.9e-2 when the trot's first swing enters the
horizon (tick 11), in f32 and f64 alike.  This test runs the JAX package's
host MPC and the port's on the same states (each tick fed the JAX plan's
next state) and holds the port's prim_res, xs and us to JAX's at every tick
under the spread rule of tests/test_torch_talos_solver.py: max(1e-9, ten
times how far a copy of the JAX MPC moves when its warm start xs is
multiplied by (1 + 1e-15 noise)), relative to max(1, largest entry).  The
two prim streams are printed side by side (`pytest -s`): whether JAX jumps
at tick 11 as the port does.

The JAX MPC's two solvers (the first solve's and the tick's) compile with
their scans not unrolled (`scan_unroll=1`, a compile setting that leaves the
arithmetic as it is); the compiles take most of the ~15 minutes.
"""
import copy

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 50
TICKS = 30
INIT_ITERS = 20
FLOOR = 1e-9
SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.05, T_fly=30,
                T_contact=10, timestep=0.01, init_max_iters=INIT_ITERS)
WALK = np.array([0.2, 0, 0, 0, 0, 0])


def _err(a, b):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _trot(feet):
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    return [ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30


@pytest.fixture(scope="module")
def streams():
    """Per tick: the JAX results, those of the JAX copy with the moved warm
    start, and the port's, on the same measured states."""
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.mpc import mpc as jmpc_module
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu_torch.configs import go2_fd_mpc

    jmh = jconfigs.go2_handler()
    jocp = JOCP(jconfigs.go2_fulldynamics_config(jmh, force_cone=False), jmh)
    jocp.create_problem(np.asarray(jmh.reference_state), T, 3, -9.81, False)

    def unrolled_once(ocp, settings):
        return JSolver(ocp, settings.__class__(**{**settings.__dict__, "scan_unroll": 1}))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpc_module, "ProxDDPSolver", unrolled_once)
        jm = jmpc_module.MPC(jmpc_module.MPCSettings(support_force=jmh.mass * 9.81,
                                                     **SETTINGS), jocp)
    jm.generate_cycle_horizon(_trot(jmh.feet_names))
    jm.switch_to_walk(WALK)
    tm = go2_fd_mpc(T, device="cpu", dtype=torch.float64, init_max_iters=INIT_ITERS)
    jm2 = copy.deepcopy(jm, {id(jm.solver): jm.solver, id(jm._init_solver): jm._init_solver})
    xs0 = np.asarray(jm2.xs)
    jm2.xs = jnp.asarray(xs0 * (1 + 1e-15 * np.random.default_rng(6).standard_normal(
        xs0.shape)))
    out = []
    for tick in range(TICKS):
        x = np.asarray(jm.xs[1])
        jr, jr2, tr = jm.iterate(x), jm2.iterate(x), tm.iterate(x)
        out.append(dict(j=jr, j2=jr2, t=tr))
        print(f"tick {tick:2d}: prim JAX {float(jr.prim_res):.6e}  "
              f"port {float(tr.prim_res):.6e}", flush=True)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("field", ["prim_res", "xs", "us"])
def test_fd_trot_matches_jax_through_tick_30(streams, field):
    worst = []
    for tick, d in enumerate(streams):
        ref = np.asarray(getattr(d["j"], field))
        tol = max(FLOOR, 10 * _err(np.asarray(getattr(d["j2"], field)), ref))
        e = _err(getattr(d["t"], field), ref)
        worst.append((e / tol, tick, e, tol))
    assert max(worst)[0] < 1.0, max(worst)
