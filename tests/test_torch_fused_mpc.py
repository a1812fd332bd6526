"""The port's fused MPC tick (`FusedMPC`) against the port's host `MPC` and
against the JAX package's eager queue and swing functions.

Go2 kinodynamics T=12 with the quadruped gait and the measurement stream
of tests/test_fused_mpc.py, f64 CPU.  The host engine pins the reference's
semantics; the fused tick must reproduce it: event queues exactly as
integers, swing endpoints, foot references, contact flags and the DCM
target to 1e-12, xs and us to 1e-9, Ks to 1e-7 (the same tolerances the
JAX package holds its own fused tick to).

The `cuda`-marked tests hold the K9 kernel (`kernels.tick_refs`) to its
twin on the card and run a fused tick under sync-debug mode "error"; they
need no JAX (`python -m pytest --noconftest -m cuda tests/test_torch_fused_mpc.py`).
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 12
TICKS = 4
FEET = ["FL_foot", "FR_foot", "RL_foot", "RR_foot"]


def quad_gait_plan(n_double=2, n_single=2):
    FL, FR, RL, RR = FEET
    allc = {f: True for f in FEET}
    sw1 = {FL: False, FR: True, RL: True, RR: False}
    sw2 = {FL: True, FR: False, RL: False, RR: True}
    return [allc] * n_double + [sw1] * n_single + [allc] * n_double + [sw2] * n_single


def make_engine(device="cpu", dtype=torch.float64, init_max_iters=10):
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics
    from simple_mpc_tpu_torch.mpc import MPC, FusedMPC, MPCSettings

    ocp, mh, x0 = make_go2_kinodynamics(T, device=device, dtype=dtype)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-6, mu_init=1e-8,
                          max_iters=1, swing_apex=0.05, T_fly=4, T_contact=2, T=T,
                          timestep=0.01, init_max_iters=init_max_iters), ocp)
    mpc.generate_cycle_horizon(quad_gait_plan())
    mpc.switch_to_walk(np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.05]))
    fused = FusedMPC(mpc)
    return mpc, fused, fused.make_carry(mpc), mh


def measurements(mh, n=TICKS):
    """Deterministic measurement stream near the reference state."""
    nq, nv = mh.model.nq, mh.model.nv
    xs = []
    for i in range(n):
        x = np.array(mh.reference_state)
        x[nq:] += 0.02 * np.sin(0.3 * i + np.arange(nv))
        x[2] += 0.005 * i
        xs.append(x)
    return np.stack(xs)


def _queues(q):
    from simple_mpc_tpu_torch.kernels import EMPTY

    return [[int(v) for v in row if v < EMPTY // 2] for row in q.tolist()]


def _err(a, b):
    a = a.detach().double().cpu() if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    b = b.detach().double().cpu() if torch.is_tensor(b) else torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max())


def _rel(a, b):
    """max|a - b| relative to max(1, the largest entry of b)."""
    return _err(a, b) / max(float(b.abs().max()), 1.0)


@pytest.fixture(scope="module")
def trace():
    """Host MPC.iterate and FusedMPC.step fed the same stream."""
    mpc, fused, carry0, mh = make_engine()
    xs_meas = measurements(mh)
    carry, out = carry0, []
    for i in range(TICKS):
        x = torch.as_tensor(xs_meas[i])
        res_h = mpc.iterate(x)
        carry, res_f = fused.step(carry, x)
        sp = mpc.ocp_handler.problem.stage_params
        out.append(dict(
            res=(res_f, res_h), carry=carry,
            host_queues=([list(mpc.foot_takeoff_times[n]) for n in mpc.ee_names],
                         [list(mpc.foot_land_times[n]) for n in mpc.ee_names]),
            host=dict(p_init=mpc.foot_trajectories.p_init.clone(),
                      p_final=mpc.foot_trajectories.p_final.clone(),
                      foot_ref_p=sp.foot_ref_p, contact_active=sp.contact_active,
                      dcm_ref=mpc.ocp_handler.problem.term_params.dcm_ref)))
    return dict(fused=fused, carry0=carry0, xs_meas=xs_meas, out=out)


def test_queue_tick_matches_jax():
    """Exact int32 semantics of the queue tick, walking and standing, with
    and without appends, against the JAX package's `_queue_tick`."""
    import jax.numpy as jnp

    from simple_mpc_tpu.mpc.fused import FusedMPC as JFused
    from simple_mpc_tpu_torch.kernels import EMPTY
    from simple_mpc_tpu_torch.mpc.fused import QMAX, FusedMPC

    rng = np.random.default_rng(3)
    for case in range(12):
        q = np.full((4, QMAX), EMPTY, np.int32)
        for k in range(4):
            n = rng.integers(0, QMAX + 1)
            q[k, :n] = np.sort(rng.integers(-1, 40, size=n))
        walking = bool(case % 2)
        dec = np.ones_like(q, bool) if walking else (q < T)
        append = rng.random(4) < 0.5
        val = int(rng.integers(10, 30))
        got = FusedMPC._queue_tick(torch.as_tensor(q), torch.as_tensor(dec),
                                   torch.as_tensor(append), val)
        want = JFused._queue_tick(jnp.asarray(q), jnp.asarray(dec), jnp.asarray(append),
                                  jnp.int32(val))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("land", [-3, 0, 2, 4, 7, 30])
def test_swing_sampling_matches_jax(land):
    import jax.numpy as jnp

    from simple_mpc_tpu.mpc import foot_trajectory as jft
    from simple_mpc_tpu_torch.mpc.foot_trajectory import sample_swing_batched

    rng = np.random.default_rng(land + 10)
    p0, p1 = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    heads = land + np.arange(4)
    got = sample_swing_batched(torch.as_tensor(p0), torch.as_tensor(p1), 0.1,
                               torch.as_tensor(heads), 6, T)
    for k in range(4):
        want = jft.sample_swing(jnp.asarray(p0[k]), jnp.asarray(p1[k]), 0.1,
                                int(heads[k]), 6, T)
        assert _err(got[k], want) <= 1e-12


@pytest.mark.parametrize("tick", range(TICKS))
def test_fused_step_matches_host_mpc(trace, tick):
    step = trace["out"][tick]
    res_f, res_h = step["res"]
    assert _err(res_f.xs, res_h.xs) <= 1e-9
    assert _err(res_f.us, res_h.us) <= 1e-9
    assert _err(res_f.Ks, res_h.Ks) <= 1e-7
    carry = step["carry"]
    assert (_queues(carry.takeoff), _queues(carry.land)) == step["host_queues"]
    host = step["host"]
    assert _err(carry.p_init, host["p_init"]) <= 1e-12
    assert _err(carry.p_final, host["p_final"]) <= 1e-12
    assert _err(carry.stage_params.foot_ref_p, host["foot_ref_p"]) <= 1e-12
    assert _err(carry.stage_params.contact_active, host["contact_active"]) <= 1e-12
    assert _err(carry.term_params.dcm_ref, host["dcm_ref"]) <= 1e-12


def test_the_stream_exercises_swings_and_events(trace):
    """The compared ticks are not trivial: events are pending and some
    swing endpoint moved."""
    last = trace["out"][-1]
    assert any(last["host_queues"][1]) and any(last["host_queues"][0])
    assert _err(last["carry"].p_final, trace["carry0"].p_final) > 1e-3


def test_step_batched_matches_single_steps(trace):
    """step_batched at B=3 with distinct warm starts, velocities and
    measurements equals three single-engine steps (xs, us to 1e-9 relative
    to the largest entry: the batched products sum in another order)."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    fused, carry = trace["fused"], trace["carry0"]
    B = 3
    cb = fused.tile_carry(carry, B)
    shift = torch.linspace(-1e-3, 1e-3, B, dtype=torch.float64)
    cb = cb._replace(xs=cb.xs + shift[:, None, None],
                     velocity_base=cb.velocity_base * torch.tensor([[1.0], [0.5], [0.0]]))
    xb = torch.as_tensor(trace["xs_meas"][:B])
    cb2, rb = fused.step_batched(cb, xb)
    for i in range(B):
        ci = tree_map(lambda a: a[i], cb)
        c_i, r_i = fused.step(ci, xb[i])
        assert _rel(rb.xs[i], r_i.xs) <= 1e-9
        assert _rel(rb.us[i], r_i.us) <= 1e-9
        assert _queues(cb2.land[i]) == _queues(c_i.land)
        assert _err(cb2.stage_params.foot_ref_p[i], c_i.stage_params.foot_ref_p) <= 1e-12


def test_self_rollout_and_rollout_stay_finite(trace):
    fused, carry = trace["fused"], trace["carry0"]
    c2, res = fused.rollout(carry, torch.as_tensor(trace["xs_meas"][:2]))
    assert res.us.shape == (2, T, carry.us.shape[-1])
    assert torch.isfinite(res.us).all()
    c3, (us0, xs1, prim) = fused.self_rollout(c2, 3)
    assert us0.shape == (3, carry.us.shape[-1]) and xs1.shape == (3, carry.xs.shape[-1])
    assert torch.isfinite(us0).all() and torch.isfinite(xs1).all()
    assert bool((prim < 1e-2).all())


def _leaves(carry):
    from simple_mpc_tpu_torch.ocp.base import tree_leaves

    return tree_leaves(carry)


@pytest.mark.parametrize("self_fed", [True, False])
def test_step_donated_matches_step_and_reuses_the_carry(trace, self_fed):
    """step_donated writes the tick into the passed carry's tensors and
    equals step bit for bit, also when the measurement is a view of the
    carry it overwrites (`step_donated(carry, carry.xs[1])`)."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    fused = trace["fused"]
    ref = tree_map(torch.clone, trace["carry0"])
    mine = tree_map(torch.clone, trace["carry0"])
    x_ref = ref.xs[1] if self_fed else torch.as_tensor(trace["xs_meas"][1])
    x_mine = mine.xs[1] if self_fed else x_ref.clone()
    ptrs = [a.data_ptr() for a in _leaves(mine)]
    c_ref, r_ref = fused.step(ref, x_ref)
    c_don, r_don = fused.step_donated(mine, x_mine)
    assert [a.data_ptr() for a in _leaves(c_don)] == ptrs
    for a, b in zip(_leaves(c_don), _leaves(c_ref)):
        assert torch.equal(a, b)
    for a, b in zip(r_don, r_ref):
        assert torch.equal(a, b)


def test_step_batched_donated_matches_step_batched(trace):
    from simple_mpc_tpu_torch.ocp.base import tree_map

    fused = trace["fused"]
    cb = fused.tile_carry(trace["carry0"], 2)
    cb = cb._replace(xs=cb.xs + torch.tensor([0.0, 1e-3], dtype=torch.float64)[:, None, None])
    mine = tree_map(torch.clone, cb)
    ptrs = [a.data_ptr() for a in _leaves(mine)]
    c_ref, r_ref = fused.step_batched(cb, cb.xs[:, 1])
    c_don, r_don = fused.step_batched_donated(mine, mine.xs[:, 1])
    assert [a.data_ptr() for a in _leaves(c_don)] == ptrs
    for a, b in zip(_leaves(c_don), _leaves(c_ref)):
        assert torch.equal(a, b)
    assert torch.equal(r_don.us, r_ref.us)


def test_self_rollout_leaves_the_carry_pristine(trace):
    """self_rollout runs on a copy: the caller's carry is unchanged, and the
    ticks equal step fed its own xs[1]."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    fused, carry = trace["fused"], trace["carry0"]
    before = tree_map(torch.clone, carry)
    c_end, (us0, xs1, prim) = fused.self_rollout(carry, 2)
    for a, b in zip(_leaves(carry), _leaves(before)):
        assert torch.equal(a, b)
    c = before
    for i in range(2):
        c, res = fused.step(c, c.xs[1])
        assert torch.equal(us0[i], res.us[0]) and torch.equal(prim[i], res.prim_res)
    for a, b in zip(_leaves(c_end), _leaves(c)):
        assert torch.equal(a, b)


def test_switches_and_carry_round_trip(trace):
    from simple_mpc_tpu_torch.convert import carry_from_numpy, carry_to_numpy
    from simple_mpc_tpu_torch.mpc.mpc import STANDING, WALKING

    fused, carry = trace["fused"], trace["carry0"]
    st = fused.switch_to_stand(carry)
    assert int(st.now) == STANDING and not st.velocity_base.any()
    wk = fused.switch_to_walk(st, [0.3, 0, 0, 0, 0, 0])
    assert int(wk.now) == WALKING and float(wk.velocity_base[0]) == 0.3
    back = carry_from_numpy(fused.ocp, carry_to_numpy(carry), "cpu")
    for a, b in zip(back, carry):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_tick_reaches_the_twins(trace):
    from simple_mpc_tpu_torch import kernels

    fused, carry = trace["fused"], trace["carry0"]
    before = [k.launches for k in kernels.KERNELS]
    fused.step(carry, torch.as_tensor(trace["xs_meas"][0]))
    assert [k.launches for k in kernels.KERNELS] == before


def _cuda_batch(dtype, B=4, seed=1):
    mpc, fused, carry, mh = make_engine("cuda", dtype, init_max_iters=2)
    rng = np.random.default_rng(seed)
    cb = fused.tile_carry(carry, B)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    now = torch.tensor([0, 1, 1, 0][:B], dtype=torch.int32, device="cuda")
    ca = cb.stage_params.contact_active.clone()
    ca[2 % B, -1, 0] = 0.0  # standing, but the last stage lifts a foot
    cb = cb._replace(now=now, velocity_base=cb.velocity_base + t(0.1 * rng.normal(size=(B, 6))),
                     stage_params=cb.stage_params._replace(contact_active=ca))
    x = cb.xs[:, 0] + t(0.01 * rng.normal(size=(B, cb.xs.shape[-1])))
    x[:, 3:7] /= x[:, 3:7].norm(dim=-1, keepdim=True)
    return fused, cb, x


@pytest.mark.cuda
def test_tick_refs_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels

    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        fused, cb, x = _cuda_batch(dtype)
        for _ in range(5):
            n = kernels.tick_refs.launches
            got = kernels.tick_refs(fused, cb, x)
            assert kernels.tick_refs.launches == n + 1
            want = kernels.tick_refs_plain(fused, cb, x)
            for k in ("walking", "takeoff", "land"):
                assert torch.equal(getattr(got, k), getattr(want, k)), k
            for k in ("p_init", "p_final", "refs", "com_ref"):
                a, b = getattr(got, k), getattr(want, k)
                assert float((a - b).abs().max() / b.abs().max()) <= tol, (dtype, k)
            cb, _ = fused.step_batched(cb, x)


@pytest.mark.cuda
def test_fused_tick_makes_no_host_sync_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    fused, cb, x = _cuda_batch(torch.float32)
    cb, res = fused.step_batched(cb, x)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cb, res = fused.step_batched(cb, cb.xs[:, 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(res.xs).all()
