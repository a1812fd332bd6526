"""The port's fused MPC tick on Talos kinodynamics (23 joints, two 6D quad
feet) and on Go2 full dynamics, against the port's host `MPC`, f64 CPU.

The engines are those of `configs.make_talos_fused` (T=6) and
`configs.make_go2_fd_fused` (T=4), their gaits scaled to the horizon
(Talos: 2 double / 4 left / 2 double / 4 right support stages; Go2: the
quadruped gait of tests/test_torch_fused_mpc.py; T_fly 4, T_contact 2),
the first solve cut to one iteration.  The host engine pins the
reference's semantics and the fused tick must reproduce it, with the
tolerances of tests/test_torch_fused_mpc.py: event queues exactly as
integers, swing endpoints, foot references, contact flags and the DCM
target within 1e-12, xs and us within 1e-9, Ks within 1e-7; on Talos
also with the associative-scan Riccati (`parallel=True`, the latency
engine) on both sides (`slow`).  On the serial engines (full dynamics
`slow`) `step_batched` is held to single steps (1e-9 relative to the
largest entry), `step_donated` and `step_batched_donated` to `step` and
`step_batched` bit for bit, and `self_rollout` to `step` fed its own
xs[1].  No JAX is built here: the
host MPC on Talos is held to the JAX package's in the quick suite
(tests/test_torch_talos_solver.py), and the `slow`
tests/test_torch_fused_talos_jax.py holds the fused ticks to JAX's
`FusedMPC.step` directly.

Routes and refusals: `kernels.tick_refs` hands a Talos OCP's CUDA tensors
to `wide_tick_refs` (csrc/tick_wide.cu) and never a Go2 one; both refuse
a queue wider than `kernels.TICK_MAX_QUEUE` before any launch.  The
`cuda`-marked test holds `wide_tick_refs` to its twin on the card
(`python -m pytest --noconftest -m cuda tests/test_torch_fused_wide.py`).
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_fused_mpc import measurements, quad_gait_plan

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 6
FD_T = 4
TICKS = 3  # the gaits' first swing enters the horizon on the third tick
SETTINGS = dict(T_fly=4, T_contact=2, init_max_iters=1)
TALOS_FEET = ["left_sole_link", "right_sole_link"]


def talos_gait():
    l, r = TALOS_FEET
    return ([{l: True, r: True}] * 2 + [{l: True, r: False}] * 4
            + [{l: True, r: True}] * 2 + [{l: False, r: True}] * 4)


def host_mpc(robot, parallel=False, device="cpu", dtype=torch.float64):
    from simple_mpc_tpu_torch.configs import go2_fd_mpc, talos_mpc

    if robot == "talos":
        return talos_mpc(T, device, dtype, parallel, talos_gait(), **SETTINGS)
    return go2_fd_mpc(FD_T, device, dtype, parallel, gait=quad_gait_plan(), **SETTINGS)


def _queues(q):
    from simple_mpc_tpu_torch.kernels import EMPTY

    return [[int(v) for v in row if v < EMPTY // 2] for row in q.tolist()]


def _err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel(a, b):
    return _err(a, b) / max(float(b.abs().max()), 1.0)


def _leaves(carry):
    from simple_mpc_tpu_torch.ocp.base import tree_leaves

    return tree_leaves(carry)


# the serial tick on both OCPs; the latency engine (K6's twin) on Talos,
# whose nx=56, nu=34 the Go2 latency tests never reach, is `slow` (the
# quick suite's time limit), as are the full-dynamics batched and donated
# ticks (the carry handling is the Talos one's, on other parameter leaves)
SLOW = pytest.mark.slow
CASES = [pytest.param(("talos", False), id="talos-k3"),
         pytest.param(("talos", True), id="talos-k6", marks=SLOW),
         pytest.param(("fd", False), id="fd-k3")]


@functools.lru_cache(maxsize=None)
def _trace(robot, parallel):
    """Host MPC.iterate and FusedMPC.step fed the same stream, from one
    host engine and the carry made from it."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.mpc import FusedMPC

    mpc = host_mpc(robot, parallel)
    fused = FusedMPC(mpc)
    carry0 = fused.make_carry(mpc)
    xs_meas = measurements(mpc.model_handler, TICKS)
    carry, out, counts = carry0, [], []
    for i in range(TICKS):
        x = torch.as_tensor(xs_meas[i])
        res_h = mpc.iterate(x)
        before = [k.launches for k in kernels.KERNELS]
        carry, res_f = fused.step(carry, x)
        counts.append([k.launches for k in kernels.KERNELS] == before)
        sp = mpc.ocp_handler.problem.stage_params
        out.append(dict(
            res=(res_f, res_h), carry=carry,
            host_queues=([list(mpc.foot_takeoff_times[n]) for n in mpc.ee_names],
                         [list(mpc.foot_land_times[n]) for n in mpc.ee_names]),
            host=dict(p_init=mpc.foot_trajectories.p_init.clone(),
                      p_final=mpc.foot_trajectories.p_final.clone(),
                      foot_ref_p=sp.foot_ref_p, contact_active=sp.contact_active,
                      dcm_ref=mpc.ocp_handler.problem.term_params.dcm_ref)))
    return dict(robot=robot, parallel=parallel, fused=fused, carry0=carry0,
                xs_meas=xs_meas, out=out, no_launch=counts)


@pytest.fixture(scope="module", params=CASES)
def trace(request):
    return _trace(*request.param)


@pytest.fixture(scope="module", params=["talos", pytest.param("fd", marks=SLOW)])
def serial_trace(request):
    """The serial engines' traces: the batched and donated ticks share the
    latency engine's carry handling, so they are held on these."""
    return _trace(request.param, False)


def test_fused_step_matches_host_mpc(trace):
    assert trace["fused"].solver.settings.parallel == trace["parallel"]
    for step in trace["out"]:
        res_f, res_h = step["res"]
        assert _err(res_f.xs, res_h.xs) <= 1e-9
        assert _err(res_f.us, res_h.us) <= 1e-9
        assert _err(res_f.Ks, res_h.Ks) <= 1e-7
        assert not bool(res_f.diverged)
        carry = step["carry"]
        assert (_queues(carry.takeoff), _queues(carry.land)) == step["host_queues"]
        host = step["host"]
        for k in ("p_init", "p_final"):
            assert _err(getattr(carry, k), host[k]) <= 1e-12
        for k in ("foot_ref_p", "contact_active"):
            assert _err(getattr(carry.stage_params, k), host[k]) <= 1e-12
        assert _err(carry.term_params.dcm_ref, host["dcm_ref"]) <= 1e-12
    last = trace["out"][-1]
    assert any(last["host_queues"][0]) and any(last["host_queues"][1])
    assert (last["carry"].stage_params.contact_active == 0).any()
    assert _err(last["carry"].p_final, trace["carry0"].p_final) > 1e-4


def test_step_batched_and_donated_match_single_steps(serial_trace):
    """step_batched at B=2 (the first scenario the fixture's first tick,
    the second with another warm start, base velocity and measurement)
    equals single-engine steps (1e-9 relative to the largest entry: the
    batched products sum in another order); step_batched_donated writes
    into the passed carry and equals step_batched bit for bit."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    trace = serial_trace
    fused, carry = trace["fused"], trace["carry0"]
    cb = fused.tile_carry(carry, 2)
    cb = cb._replace(xs=cb.xs + torch.tensor([0.0, 1e-3], dtype=torch.float64)[:, None, None],
                     velocity_base=cb.velocity_base * torch.tensor([[1.0], [0.5]]))
    xb = torch.as_tensor(trace["xs_meas"][:2])
    mine = tree_map(torch.clone, cb)
    cb2, rb = fused.step_batched(cb, xb)
    first = trace["out"][0]
    c_1, r_1 = fused.step(tree_map(lambda a: a[1], cb), xb[1])
    for i, (c_i, r_i) in enumerate(((first["carry"], first["res"][0]), (c_1, r_1))):
        assert _rel(rb.xs[i], r_i.xs) <= 1e-9
        assert _rel(rb.us[i], r_i.us) <= 1e-9
        assert _queues(cb2.land[i]) == _queues(c_i.land)
        assert _err(cb2.stage_params.foot_ref_p[i], c_i.stage_params.foot_ref_p) <= 1e-12
    ptrs = [a.data_ptr() for a in _leaves(mine)]
    cb_don, rb_don = fused.step_batched_donated(mine, xb)
    assert [a.data_ptr() for a in _leaves(cb_don)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cb_don), _leaves(cb2)))
    assert torch.equal(rb_don.us, rb.us)


def test_step_donated_and_self_rollout_match_step(serial_trace):
    """step_donated fed a view of the carry it overwrites
    (`step_donated(carry, carry.xs[1])`) writes into the passed carry and
    equals step bit for bit; self_rollout leaves its carry as it was and
    equals step fed its own xs[1]."""
    from simple_mpc_tpu_torch.ocp.base import tree_map

    trace = serial_trace
    fused, carry0 = trace["fused"], trace["carry0"]
    before = tree_map(torch.clone, carry0)
    ref, mine = tree_map(torch.clone, carry0), tree_map(torch.clone, carry0)
    ptrs = [a.data_ptr() for a in _leaves(mine)]
    c_ref, r_ref = fused.step(ref, ref.xs[1])
    c_don, r_don = fused.step_donated(mine, mine.xs[1])
    assert [a.data_ptr() for a in _leaves(c_don)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_leaves(c_don), _leaves(c_ref)))
    assert all(torch.equal(a, b) for a, b in zip(r_don, r_ref))

    c_end, (us0, xs1, prim) = fused.self_rollout(carry0, 1)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(carry0), _leaves(before)))
    assert torch.equal(us0[0], r_ref.us[0]) and torch.equal(xs1[0], r_ref.xs[1])
    assert torch.equal(prim[0], r_ref.prim_res)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(c_end), _leaves(c_ref)))
    assert torch.isfinite(us0).all() and bool((prim < 1e-2).all())


def test_cpu_tick_reaches_the_twins(trace):
    """On CPU tensors every tick of the trace ran the twins: no kernel
    counted a launch."""
    assert trace["no_launch"] == [True] * TICKS


def test_tick_routes_and_refusals(monkeypatch):
    """On a CUDA tensor `tick_refs` hands a Talos OCP (6D feet, 23 joints)
    to `wide_tick_refs` and keeps Go2 (kinodynamics and full dynamics) on
    `tick.cu`; a queue wider than TICK_MAX_QUEUE is refused with
    NotImplementedError before any constant is packed or kernel built."""
    from types import SimpleNamespace

    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import (make_go2_fulldynamics, make_go2_kinodynamics,
                                              make_talos_kinodynamics)

    talos, _, _ = make_talos_kinodynamics(2, device="cpu")
    go2, _, _ = make_go2_kinodynamics(2, device="cpu")
    fd, _, _ = make_go2_fulldynamics(2, device="cpu")
    assert [kernels.stage_route(o) for o in (talos, go2, fd)] == ["wide", "narrow", "narrow"]

    calls = []
    monkeypatch.setattr(kernels, "_tick_cuda",
                        lambda f, c, x, wide=False: calls.append(wide) or "out")
    x = SimpleNamespace(device=torch.device("cuda", 0))
    for ocp, wide in ((talos, True), (go2, False), (fd, False)):
        n, nw = kernels.tick_refs.launches, kernels.wide_tick_refs.launches
        assert kernels.tick_refs(SimpleNamespace(ocp=ocp), None, x) == "out"
        assert calls[-1] is wide
        assert (kernels.wide_tick_refs.launches - nw, kernels.tick_refs.launches - n) == (
            (1, 0) if wide else (0, 1))
    monkeypatch.undo()

    def refuse(*a, **k):
        raise AssertionError("the constants were packed before the refusal")

    monkeypatch.setattr(kernels, "_stage_consts", refuse)
    wide_q = torch.zeros((1, 2, kernels.TICK_MAX_QUEUE + 1), dtype=torch.int32)
    carry = SimpleNamespace(plan=torch.zeros((1, 12, 2)), takeoff=wide_q, land=wide_q)
    fused = SimpleNamespace(ocp=talos, settings=None, T=2)
    for wide in (False, True):
        with pytest.raises(NotImplementedError, match="events a foot"):
            kernels._tick_cuda(fused, carry, torch.zeros((1, talos.nq + talos.nv)), wide)


@pytest.mark.cuda
def test_wide_tick_refs_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.mpc import FusedMPC

    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        mpc = host_mpc("talos", device="cuda", dtype=dtype)
        fused = FusedMPC(mpc)
        cb = fused.tile_carry(fused.make_carry(mpc), 4)
        rng = np.random.default_rng(2)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        cb = cb._replace(now=torch.tensor([0, 1, 1, 0], dtype=torch.int32, device="cuda"),
                         velocity_base=cb.velocity_base + t(0.1 * rng.normal(size=(4, 6))))
        for _ in range(5):
            x = cb.xs[:, 1] + t(0.01 * rng.normal(size=cb.xs[:, 1].shape))
            x[:, 3:7] /= x[:, 3:7].norm(dim=-1, keepdim=True)
            n, n_narrow = kernels.wide_tick_refs.launches, kernels.tick_refs.launches
            got = kernels.tick_refs(fused, cb, x)
            assert kernels.wide_tick_refs.launches == n + 1
            assert kernels.tick_refs.launches == n_narrow
            want = kernels.tick_refs_plain(fused, cb, x)
            for k in ("walking", "takeoff", "land"):
                assert torch.equal(getattr(got, k), getattr(want, k)), k
            for k in ("p_init", "p_final", "refs", "com_ref"):
                a, b = getattr(got, k), getattr(want, k)
                assert float((a - b).abs().max() / b.abs().max()) <= tol, (dtype, k)
            cb, _ = fused.step_batched(cb, x)
