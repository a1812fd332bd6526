"""PyTorch port vs JAX package: the closed loop's inverse-dynamics QP (K8),
its assembly, the rigid-contact simulator (K10), the interpolator and the
friction compensation, f64 CPU, the same numpy inputs made from seeds.

* `solve_qp` (the twin of `kernels.qp_admm`) against JAX `solve_qp` on the
  random QPs of tests/test_native_qp.py (seeds 0-2, 400 steps) and on one
  Go2 ID QP cold and warm-started: z and y within 1e-9 relative to
  max(1, largest entry).
* The assembly twin (`KinodynamicsID._assemble_core`) against JAX's on H,
  g, A, l, u, M, h and Jc' at the standing state and two perturbed states,
  with all feet and with a diagonal pair in contact, with the example's
  IDSettings and with `contact_motion_equality`: within 1e-9.
* `KinodynamicsID.solve`: the torques, accelerations and forces over three
  consecutive warm-started solves from the same targets and warm start
  (carried from the JAX ID to the port's by `convert.id_state_from_numpy`),
  within 1e-9.
* `Simulator.step` (the twin of `kernels.sim_step`) against JAX's in free
  fall, standing and with one foot lifted: the two contact masks equal,
  q, v and the world forces within 1e-9.
* `Interpolator` (one delay and a tick's delays at once) and
  `FrictionCompensation` within 1e-12.

The `cuda` tests hold the three CUDA kernels to their twins on the card at
B=2 and count their launches; they import no JAX (on the card:
`python -m pytest --noconftest -m cuda tests/test_torch_id_sim.py`).
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-9
ID_SETTINGS = dict(kp_base=10.0, kp_posture=10.0, kp_contact=50.0, w_base=1.0,
                   w_posture=0.1, w_contact_motion=100.0, w_contact_force=0.05, qp_iters=60)
DIAGONAL = [True, False, False, True]


def _err(a, b):
    """max|a - b| relative to max(1, largest entry of b)."""
    a = a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0)) if a.size else 0.0


def random_qp(n=24, m=40, seed=0):
    """tests/test_native_qp.py:15-27: equalities, boxes and one-sided rows."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(n, n))
    H = W @ W.T / n + 0.5 * np.eye(n)
    g = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l = np.full(m, -1e20)
    u = np.full(m, 1e20)
    l[:5] = u[:5] = rng.normal(size=5) * 0.1
    l[5:20] = -1.0
    u[5:20] = 1.0
    u[20:30] = 0.5
    return H, g, A, l, u


def _perturbed(x0, nq, scale, rng):
    q = x0[:nq] + scale * rng.normal(size=nq)
    q[3:7] /= np.linalg.norm(q[3:7])
    return q


@pytest.fixture(scope="module")
def ids():
    """A JAX and a port KinodynamicsID per settings (the example's, and
    with contact_motion_equality), on the Go2.  The JAX one with
    contact_motion_equality is a copy of the example's with the setting
    switched: its constructor reads the setting nowhere but in the dry-run
    solve, which would compile one more XLA program of the assembly and the
    QP, and every test here sets its own targets and warm start."""
    import copy
    import dataclasses

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.id.kinodynamics_id import IDSettings as JSettings
    from simple_mpc_tpu.id.kinodynamics_id import KinodynamicsID as JID
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID

    jmh, tmh = jconfigs.go2_handler(), tconfigs.go2_handler()
    jid = JID(jmh, 1e-3, JSettings(**ID_SETTINGS))
    jeq = copy.copy(jid)
    jeq.settings = dataclasses.replace(jid.settings, contact_motion_equality=True)
    jeq._targets, jeq._qp_warm, jeq._last = dict(jid._targets), None, None
    out = {eq: (j, KinodynamicsID(tmh, 1e-3, IDSettings(**ID_SETTINGS,
                                                        contact_motion_equality=eq),
                                  device="cpu"))
           for eq, j in ((False, jid), (True, jeq))}
    return out, np.asarray(jmh.reference_state)


@pytest.mark.parametrize("seed", range(3))
def test_qp_twin_matches_jax(seed):
    from simple_mpc_tpu.id.qp import solve_qp as jsolve
    from simple_mpc_tpu_torch import kernels

    H, g, A, l, u = random_qp(seed=seed)
    want = jsolve(H, g, A, l, u, iters=400)
    got = kernels.qp_admm(*(torch.as_tensor(x)[None] for x in (H, g, A, l, u)), iters=400)
    assert _err(got.z[0], want.z) < TOL
    assert _err(got.y[0], want.y) < TOL
    assert float(got.prim_res[0]) < 1e-5


@pytest.mark.parametrize("warm", [False, True])
def test_qp_twin_matches_jax_on_a_go2_id_qp(ids, warm):
    import jax.numpy as jnp

    from simple_mpc_tpu.id.qp import solve_qp as jsolve
    from simple_mpc_tpu_torch.id.qp import solve_qp

    (jid, _), x0 = ids[0][False], ids[1]
    rng = np.random.default_rng(4)
    q, v = _perturbed(x0, 19, 0.02, rng), 0.1 * rng.normal(size=18)
    H, g, A, l, u = (np.asarray(a) for a in jid._assemble_core(
        jnp.asarray(q), jnp.asarray(v), dict(jid._targets))[:5])
    z0 = y0 = None
    if warm:
        cold = jsolve(H, g, A, l, u, iters=60)
        z0, y0 = np.asarray(cold.z) + 0.01, np.asarray(cold.y)
    want = jsolve(H, g, A, l, u, iters=60, z0=z0, y0=y0)
    t = torch.as_tensor
    got = solve_qp(*(t(x) for x in (H, g, A, l, u)), iters=60,
                   z0=None if z0 is None else t(z0), y0=None if y0 is None else t(y0))
    assert _err(got.z, want.z) < TOL
    assert _err(got.y, want.y) < TOL


@pytest.mark.parametrize("equality", [False, True])
@pytest.mark.parametrize("contacts", ["all", "diagonal"])
@pytest.mark.parametrize("state", range(3))
def test_assembly_twin_matches_jax(ids, equality, contacts, state):
    import jax.numpy as jnp

    (jid, tid), x0 = ids[0][equality], ids[1]
    rng = np.random.default_rng(20 + state)
    q = x0[:19] if state == 0 else _perturbed(x0, 19, 0.02, rng)
    v = np.zeros(18) if state == 0 else 0.1 * rng.normal(size=18)
    q_t = x0[:19] if state == 0 else _perturbed(x0, 19, 0.01, rng)
    v_t, a_t = 0.1 * rng.normal(size=18), rng.normal(size=18)
    f_t = rng.normal(size=(4, 3)) + [0.0, 0.0, 30.0]
    c = [True] * 4 if contacts == "all" else DIAGONAL
    jid.set_target(q_t, v_t, a_t, c, f_t)
    tid.set_target(q_t, v_t, a_t, c, f_t)
    want = jid._assemble_core(jnp.asarray(q), jnp.asarray(v), dict(jid._targets))
    got = tid._assemble_core(torch.as_tensor(q)[None], torch.as_tensor(v)[None],
                             {k: a[None] for k, a in tid._targets.items()})
    for name, a, b in zip(("H", "g", "A", "l", "u", "M", "h", "JcT"), got, want):
        assert _err(a[0], b) < TOL, name


@pytest.mark.parametrize("equality", [False, True])
def test_warm_started_solves_match_jax(ids, equality):
    """Three solves in a row from a zero warm start (the cold start's
    iterates: `solve_qp` starts from zeros), each warm-started from the
    last; the JAX ID's targets and warm start are carried to the port's."""
    from simple_mpc_tpu_torch import convert

    (jid, tid), x0 = ids[0][equality], ids[1]
    rng = np.random.default_rng(7)
    q_t = _perturbed(x0, 19, 0.01, rng)
    jid.set_target(q_t, np.zeros(18), np.zeros(18), DIAGONAL, [[0.0, 0.0, 37.0]] * 4)
    jid._qp_warm = (np.zeros(tid.nz), np.zeros(tid._qp_warm[1].shape[-1]))
    convert.id_state_from_numpy(tid, jid._targets, jid._qp_warm)
    for _ in range(3):
        q, v = _perturbed(x0, 19, 0.01, rng), 0.05 * rng.normal(size=18)
        assert _err(tid.solve(0.0, q, v), jid.solve(0.0, q, v)) < TOL
        assert _err(tid.get_accelerations(), jid.get_accelerations()) < TOL
        assert _err(tid.get_forces(), jid.get_forces()) < TOL


@pytest.fixture(scope="module")
def sims():
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.sim import SimSettings as JSimSettings
    from simple_mpc_tpu.sim import Simulator as JSim
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    jmh, tmh = jconfigs.go2_handler(), tconfigs.go2_handler()
    ground = foot_height(tmh)
    return (JSim(jmh.model, jmh.feet_frame_ids, JSimSettings(dt=1e-3, ground_height=ground)),
            Simulator(tmh.model, tmh.feet_frame_ids, SimSettings(dt=1e-3, ground_height=ground),
                      device="cpu"),
            np.asarray(jmh.reference_state))


def _jax_masks(js, q, v, tau):
    """The two contact masks of JAX's `Simulator.step`, recomputed with its
    own functions (simple_mpc_tpu/sim/simulator.py:133-144)."""
    import jax.numpy as jnp

    from simple_mpc_tpu.ops import kinematics as kin

    s = js.settings
    q, v = jnp.asarray(q), jnp.asarray(v)
    oR, op = kin.fk(js.model, q)
    fR, fp = kin.frame_placements(js.model, oR, op)
    feet_p = jnp.stack([fp[f] for f in js.feet_fids])
    feet_R = jnp.stack([fR[f] for f in js.feet_fids])
    active0 = (s.ground_height - feet_p[:, 2] > -s.contact_margin).astype(q.dtype)
    anchors = feet_p.at[:, 2].set(s.ground_height)
    tau_full = jnp.concatenate([jnp.zeros(6), jnp.asarray(tau)])
    _, f_loc = js._dynamics(q, v, tau_full, active0, anchors)
    f_w = jnp.einsum("kij,kj->ki", feet_R, f_loc)
    return np.stack([np.asarray(active0), np.asarray(active0 * (f_w[:, 2] > 0.0))])


@pytest.mark.parametrize("case", ["free_fall", "standing", "one_foot_lifted"])
def test_simulator_step_matches_jax(sims, case):
    import jax.numpy as jnp

    js, ts, x0 = sims
    rng = np.random.default_rng(["free_fall", "standing", "one_foot_lifted"].index(case))
    q = x0[:19].copy()
    if case == "free_fall":
        q[2] += 0.05
    if case == "one_foot_lifted":
        q[8] += 0.3  # the FL thigh
    v, tau = 0.05 * rng.normal(size=18), 0.5 * rng.normal(size=12)
    jq, jv, jf = js.step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
    got = ts.step_plain(*(torch.as_tensor(x)[None] for x in (q, v, tau)))
    masks = _jax_masks(js, q, v, tau)
    np.testing.assert_array_equal(got.active[0].numpy(), masks)
    expect = dict(free_fall=0, standing=4, one_foot_lifted=3)[case]
    assert masks[0].sum() == expect
    for a, b in zip(got[:3], (jq, jv, jf)):
        assert _err(a[0], b) < TOL
    # the public step gives the same (unbatched) state
    for a, b in zip(ts.step(*(torch.as_tensor(x) for x in (q, v, tau))), got[:3]):
        assert torch.equal(a, b[0])


def test_interpolator_and_friction_match_jax():
    import jax.numpy as jnp

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.utils import FrictionCompensation as JFriction
    from simple_mpc_tpu.utils import Interpolator as JInterp
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.utils.friction import FrictionCompensation
    from simple_mpc_tpu_torch.utils.interpolator import Interpolator

    jmh, tmh = jconfigs.go2_handler(), tconfigs.go2_handler()
    rng = np.random.default_rng(3)
    x0 = np.asarray(jmh.reference_state)
    xs = np.stack([np.concatenate([_perturbed(x0, 19, 0.05, rng), rng.normal(size=18)])
                   for _ in range(3)])
    ji, ti = JInterp(jmh.model), Interpolator(tmh.model)
    t = torch.as_tensor
    delays = [0.0, 0.003, 0.0099, 0.0125, 0.02, 0.031]
    for d in delays:
        assert _err(ti.interpolate_configuration(d, 0.01, t(xs[:, :19])),
                    ji.interpolate_configuration(d, 0.01, xs[:, :19])) < 1e-12
        assert _err(ti.interpolate_state(d, 0.01, t(xs)), ji.interpolate_state(d, 0.01, xs)) < 1e-12
        assert _err(ti.interpolate_linear(d, 0.01, t(xs[:, 19:])),
                    ji.interpolate_linear(d, 0.01, xs[:, 19:])) < 1e-12
        cs = [[True, False], [False, True], [True, True]]
        assert ti.interpolate_contacts(d, 0.01, cs) == list(
            np.asarray(ji.interpolate_contacts(d, 0.01, jnp.asarray(cs))))
    # a tick's delays at once: the same samples
    for name in ("interpolate_configuration", "interpolate_state", "interpolate_linear"):
        data = xs[:, :19] if name == "interpolate_configuration" else (
            xs if name == "interpolate_state" else xs[:, 19:])
        got = getattr(ti, name)(delays, 0.01, t(data))
        want = np.stack([np.asarray(getattr(ji, name)(d, 0.01, data)) for d in delays])
        assert _err(got, want) < 1e-12

    jf = JFriction(jmh.model)
    tf = FrictionCompensation(tmh.model, device="cpu")
    for _ in range(3):
        vel, tau = rng.normal(size=12), rng.normal(size=12)
        vel[0] = 0.0
        assert _err(tf.compute_friction(t(vel), t(tau)), jf.compute_friction(vel, tau)) < 1e-12
    with pytest.raises(ValueError, match="Velocity"):
        tf.compute_friction(t(np.zeros(3)), t(np.zeros(12)))


def test_id_takes_6d_contacts():
    """A handler with quad feet (Talos's soles) gives the 6D ID of the JAX
    package: 6D wrenches, the 17-row wrench cone of JAX `wrench_cone_mat`
    for the settings' Lfoot and Wfoot, nv + 12 variables, 98 rows (110
    with the motion equalities) and a finite dry-run solve carrying the
    weight on the two soles.  Its assembly and solves are held to JAX's in
    tests/test_torch_talos_id_sim.py."""
    from simple_mpc_tpu.ocp.cones import wrench_cone_mat
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID

    mh = tconfigs.talos_handler()
    settings = dict(ID_SETTINGS, Lfoot=0.1, Wfoot=0.075)
    for eq, rows in ((False, 98), (True, 110)):
        idq = KinodynamicsID(mh, 1e-3, IDSettings(**settings, contact_motion_equality=eq),
                             device="cpu")
        assert (idq.fdim, idq.nz, kernels._id_rows(idq)) == (6, mh.model.nv + 12, rows)
        np.testing.assert_array_equal(idq._cone_mat, wrench_cone_mat(0.6, 0.1, 0.075))
        f = idq.get_forces()
        assert f.shape == (2, 6) and bool(torch.isfinite(f).all())
        assert abs(float(f[:, 2].sum()) - idq.weight) < 0.05 * idq.weight


def test_cpu_tensors_never_count_launches_and_other_devices_raise():
    from simple_mpc_tpu_torch import kernels

    H, g, A, l, u = (torch.as_tensor(x)[None] for x in random_qp(6, 8, seed=1))
    n = kernels.qp_admm.launches
    kernels.qp_admm(H, g, A, l, u, iters=5)
    assert kernels.qp_admm.launches == n
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.qp_admm(*(x.to("meta") for x in (H, g, A, l, u)), iters=5)


def _cuda_case(dtype):
    """The example's ID and the simulator on the card, and two perturbed
    Go2 robots (all feet / a diagonal pair in contact; standing / one foot
    lifted)."""
    from simple_mpc_tpu_torch.configs import go2_handler
    from simple_mpc_tpu_torch.examples.loop import foot_height
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID
    from simple_mpc_tpu_torch.sim.simulator import SimSettings, Simulator

    mh = go2_handler()
    idq = KinodynamicsID(mh, 1e-3, IDSettings(**ID_SETTINGS), device="cuda", dtype=dtype)
    sim = Simulator(mh.model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device="cuda")
    rng = np.random.default_rng(9)
    x0 = np.asarray(mh.reference_state)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device="cuda")  # noqa: E731
    q = t([_perturbed(x0, 19, 0.02, rng) for _ in range(2)])
    v = t(0.1 * rng.normal(size=(2, 18)))
    targets = dict(q_t=t([_perturbed(x0, 19, 0.01, rng) for _ in range(2)]),
                   v_t=t(0.1 * rng.normal(size=(2, 18))), a_t=t(rng.normal(size=(2, 18))),
                   contacts=t([[1.0] * 4, [1.0, 0.0, 0.0, 1.0]]),
                   f_t=t(rng.normal(size=(2, 4, 3)) + [0.0, 0.0, 30.0]))
    qs = np.repeat(x0[None, :19], 2, 0)
    qs[1, 8] += 0.3
    return idq, sim, (q, v, targets), (t(qs), t(0.05 * rng.normal(size=(2, 18))),
                                       t(0.5 * rng.normal(size=(2, 12))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_twins_on_cuda(dtype):
    """The three kernels against their twins on the same card tensors: f64
    within 1e-10, f32 within chip_smoke.py's tolerances of the twin in f64
    (masks equal); each wrapper call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    from simple_mpc_tpu_torch import kernels

    f32 = dtype == torch.float32
    idq, sim, (q, v, targets), simin = _cuda_case(dtype)
    kernels.reset_launches()
    got = kernels.id_assemble(idq, q, v, targets)
    want = idq._assemble_core(*((q.double(), v.double(), {k: a.double() for k, a in
                                                          targets.items()}) if f32
                                else (q, v, targets)))
    tol = chip_smoke.F32_ID_TOL if f32 else 1e-10
    for a, b in zip(got, want):
        assert chip_smoke.bound_rel(a, b) < tol
    H, g, A, l, u = idq._assemble_core(q, v, targets)[:5]
    sol = kernels.qp_admm(H, g, A, l, u, iters=60)
    ref = kernels.solve_qp(*((x.double() for x in (H, g, A, l, u)) if f32 else
                             (H, g, A, l, u)), 60)
    tol = chip_smoke.F32_QP_TOL if f32 else 1e-10
    assert chip_smoke.bound_rel(sol.z, ref.z) < tol and chip_smoke.bound_rel(sol.y, ref.y) < tol
    step = kernels.sim_step(sim, *simin)
    ref = sim.step_plain(*((x.double() for x in simin) if f32 else simin))
    torch.cuda.synchronize()
    assert torch.equal(step.active, ref.active.to(dtype))
    tol = chip_smoke.F32_SIM_TOL if f32 else 1e-10
    for a, b in zip(step[:3], ref[:3]):
        assert chip_smoke.bound_rel(a, b) < tol
    assert (kernels.id_assemble.launches, kernels.qp_admm.launches,
            kernels.sim_step.launches) == (1, 1, 1)


@pytest.mark.cuda
def test_closed_loop_step_launches_each_kernel_once_on_cuda():
    """One inner step of the closed loop (ID solve, simulator step) on the
    card launches each of the three kernels once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels

    idq, sim, (q, v, _), _ = _cuda_case(torch.float32)
    kernels.reset_launches()
    tau = idq.solve(0.0, q[0], v[0])
    q1, v1, f = sim.step(q[0], v[0], tau)
    torch.cuda.synchronize()
    assert q1.shape == (19,) and f.shape == (4, 3) and bool(torch.isfinite(q1).all())
    assert (kernels.id_assemble.launches, kernels.qp_admm.launches,
            kernels.sim_step.launches) == (1, 1, 1)
