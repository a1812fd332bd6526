"""PyTorch port vs JAX package: the Talos closed loop's layers below the
MPC (23 joints, two 6D quad feet), f64 CPU, the same numpy inputs made
from seeds.

* The 6D assembly twin (`KinodynamicsID._assemble_core`: wrench cones of
  17 rows a foot, LOCAL_WORLD_ALIGNED [lin; ang] contact rows and their
  J-dot v) against JAX's on H, g, A, l, u, M, h and Jc' at the standing
  state and a perturbed one, with both feet and with the left foot lifted,
  with the example's IDSettings and with `contact_motion_equality`: within
  1e-10 relative to max(1, largest entry).
* `_solve_core` (assembly, 60 ADMM steps, torques): tau, ddq and the
  wrenches cold and warm-started, within 1e-9.
* The wrappers' routes (`kernels.body_route`) and refusals.

The simulator step and the 6D state derivative against JAX are in
tests/test_torch_talos_sim.py (a file of their own, so that their JAX
compiles run on another worker than the ID's).

The `cuda` tests hold the wide kernels and both instances of K11 to their
twins on the card and count their launches; they import no JAX (on the
card: `python -m pytest --noconftest -m cuda tests/test_torch_talos_id_sim.py`).
"""
import types

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-10
SOLVE_TOL = 1e-9
CONTACTS = dict(both=[True, True], left_lifted=[False, True])


def _err(a, b):
    """max|a - b| relative to max(1, largest entry of b)."""
    a = a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0)) if a.size else 0.0


def _perturbed(x0, nq, scale, rng):
    q = x0[:nq] + scale * rng.normal(size=nq)
    q[3:7] /= np.linalg.norm(q[3:7])
    return q


@pytest.fixture(scope="module")
def ids():
    """A JAX and a port KinodynamicsID per settings (the Talos example's,
    and with contact_motion_equality).  The JAX one with
    contact_motion_equality is a copy of the example's with the setting
    switched (its constructor reads the setting only in the dry-run
    solve), as in tests/test_torch_id_sim.py."""
    import copy
    import dataclasses

    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.id.kinodynamics_id import IDSettings as JSettings
    from simple_mpc_tpu.id.kinodynamics_id import KinodynamicsID as JID
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.examples.talos_kinodynamics import ID_SETTINGS
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings, KinodynamicsID

    jmh, tmh = jconfigs.talos_handler(), tconfigs.talos_handler()
    jid = JID(jmh, 1e-3, JSettings(**ID_SETTINGS))
    jeq = copy.copy(jid)
    jeq.settings = dataclasses.replace(jid.settings, contact_motion_equality=True)
    jeq._targets, jeq._qp_warm, jeq._last = dict(jid._targets), None, None
    out = {eq: (j, KinodynamicsID(tmh, 1e-3, IDSettings(**ID_SETTINGS,
                                                        contact_motion_equality=eq),
                                  device="cpu"))
           for eq, j in ((False, jid), (True, jeq))}
    return out, np.asarray(jmh.reference_state), tmh.model.nq, tmh.model.nv


def _targets(x0, nq, nv, rng, contacts, moved):
    q_t = _perturbed(x0, nq, 0.01, rng) if moved else x0[:nq]
    f_t = 10.0 * rng.normal(size=(2, 6)) + [0.0, 0.0, 450.0, 0.0, 0.0, 0.0]
    return q_t, 0.1 * rng.normal(size=nv), rng.normal(size=nv), CONTACTS[contacts], f_t


@pytest.mark.parametrize("equality", [False, True])
@pytest.mark.parametrize("contacts", list(CONTACTS))
@pytest.mark.parametrize("state", range(2))
def test_6d_assembly_twin_matches_jax(ids, equality, contacts, state):
    import jax.numpy as jnp

    (jid, tid), x0, nq, nv = ids[0][equality], *ids[1:]
    assert (tid.fdim, tid.nz, tid.n_cone) == (6, nv + 12, 17)
    rng = np.random.default_rng(30 + state)
    q = x0[:nq] if state == 0 else _perturbed(x0, nq, 0.02, rng)
    v = np.zeros(nv) if state == 0 else 0.1 * rng.normal(size=nv)
    target = _targets(x0, nq, nv, rng, contacts, state > 0)
    jid.set_target(*target)
    tid.set_target(*target)
    want = jid._assemble_core(jnp.asarray(q), jnp.asarray(v), dict(jid._targets))
    got = tid._assemble_core(torch.as_tensor(q)[None], torch.as_tensor(v)[None],
                             {k: a[None] for k, a in tid._targets.items()})
    for name, a, b in zip(("H", "g", "A", "l", "u", "M", "h", "JcT"), got, want):
        assert _err(a[0], b) < TOL, name


@pytest.mark.parametrize("warm", [False, True])
def test_6d_solve_core_matches_jax(ids, warm):
    """tau, ddq and the two wrenches of the assembly and 60 ADMM steps,
    from a cold start and warm-started from JAX's cold solution moved by
    0.01 in z."""
    import jax.numpy as jnp

    (jid, tid), x0, nq, nv = ids[0][False], *ids[1:]
    rng = np.random.default_rng(40)
    q, v = _perturbed(x0, nq, 0.02, rng), 0.1 * rng.normal(size=nv)
    target = _targets(x0, nq, nv, rng, "left_lifted", True)
    jid.set_target(*target)
    tid.set_target(*target)
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    jwarm = None
    if warm:
        cold = jid._solve_core(jq, jv, dict(jid._targets), None)[3]
        jwarm = (cold.z + 0.01, cold.y)
    jtau, jddq, jf, jsol = jid._solve_core(jq, jv, dict(jid._targets), jwarm)
    twarm = None if jwarm is None else tuple(torch.as_tensor(np.asarray(a))[None]
                                             for a in jwarm)
    ttau, tddq, tf, tsol = tid._solve_core(torch.as_tensor(q)[None], torch.as_tensor(v)[None],
                                           {k: a[None] for k, a in tid._targets.items()},
                                           twarm)
    for a, b in ((ttau[0], jtau), (tddq[0], jddq), (tf[0], jf), (tsol.y[0], jsol.y)):
        assert _err(a, b) < SOLVE_TOL
    assert float(np.abs(np.asarray(jf)[0]).max()) < 1e-6  # the lifted foot carries nothing


def _chain(nj):
    """A model stand-in for the kernels' layout checks: a free-flyer root
    and nj - 1 revolute joints in a chain."""
    from simple_mpc_tpu_torch.models.model import FREE, REVOLUTE

    return types.SimpleNamespace(
        njoints=nj, joint_types=[FREE] + [REVOLUTE] * (nj - 1),
        parents=[-1] + list(range(nj - 1)), idx_q=[0] + [6 + j for j in range(1, nj)],
        idx_v=[0] + [5 + j for j in range(1, nj)])


def test_routes_and_refusals():
    """Go2's point feet go to the Go2 units, Talos (23 joints, 6D feet, or
    its 3D simulator contacts) to the wide ones; more than 32 joints, more
    than 8 feet or a force size other than 3 and 6 are refused.  The
    wrappers take CPU tensors to their twins without counting a launch."""
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch import kernels

    go2, talos = tconfigs.go2_handler().model, tconfigs.talos_handler().model
    assert kernels.body_route(go2, 4, 3) == "narrow"
    assert kernels.body_route(go2, 4, 6) == "wide"
    assert kernels.body_route(talos, 2, 6) == "wide"
    assert kernels.body_route(talos, 2, 3) == "wide"
    assert kernels.body_route(_chain(32), 2, 6) == "wide"
    with pytest.raises(NotImplementedError, match="at most 32 joints"):
        kernels.body_route(_chain(33), 2, 6)
    with pytest.raises(NotImplementedError, match="8 feet"):
        kernels.body_route(talos, 9, 3)
    with pytest.raises(NotImplementedError, match="force size 3 or 6"):
        kernels.body_route(talos, 2, 4)

    ocp, mh, x0 = tconfigs.make_talos_kinodynamics(2, device="cpu")
    assert kernels.stage_route(ocp) == "wide"
    x, u = torch.as_tensor(x0)[None], ocp.get_reference_control(0)[None]
    p = type(ocp.problem.stage_params)(*(a[:1] for a in ocp.problem.stage_params))
    before = {k.__name__: k.launches for k in kernels.KERNELS}
    for fn in (kernels.state_derivative, kernels.wide_state_derivative):
        out = fn(ocp, x, u, p)
        assert out.shape == (1, 2 * ocp.nv) and torch.equal(out[0, : ocp.nv], x[0, ocp.nq:])
    assert {k.__name__: k.launches for k in kernels.KERNELS} == before
    for fn in (kernels.state_derivative, kernels.wide_state_derivative):
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            fn(ocp, x.to("meta"), u.to("meta"), p)


def _cuda_case(dtype):
    """The Talos example's ID and the simulator on the card, three
    perturbed Talos robots (both feet / left lifted / right lifted in
    contact; standing / left knee bent / base rising), and N=3 lanes of the
    state derivative on the Talos and Go2 examples' OCPs."""
    import chip_smoke

    ids, sim, idin, simin = chip_smoke.talos_id_sim_case("cuda", dtype, 3, seed=5)
    sd = {r: chip_smoke.state_derivative_case("cuda", dtype, 3, 6, r) for r in ("go2", "talos")}
    return ids[0], sim, idin, simin, sd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_talos_kernels_match_twins_on_cuda(dtype):
    """wide_id_assemble, qp_admm at Talos size, wide_sim_step and both
    state-derivative kernels against their twins on the same card tensors:
    f64 within 1e-10 (the QP within max(1e-10, ten times the twin's own
    response to a 1e-15 move of its data, chip_smoke.qp_spread)), f32
    within chip_smoke.py's F32_TALOS_TOL of the twin in f64 (masks equal);
    each wrapper call counts one launch of its own kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    from simple_mpc_tpu_torch import kernels

    f32 = dtype == torch.float32
    tol = chip_smoke.F32_TALOS_TOL if f32 else dict.fromkeys(chip_smoke.F32_TALOS_TOL, 1e-10)
    idq, sim, idin, simin, sd = _cuda_case(dtype)
    as64 = (lambda x: x.double()) if f32 else (lambda x: x)
    q, v, targets = idin["q"], idin["v"], idin["targets"]
    kernels.reset_launches()
    got = kernels.id_assemble(idq, q, v, targets)
    want = idq._assemble_core(as64(q), as64(v), {k: as64(a) for k, a in targets.items()})
    for a, b in zip(got, want):
        assert chip_smoke.bound_rel(a, b) < tol["wide_id_assemble"]
    H, g, A, l, u = idq._assemble_core(q, v, targets)[:5]
    sol = kernels.qp_admm(H, g, A, l, u, iters=60)
    ref = kernels.solve_qp(*(as64(x) for x in (H, g, A, l, u)), 60)
    qtol = tol["qp_admm"] if f32 else max(
        1e-10, 10.0 * chip_smoke.qp_spread(H, g, A, l, u, None, None, ref))
    assert chip_smoke.bound_rel(sol.z, ref.z) < qtol
    assert chip_smoke.bound_rel(sol.y, ref.y) < qtol
    step = kernels.sim_step(sim, *simin)
    ref = sim.step_plain(*(as64(x) for x in simin))
    torch.cuda.synchronize()
    assert torch.equal(step.active, ref.active.to(dtype))
    for a, b in zip(step[:3], ref[:3]):
        assert chip_smoke.bound_rel(a, b) < tol["wide_sim_step"]
    for robot, name in (("go2", "state_derivative"), ("talos", "wide_state_derivative")):
        ocp, x, uu, p = sd[robot]
        out = kernels.state_derivative(ocp, x, uu, p)
        ocp64, x64, u64, p64 = chip_smoke.state_derivative_case("cuda", torch.float64, 3, 6,
                                                                robot)
        ref = kernels.state_derivative_plain(ocp64, x64, u64, p64)
        assert chip_smoke.bound_rel(out, ref) < tol[name]
    counts = {k.__name__: k.launches for k in kernels.KERNELS}
    assert {k: counts[k] for k in ("wide_id_assemble", "qp_admm", "wide_sim_step",
                                   "state_derivative", "wide_state_derivative",
                                   "id_assemble", "sim_step")} == dict(
        wide_id_assemble=1, qp_admm=1, wide_sim_step=1, state_derivative=1,
        wide_state_derivative=1, id_assemble=0, sim_step=0)
