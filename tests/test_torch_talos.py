"""PyTorch port vs JAX package: Talos kinodynamics (23 joints, two 6D quad
feet) — the model, the stage twins and the stage kernels' routing.

  * the model: `robots.load_talos` (the host copies of `models/srdf.py` and
    `models/reduce.py`) equal to the JAX package's, field by field, and a
    few of tests/test_reduce.py's cases on the port's `reduce.py`;
  * `configs.talos_handler`'s foot placements at half_sitting to 1e-12;
  * `KinodynamicsOCP.stage_eval_soa` against the JAX package's at T=4 (both
    feet down, the left lifted, both, the right lifted), f64: r, geq, h and
    xnext to 1e-12 relative to max(1, largest entry), without and with the
    two 17-row wrench cones;
  * the twins of K1+K2 (`kernels.stage_linearize`, the same twin as
    `wide_stage_linearize`) against `_linearize_traj_soa`, and of K5
    against `_linearize_term`, f64, with the wrench cones, the terminal DCM
    equality and control scaling: 1e-9 relative to the largest entry
    (forward tangents and Gauss-Newton sums in another order);
  * `kernels.stage_route`: Go2 to the kernels of csrc/linearize.cu, Talos
    to the wide ones; more than 32 joints, 8 feet or 128 tangent
    directions, or a force size other than 3 and 6, refused.
Two ProxDDP iterations and two host-MPC ticks on Talos against JAX are in
tests/test_torch_talos_solver.py (their JAX solver compile is a file's
worth of time on its own).

The `cuda`-marked test holds the three wide kernels to their twins on the
card; it needs no JAX (`python -m pytest --noconftest -m cuda
tests/test_torch_talos.py`).
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

T = 4
TOL_STAGE = 1e-12
TOL_LIN = 1e-9
MU = 1e-2


def _err(a, b):
    """max|a - b| / max(1, max|b|)."""
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _rel(a, b):
    """max|a - b| / max|b|."""
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().double().cpu().numpy() if torch.is_tensor(b) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def talos_models():
    from simple_mpc_tpu.models import robots as jrobots
    from simple_mpc_tpu_torch.models import robots

    return {red: (jrobots.load_talos(reduced=red), robots.load_talos(reduced=red))
            for red in (True, False)}


@pytest.mark.parametrize("reduced", [True, False])
def test_load_talos_matches_jax(talos_models, reduced):
    """Every field of the port's Talos equals the JAX package's exactly
    (same numpy arithmetic on the same files)."""
    jm, tm = talos_models[reduced]
    for f in ("name", "joint_names", "joint_types", "parents", "idx_q", "idx_v"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert (tm.nq, tm.nv, tm.njoints) == (jm.nq, jm.nv, jm.njoints)
    for f in ("jR", "jp", "axes", "mass", "com", "inertia", "lower_limit", "upper_limit",
              "velocity_limit", "effort_limit", "damping", "friction", "rotor_inertia",
              "rotor_gear_ratio", "gravity"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert sorted(tm.reference_configurations) == sorted(jm.reference_configurations)
    for k, q in jm.reference_configurations.items():
        np.testing.assert_array_equal(tm.reference_configurations[k], q, err_msg=k)
    assert len(tm.frames) == len(jm.frames)
    for a, b in zip(tm.frames, jm.frames):
        assert (a.name, a.parent_joint) == (b.name, b.parent_joint)
        np.testing.assert_array_equal(a.R, b.R, err_msg=a.name)
        np.testing.assert_array_equal(a.p, b.p, err_msg=a.name)
    if reduced:  # the widths the wide kernels take (nj=23, nq=29, nv=28)
        assert (tm.njoints, tm.nq, tm.nv) == (23, 29, 28)
        assert all(tm.idx_q[j] == 6 + j for j in range(1, tm.njoints))


def test_reduced_talos_keeps_mass_and_kinematics(talos_models):
    """tests/test_reduce.py's mass and FK/CoM cases on the port's copy of
    `build_reduced_model`: the reduced model's total mass, sole and
    gripper placements and CoM at random configurations equal the full
    model's with the locked joints at half_sitting (1e-10), through the
    port's own kinematics (`ops/soa.py`)."""
    from simple_mpc_tpu_torch.models.robots import TALOS_LOCKED_JOINTS
    from simple_mpc_tpu_torch.ops import soa

    _, red = talos_models[True]
    _, full = talos_models[False]
    assert np.isclose(red.total_mass(), full.total_mass(), rtol=1e-12)
    kept = [j for j, n in enumerate(full.joint_names) if n not in TALOS_LOCKED_JOINTS]
    rng = np.random.default_rng(0)
    for _ in range(3):
        q_r = np.array(red.reference_configurations["half_sitting"])
        dq = 0.3 * rng.standard_normal(red.nq)
        q_r[:3] += dq[:3]
        q_r[7:] = np.clip(q_r[7:] + dq[7:], red.lower_limit[7:] + 1e-3,
                          red.upper_limit[7:] - 1e-3)
        quat = rng.standard_normal(4)
        q_r[3:7] = quat / np.linalg.norm(quat)
        q_f = np.array(full.reference_configurations["half_sitting"])
        for new_j, old_j in enumerate(kept):
            n = 7 if new_j == 0 else 1
            q_f[full.idx_q[old_j]: full.idx_q[old_j] + n] = \
                q_r[red.idx_q[new_j]: red.idx_q[new_j] + n]
        out = []
        for m, q in ((red, q_r), (full, q_f)):
            qt = torch.as_tensor(q)[:, None]
            oR, op = soa.fk_world(m, qt)
            fR, fp = soa.frame_placements_world(m, oR, op)
            ids = [m.frame_id(n) for n in ("left_sole_link", "right_sole_link",
                                           "gripper_left_link", "head_2_link")]
            out.append((fR[ids, ..., 0].numpy(), fp[ids, ..., 0].numpy(),
                        soa.com_world(m, oR, op)[:, 0].numpy()))
        for a, b in zip(*out):
            np.testing.assert_allclose(a, b, atol=1e-10)


def test_reduce_and_srdf_errors_and_values():
    """tests/test_reduce.py's error and SRDF cases on the port's copies:
    unknown or root joints cannot be locked; the SRDF gives half_sitting
    and the rotor parameters; a wrong value arity raises."""
    from simple_mpc_tpu_torch.models import robots
    from simple_mpc_tpu_torch.models.reduce import build_reduced_model
    from simple_mpc_tpu_torch.models.srdf import (load_reference_configurations,
                                                  load_rotor_parameters)
    from simple_mpc_tpu_torch.models.urdf import load_urdf

    full = robots.load_talos(reduced=False)
    with pytest.raises(ValueError, match="unknown joints"):
        build_reduced_model(full, ["nope_joint"])
    with pytest.raises(ValueError, match="root"):
        build_reduced_model(full, ["root_joint"])
    model = load_urdf(os.path.join(robots._ASSETS, "talos.urdf"), name="talos")
    srdf = os.path.join(robots._ASSETS, "talos.srdf")
    q = load_reference_configurations(model, srdf)["half_sitting"]
    assert q.shape == (model.nq,) and np.isclose(q[2], 1.01)
    assert np.isclose(q[model.idx_q[model.joint_id("leg_left_4_joint")]], 0.859395)
    ri, gr = load_rotor_parameters(model, srdf)
    j = model.joint_id("arm_left_6_joint")
    assert np.isclose(gr[model.idx_v[j]], 160.0) and np.isclose(ri[model.idx_v[j]], 3.0e-5)
    assert np.all(gr[:6] == 1.0) and np.all(ri[:6] == 0.0)
    bad = ('<robot name="talos"><group_state name="x" group="all">'
           '<joint name="leg_left_4_joint" value="0.1 0.2"/></group_state></robot>')
    with pytest.raises(ValueError, match="expects 1"):
        load_reference_configurations(model, bad)


def test_talos_handler_feet_match_jax():
    """The quad feet of `configs.talos_handler`: their frames, reference
    frames and placements at half_sitting, and the contact points, equal
    to the JAX package's to 1e-12."""
    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.models.handler import RobotDataHandler as JData
    from simple_mpc_tpu_torch.configs import talos_handler
    from simple_mpc_tpu_torch.models.handler import QUAD, RobotDataHandler

    jmh, tmh = jhandler(), talos_handler()
    assert tmh.feet_names == jmh.feet_names
    assert tmh.feet_frame_ids == jmh.feet_frame_ids
    assert tmh.feet_ref_frame_ids == jmh.feet_ref_frame_ids
    assert tmh.feet_types == [QUAD, QUAD]
    np.testing.assert_array_equal(tmh.reference_state, jmh.reference_state)
    assert abs(tmh.mass - jmh.mass) <= 1e-12 * jmh.mass
    jd, td = JData(jmh), RobotDataHandler(tmh)
    for k in range(2):
        np.testing.assert_array_equal(tmh.feet_contact_points[k], jmh.feet_contact_points[k])
        for get in ("get_foot_pose", "get_foot_ref_pose"):
            for a, b in zip(getattr(td, get)(k), getattr(jd, get)(k)):
                assert _err(a, np.asarray(b)) < 1e-12, get


# ---------------------------------------------------------------------------
# The stage (K1) and its linearization (K1+K2, K5)
# ---------------------------------------------------------------------------


def _talos_pair(force_cone, terminal=False):
    """The JAX and the port Talos kinodynamics OCPs at T, with the left foot
    lifted on stage 1 and the right on stage 3 (the same stage params on
    both sides, from numpy)."""
    import dataclasses

    import jax.numpy as jnp

    from simple_mpc_tpu.configs import talos_handler as jhandler
    from simple_mpc_tpu.configs import talos_kinodynamics_config as jconfig
    from simple_mpc_tpu.ocp.kinodynamics import KinodynamicsOCP as JOCP
    from simple_mpc_tpu_torch.configs import talos_handler, talos_kinodynamics_config
    from simple_mpc_tpu_torch.convert import problem_from_numpy
    from simple_mpc_tpu_torch.ocp.kinodynamics import KinodynamicsOCP

    jmh, tmh = jhandler(), talos_handler()
    jcfg, tcfg = jconfig(jmh), talos_kinodynamics_config(tmh)
    jcfg["force_cone"] = tcfg["force_cone"] = force_cone
    jocp, tocp = JOCP(jcfg, jmh), KinodynamicsOCP(tcfg, tmh, "cpu")
    x0 = np.asarray(jmh.reference_state)
    jocp.create_problem(x0, T, 6, -9.81, terminal)
    tocp.create_problem(x0, T, 6, -9.81, terminal)
    act = np.ones((T, 2))
    act[1, 0] = act[3, 1] = 0.0
    jsp = jocp.problem.stage_params._replace(contact_active=jnp.asarray(act))
    jocp.problem = dataclasses.replace(jocp.problem, stage_params=jsp)
    tocp.problem = problem_from_numpy(tocp, jsp, jocp.problem.term_params, x0, "cpu")
    return jocp, tocp, x0


def _perturbed(rng, ocp, x0):
    """A warm start (T+1, nx), (T, nu) off the standing one: states by 0.02,
    normal forces by 20 N, the rest by 1."""
    xs = x0 + 0.02 * rng.normal(size=(T + 1, x0.shape[0]))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    u0 = ocp.get_reference_control(0).double().numpy()
    us = u0 + np.where(np.abs(u0) > 1.0, 20.0, 1.0) * rng.normal(size=(T,) + u0.shape)
    return xs, us


@pytest.mark.parametrize("force_cone", [False, True])
def test_stage_eval_soa_matches_jax(force_cone):
    """r, geq, h and xnext of the 6D stage (the centroidal wrench with the
    contact torques, the log6 pose residuals, the 6D stance velocities, the
    joint box and, with force_cone, the wrench cones) at 1e-12."""
    import jax
    import jax.numpy as jnp

    jocp, tocp, x0 = _talos_pair(force_cone)
    rng = np.random.default_rng(3)
    xs, us = _perturbed(rng, tocp, x0)
    X, U = xs[:-1].T, us.T
    JP = jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, 0, -1), jocp.problem.stage_params)
    ref = jax.jit(jocp.stage_eval_soa)(jnp.asarray(X), jnp.asarray(U), JP)
    TP = type(tocp.problem.stage_params)._make(
        a.movedim(0, -1) for a in tocp.problem.stage_params)
    got = tocp.stage_eval_soa(torch.as_tensor(X), torch.as_tensor(U), TP)
    assert got[3].shape[0] == 44 + (34 if force_cone else 0)
    for name, i in (("r", 0), ("w", 1), ("geq", 2), ("h", 3), ("xnext", 4)):
        assert _err(got[i], np.asarray(ref[i])) < TOL_STAGE, name
    # the stance rows vanish on the lifted foot: 6 velocity rows a foot
    geq = got[2].numpy().reshape(2, 6, T)
    assert np.all(geq[0, :, 1] == 0.0) and np.all(geq[1, :, 3] == 0.0)
    assert np.abs(geq[0, :, 0]).max() > 0.0


@pytest.fixture(scope="module")
def lin_case():
    """K1+K2 and K5 of JAX on the cone variant with the terminal DCM
    equality and u_scale "auto", one scenario, perturbed iterate and
    multipliers."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu.solver.proxddp import SolverSettings as JSettings
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    jocp, tocp, x0 = _talos_pair(True, terminal=True)
    rng = np.random.default_rng(7)
    xs, us = _perturbed(rng, tocp, x0)
    lam_eq = 0.1 * rng.normal(size=(T, tocp.n_eq))
    lam_in = np.abs(0.1 * rng.normal(size=(T, tocp.n_in)))
    lam_term = 0.1 * rng.normal(size=(tocp.n_term_eq,))
    js = JSolver(jocp, JSettings(u_scale="auto"))
    lin = jax.jit(lambda x, u: js._linearize_traj_soa(
        jocp.problem, x, u, jnp.asarray(lam_eq), jnp.asarray(lam_in), MU))(
            jnp.asarray(xs), jnp.asarray(us))
    term = jax.jit(lambda x: js._linearize_term(x, jocp.problem.term_params,
                                                jnp.asarray(lam_term), MU))(jnp.asarray(xs[-1]))
    t = lambda a: torch.as_tensor(np.array(a, np.float64))[None]  # noqa: E731
    return dict(ts=ProxDDPSolver(tocp, SolverSettings(u_scale="auto")),
                tprob=tile_problem(tocp.problem, 1), xs=t(xs), us=t(us), lam_eq=t(lam_eq),
                lam_in=t(lam_in), lam_term=t(lam_term), mu=torch.full((1,), MU,
                                                                      dtype=torch.float64),
                lin={k: np.asarray(v)[None] for k, v in lin.items()},
                term=[np.asarray(v)[None] for v in term])


def test_linearization_twin_matches_jax(lin_case):
    """A, B, d, qx, qu, Qxx, Quu, Qux of the 170 + 34 AL rows (90 tangent
    directions) and Vx, Vxx of the terminal rows, against JAX at 1e-9."""
    from simple_mpc_tpu_torch import kernels

    c = lin_case
    assert c["ts"].space.ndx + c["ts"].ocp.nu == 90
    lin = kernels.wide_stage_linearize(c["ts"], c["tprob"].stage_params, c["xs"], c["us"],
                                       c["lam_eq"], c["lam_in"], c["mu"])
    for k in kernels.LIN_KEYS:
        assert _rel(lin[k], c["lin"][k]) < TOL_LIN, k
    term = kernels.wide_term_linearize(c["ts"], c["xs"][:, -1], c["tprob"].term_params,
                                       c["lam_term"], c["mu"])
    for a, b in zip(term, c["term"]):
        assert _rel(a, b) < TOL_LIN


def test_cpu_tensors_reach_the_twins(lin_case):
    """On CPU tensors the generic and the wide wrappers both give the twins'
    results and count no launch."""
    from simple_mpc_tpu_torch import kernels

    c = lin_case
    args = (c["ts"], c["tprob"].stage_params, c["xs"], c["us"], c["lam_eq"], c["lam_in"],
            c["mu"])
    before = [k.launches for k in kernels.KERNELS]
    a, b = kernels.stage_linearize(*args), kernels.wide_stage_linearize(*args)
    xs_c, us_c = c["xs"][:, None], c["us"][:, None]
    ev = (kernels.stage_eval(*args[:2], xs_c, us_c, *args[4:]),
          kernels.wide_stage_eval(*args[:2], xs_c, us_c, *args[4:]))
    assert [k.launches for k in kernels.KERNELS] == before
    for k in kernels.LIN_KEYS:
        assert torch.equal(a[k], b[k]), k
    for x, y in zip(*ev):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _chain(nj):
    """A model stand-in with a free-flyer root and nj - 1 revolute joints in
    a chain, q/v indices in joint order."""
    from simple_mpc_tpu_torch.models.model import FREE, REVOLUTE

    return SimpleNamespace(njoints=nj, joint_types=(FREE,) + (REVOLUTE,) * (nj - 1),
                           parents=tuple(range(-1, nj - 1)),
                           idx_q=(0,) + tuple(6 + j for j in range(1, nj)),
                           idx_v=(0,) + tuple(5 + j for j in range(1, nj)))


def _ocp(nj, nk, fs):
    nv = nj + 5
    return SimpleNamespace(model=_chain(nj), nk=nk, fs=fs, nv=nv, nu=nk * fs + nv - 6)


def test_stage_route():
    """Go2 goes to csrc/linearize.cu, Talos and 6D Go2 to the wide kernels;
    beyond 32 joints, 8 feet or 128 directions, or at a force size other
    than 3 and 6, the stage kernels refuse."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_go2_kinodynamics, make_talos_kinodynamics

    go2, _, _ = make_go2_kinodynamics(2, device="cpu")
    talos, _, _ = make_talos_kinodynamics(2, device="cpu")
    assert kernels.stage_route(go2) == "narrow"
    assert kernels.stage_route(talos) == "wide"
    assert kernels.stage_route(_ocp(13, 4, 6)) == "wide"  # Go2's tree, 6D feet
    assert kernels.stage_route(_ocp(17, 2, 3)) == "wide"  # 17 joints, point feet
    assert kernels.stage_route(_ocp(32, 2, 6)) == "wide"  # 74 + 12 + 31 = 117 directions
    for ocp, what in ((_ocp(33, 2, 6), "at most 32 joints"),
                      (_ocp(13, 9, 3), "8 feet"),
                      (_ocp(32, 4, 6), "at most 128 tangent directions"),
                      (_ocp(13, 4, 4), "force size 3 or 6")):
        with pytest.raises(NotImplementedError, match=what):
            kernels.stage_route(ocp)
    # the constants of each route: the Go2 units' Dims refuse Talos
    with pytest.raises(NotImplementedError, match="at most 16 joints"):
        kernels._stage_consts(talos, torch.float64, torch.device("cpu"))
    C, dims = kernels._stage_consts(talos, torch.float64, torch.device("cpu"), wide=True)
    assert len(dims) == kernels._WIDE_DIMS_INTS
    assert list(dims[:6]) == [23, 29, 28, 34, 2, 6]  # nj, nq, nv, nu, nk, fs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("force_cone", [False, True])
def test_wide_kernels_match_twins_on_cuda(force_cone):
    """The three wide kernels against their twins on Talos T=8, B=3 (feet
    lifted in turns), f64 at 1e-10 and f32 within chip_smoke.py's
    F32_WIDE_TOL of the twin in f64; `stage_linearize`, `stage_eval` and
    `term_linearize` route Talos to them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings
    from chip_smoke import F32_WIDE_TOL, as64, talos_case

    nb = 3
    for dtype in (torch.float64, torch.float32):
        ocp, probs, xs, us, lam_eq, lam_in = talos_case("cuda", dtype, nb, 8, seed=5,
                                                        force_cone=force_cone)
        solver = ProxDDPSolver(ocp, SolverSettings(u_scale="auto"))
        mu = torch.tensor([1e-2, 3e-3, 1e-3], dtype=dtype, device="cuda")
        lam_term = torch.zeros((nb, 0), dtype=dtype, device="cuda")
        sp = tree_map(torch.Tensor.contiguous, probs.stage_params)
        tp = tree_map(torch.Tensor.contiguous, probs.term_params)
        xs_c = torch.stack([xs, xs * (1 + 1e-3)], dim=1)
        xs_c[..., 3:7] /= xs_c[..., 3:7].norm(dim=-1, keepdim=True)
        us_c = torch.stack([us, 1.01 * us], dim=1)
        calls = dict(lin=(solver, sp, xs, us, lam_eq, lam_in, mu),
                     ev=(solver, sp, xs_c, us_c, lam_eq, lam_in, mu),
                     term=(solver, xs[:, -1], tp, lam_term, mu))
        n = [k.launches for k in kernels.KERNELS]
        got = dict(lin=kernels.stage_linearize(*calls["lin"]),
                   ev=kernels.stage_eval(*calls["ev"]),
                   term=kernels.term_linearize(*calls["term"]))
        launched = {k.__name__: k.launches - m for k, m in zip(kernels.KERNELS, n)
                    if k.launches != m}
        assert launched == dict(wide_stage_linearize=1, wide_stage_eval=1,
                                wide_term_linearize=1)
        f32 = dtype == torch.float32
        twins = dict(lin=kernels._linearize_traj_plain, ev=kernels._eval_traj_plain,
                     term=kernels._linearize_term_plain)
        names = dict(lin="wide_stage_linearize", ev="wide_stage_eval",
                     term="wide_term_linearize")
        for key, twin in twins.items():
            name = names[key]
            want = twin(*(as64(calls[key]) if f32 else calls[key]))
            g = [got[key][k] for k in kernels.LIN_KEYS] if key == "lin" else got[key]
            w = [want[k] for k in kernels.LIN_KEYS] if key == "lin" else want
            for a, b in zip(g, w):
                if b.numel():
                    assert torch.isfinite(a).all()
                    assert _rel(a, b) < (F32_WIDE_TOL[name] if f32 else 1e-10), (key, dtype)
