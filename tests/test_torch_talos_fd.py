"""PyTorch port vs JAX package: Talos full dynamics (23 joints, two 6D quad
feet; kernel K7 with LOCAL_WORLD_ALIGNED contacts), f64 CPU.

  * the configuration: the port's `configs.talos_fulldynamics_config` is
    the JAX example's (examples/talos_fulldynamics.py:18-34), and the
    problem `make_talos_fulldynamics` builds is JAX's (sizes, stage and
    terminal parameters);
  * K7's pieces on Talos (`ops/soa_dyn.py`: world inertias, CRBA, bias
    torques, `contact_jacobians(dim=6)` and `constrained_fwd_dynamics_soa(
    dim=6)` with vector Baumgarte gains (kp and kd), perturbed reference
    rotations and mixed contact masks) on 4 random (q, v): 1e-10 relative
    to max(1, |JAX|); zero gains run inside the example's stage below;
  * `FullDynamicsOCP.stage_eval_soa` at T=3: the example's problem (cones
    and landing rows off) and one with the two 17-row wrench cones, the
    landing equalities and vector Baumgarte gains on, over mixed contact
    masks and landing flags: 1e-10;
  * the routes: which unit each full-dynamics wrapper picks on the card
    (`kernels.stage_route` on full dynamics: Go2 point feet narrow, Go2
    with 6D contacts and Talos wide), what beyond the wide unit's limits raises
    NotImplementedError, and the shared-memory refusal of the wide
    linearization under a mocked opt-in maximum (no card needed).

The JAX functions are jit-compiled once each (module fixtures): the
Talos full-dynamics stage takes ~20 s of XLA compile on a CPU.  The
`cuda` tests hold the three wide kernels (csrc/fulldyn_wide.cu) to their
twins on the card: f64 within 1e-10, f32 within ten times the f32 twin's
own distance from the f64 twin on the same inputs (on the card: `python
-m pytest --noconftest -m cuda tests/test_torch_talos_fd.py`).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-10
N = 4
T_STAGE = 3


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max(initial=0.0)))


def _rand_states(x0, nv, n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    q = x0[None, : x0.shape[0] - nv] + scale * rng.normal(size=(n, x0.shape[0] - nv))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    return q, rng.normal(size=(n, nv))


def _rotations(rng, shape):
    """Rotation matrices (shape..., 3, 3) near the identity."""
    from scipy.spatial.transform import Rotation

    n = int(np.prod(shape))
    return Rotation.from_rotvec(0.3 * rng.normal(size=(n, 3))).as_matrix().reshape(
        tuple(shape) + (3, 3))


GAINS = dict(zero=(np.zeros(6), np.zeros(6)),
             vector=(np.linspace(5.0, 30.0, 6), np.linspace(0.5, 4.0, 6)))


@pytest.fixture(scope="module")
def jx():
    """Both handlers, both example configurations and the JAX and port OCPs
    at T=3: "example" (cones and landing rows off, no Baumgarte gains) and
    "full" (wrench cones, landing equalities, vector gains)."""
    import jax.numpy as jnp

    from examples.talos_fulldynamics import talos_fulldynamics_config as jconfig
    from simple_mpc_tpu import configs as jconfigs
    from simple_mpc_tpu.ocp.fulldynamics import FullDynamicsOCP as JOCP
    from simple_mpc_tpu_torch import configs as tconfigs
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP as TOCP

    jmh, tmh = jconfigs.talos_handler(), tconfigs.talos_handler()
    ocps = {}
    for name in ("example", "full"):
        jc, tc = jconfig(jmh), tconfigs.talos_fulldynamics_config(tmh)
        if name == "full":
            kp, kd = GAINS["vector"]
            for c in (jc, tc):
                c.update(force_cone=True, land_cstr=True, Kp_correction=kp, Kd_correction=kd)
        jocp, tocp = JOCP(jc, jmh), TOCP(tc, tmh, "cpu")
        x0 = np.asarray(jmh.reference_state)
        jocp.create_problem(jnp.asarray(x0), T_STAGE, 6, -9.81, False)
        tocp.create_problem(x0, T_STAGE, 6, -9.81, False)
        ocps[name] = (jocp, tocp)
    return dict(jmh=jmh, tmh=tmh, ocps=ocps, x0=np.asarray(jmh.reference_state),
                jconfig=jconfig)


# ---------------------------------------------------------------------------
# The configuration and the problem
# ---------------------------------------------------------------------------


def test_config_is_the_examples(jx):
    from simple_mpc_tpu_torch.configs import talos_fulldynamics_config

    ref = jx["jconfig"](jx["jmh"])
    got = talos_fulldynamics_config(jx["tmh"])
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, (bool, int, float, str)):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", ["example", "full"])
def test_problem_matches_jax(jx, name):
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics

    jocp, tocp = jx["ocps"][name]
    assert (tocp.nq, tocp.nv, tocp.nu, tocp.fs, tocp.nk) == (29, 28, 22, 6, 2)
    assert (tocp.n_eq, tocp.n_in, tocp.n_term_eq) == (jocp.n_eq, jocp.n_in, jocp.n_term_eq)
    assert (tocp.n_eq, tocp.n_in) == ((0, 88) if name == "example" else (12, 122))
    for a, b in zip(tocp.problem.stage_params, jocp.problem.stage_params):
        _close(a, b)
    for a, b in zip(tocp.problem.term_params, jocp.problem.term_params):
        _close(a, b)
    np.testing.assert_array_equal(tocp.u_scale, np.asarray(jocp.u_scale))
    if name == "example":
        ocp, _, x0 = make_talos_fulldynamics(T_STAGE, device="cpu")
        assert ocp.n_in == 88 and ocp.n_eq == 0
        for a, b in zip(ocp.problem.stage_params, tocp.problem.stage_params):
            _close(a, b, tol=0)
        cone, _, _ = make_talos_fulldynamics(T_STAGE, device="cpu", force_cone=True)
        assert cone.n_in == 88 + 34


# ---------------------------------------------------------------------------
# K7's pieces on Talos
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k7(jx):
    """K7's pieces from JAX (one jit) and from the port on the same random
    states, contact masks and Baumgarte anchors."""
    import jax

    from simple_mpc_tpu.ops import soa as jsoa
    from simple_mpc_tpu.ops import soa_dyn as jdyn
    from simple_mpc_tpu_torch.ops import soa as tsoa
    from simple_mpc_tpu_torch.ops import soa_dyn as tdyn

    jm, tm = jx["jmh"].model, jx["tmh"].model
    fids = list(jx["jmh"].feet_frame_ids)
    q, v = _rand_states(jx["x0"], jm.nv, N, seed=1)
    rng = np.random.default_rng(3)
    tau = np.concatenate([np.zeros((N, 6)), 20.0 * rng.normal(size=(N, jm.nv - 6))], axis=1)
    active = np.array([[1, 1], [1, 0], [0, 1], [1, 1]], np.float64)
    ref_R = np.moveaxis(_rotations(rng, (N, 2)), 0, -1)  # (2, 3, 3, N)
    ref_p = np.moveaxis(0.1 * rng.normal(size=(N, 2, 3)), 0, -1)

    def pieces(mod_soa, mod_dyn, model, qT, vT, tauT, actT, R, p):
        oR, op = mod_soa.fk_world(model, qT)
        Sw = mod_soa.world_axes(model, oR, op)
        vW = mod_soa.body_velocities(model, Sw, vT)
        J, fR, fp = mod_dyn.contact_jacobians(model, oR, op, Sw, fids, 6)
        out = dict(IW=mod_dyn.body_inertias_world(model, oR, op),
                   M=mod_dyn.crba_world(model, oR, op, Sw),
                   b=mod_dyn.nle_world(model, oR, op, Sw, vW, vT), J=J, fRw=fR, fpw=fp)
        kp, kd = GAINS["vector"]
        out["ddq"], out["f"] = mod_dyn.constrained_fwd_dynamics_soa(
            model, qT, vT, tauT, fids, actT, dim=6, ref_R=R, ref_p=p, kp=kp, kd=kd)
        return out

    args = (q.T, v.T, tau.T, active.T, ref_R, ref_p)
    ref = jax.jit(lambda *a: pieces(jsoa, jdyn, jm, *a))(*args)
    got = pieces(tsoa, tdyn, tm, *map(torch.as_tensor, args))
    return ref, got, active


@pytest.mark.parametrize("name", ["IW", "M", "b", "J", "fRw", "fpw", "ddq", "f"])
def test_k7_pieces_match_jax(k7, name):
    ref, got, active = k7
    _close(got[name], ref[name])
    if name == "f":
        assert got[name].shape == (2, 6, N)
        # inactive feet carry no wrench
        assert np.all(np.moveaxis(_np(got[name]), 1, -1)[active.T == 0] == 0.0)


def test_contact_rows_are_local_world_aligned(k7):
    """The 6D rows are [lin; ang] of the world-aligned frame velocity: J v
    equals the frame's world-aligned velocity (soa.frame_velocities_world),
    not its LOCAL one."""
    from simple_mpc_tpu_torch.ops import soa as tsoa

    _, got, _ = k7
    J = got["J"]  # (12, nv, N)
    v = torch.as_tensor(np.random.default_rng(5).normal(size=(J.shape[1], N)))
    Jv = torch.einsum("rvn,vn->rn", J, v).reshape(2, 6, N)
    nv = J.shape[1]
    assert nv == 28
    # rebuild the world-aligned velocity from the port's kinematics
    import simple_mpc_tpu_torch.configs as tc
    from simple_mpc_tpu_torch.ops import world

    mh = tc.talos_handler()
    q, _ = _rand_states(np.asarray(mh.reference_state), nv, N, seed=1)
    oR, op = tsoa.fk_world(mh.model, torch.as_tensor(q.T))
    Sw = tsoa.world_axes(mh.model, oR, op)
    vW = tsoa.body_velocities(mh.model, Sw, v)
    fids = np.asarray(mh.feet_frame_ids)
    fR, fp = tsoa.frame_placements_world(mh.model, oR, op, fids)
    v_wa, v_loc = tsoa.frame_velocities_world(mh.model, vW, fR, fp,
                                              world.tables(mh.model).fparent[fids])
    _close(Jv, v_wa)
    assert float((Jv - v_loc).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The OCP's stage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stages(jx):
    """stage_eval_soa of both configurations from JAX (run eagerly: faster
    than its XLA compile) and the port on the same perturbed states, random
    controls, contact masks (a swing foot on alternate stages), landing
    flags, perturbed reference rotations and random force references."""
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver as JSolver
    from simple_mpc_tpu_torch.convert import problem_from_numpy

    out = {}
    for name, (jocp, tocp) in jx["ocps"].items():
        x0 = jx["x0"]
        rng = np.random.default_rng(7)
        sp = jocp.problem.stage_params
        pert = rng.normal(size=(T_STAGE, x0.shape[0])) * 0.05
        pert[:, 3:7] = 0.0
        xs = x0[None] + pert
        us = 20.0 * rng.normal(size=(T_STAGE, jocp.nu))
        act = np.asarray(sp.contact_active).copy()
        act[::2, 1] = 0.0
        land = np.asarray(sp.land).copy()
        land[:, 0] = 1.0
        R = np.einsum("tkij,tkjl->tkil", np.asarray(sp.foot_ref_R),
                      _rotations(rng, (T_STAGE, 2)))
        sp = sp._replace(contact_active=jnp.asarray(act), land=jnp.asarray(land),
                         foot_ref_R=jnp.asarray(R),
                         f_ref=jnp.asarray(50.0 * rng.normal(size=sp.f_ref.shape)))
        with jax.disable_jit():
            ref = jocp.stage_eval_soa(jnp.asarray(xs.T), jnp.asarray(us.T),
                                      JSolver._transpose_params(sp))
        tprob = problem_from_numpy(tocp, sp, jocp.problem.term_params, x0, "cpu")
        tP = type(tprob.stage_params)._make(a.movedim(0, -1) for a in tprob.stage_params)
        got = tocp.stage_eval_soa(torch.as_tensor(xs.T), torch.as_tensor(us.T), tP)
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("name", ["example", "full"])
@pytest.mark.parametrize("i, what", [(0, "r"), (1, "w"), (2, "geq"), (3, "h"), (4, "xnext")])
def test_stage_eval_soa_matches_jax(stages, name, i, what):
    ref, got = stages[name]
    rows = dict(example=(108, 0, 88), full=(108, 12, 122))[name]
    assert (got[0].shape[0], got[2].shape[0], got[3].shape[0]) == rows
    _close(got[i], ref[i])


def test_talos_fd_modules_do_not_import_jax():
    """The modules this slice adds or extends import neither jax nor the
    JAX package (as tests/test_torch_soa.py checks the others), and
    chip_smoke.py neither."""
    import os
    import subprocess
    import sys

    code = ("import sys, simple_mpc_tpu_torch.configs, simple_mpc_tpu_torch.kernels,"
            " simple_mpc_tpu_torch.examples.talos_fulldynamics, chip_smoke;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('simple_mpc_tpu.') or m == 'simple_mpc_tpu'];"
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


# ---------------------------------------------------------------------------
# The routes and the refusals (no card needed)
# ---------------------------------------------------------------------------


def _chain(nj):
    from simple_mpc_tpu_torch.models.model import FREE, REVOLUTE

    return SimpleNamespace(njoints=nj, joint_types=(FREE,) + (REVOLUTE,) * (nj - 1),
                           parents=tuple(range(-1, nj - 1)),
                           idx_q=(0,) + tuple(6 + j for j in range(1, nj)),
                           idx_v=(0,) + tuple(5 + j for j in range(1, nj)))


def _fd_ocp(nj, nk, fs):
    nv = nj + 5
    return SimpleNamespace(model=_chain(nj), nk=nk, fs=fs, nv=nv, nu=nv - 6,
                           full_dynamics=True)


def _go2_fd(fs, extra_feet=(), device="cpu", dtype=torch.float64, T=2):
    """Go2 full dynamics with point feet (fs 3) or 6D contacts (fs 6) at
    its four feet and the frames of `extra_feet`."""
    from simple_mpc_tpu_torch.configs import go2_fulldynamics_config, go2_handler
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP

    mh = go2_handler()
    for f in extra_feet:
        mh.add_point_foot(f, "base")
    cfg = go2_fulldynamics_config(mh)
    cfg.update(force_size=fs, w_forces=np.ones(fs), w_frame=np.ones(fs), force_cone=False,
               Kp_correction=np.zeros(fs), Kd_correction=np.zeros(fs))
    ocp = FullDynamicsOCP(cfg, mh, device, dtype)
    ocp.create_problem(np.asarray(mh.reference_state), T, fs, -9.81, False)
    return ocp


def test_fd_route():
    """Go2 with point feet goes to csrc/fulldyn.cu; Go2 with 6D contacts,
    Talos, and point feet on more than 16 joints to csrc/fulldyn_wide.cu;
    beyond 24 contact rows, 32 joints or 128 directions, or at a force size
    other than 3 and 6, the full-dynamics kernels refuse.  The terminal
    Jacobian and the line-search select follow the stage's unit."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics

    talos, _, _ = make_talos_fulldynamics(2, device="cpu")
    assert kernels.stage_route(_go2_fd(3)) == "narrow"
    assert kernels.stage_route(_go2_fd(6)) == "wide"
    assert kernels.stage_route(talos) == "wide"
    assert kernels.stage_route(_fd_ocp(17, 4, 3)) == "wide"  # 17 joints, point feet
    assert kernels.stage_route(_fd_ocp(13, 8, 3)) == "narrow"  # 8 point feet on Go2's tree
    assert kernels.stage_route(_fd_ocp(17, 8, 3)) == "wide"  # 24 point-foot rows
    assert kernels.stage_route(_fd_ocp(32, 4, 6)) == "wide"  # 111 directions, 24 rows
    for ocp, what in ((_fd_ocp(13, 5, 6), "at most 24 contact rows"),
                      (_fd_ocp(33, 2, 6), "at most 32 joints"),
                      (_fd_ocp(13, 9, 3), "8 feet"),
                      (_fd_ocp(13, 4, 4), "force size 3 or 6")):
        with pytest.raises(NotImplementedError, match=what):
            kernels.stage_route(ocp)
    assert kernels._ls_route(talos) == "wide"
    assert kernels._ls_route(_go2_fd(3)) == "narrow"
    # the constants of the wide unit: smpc_wide::Dims with the 6D rows; the
    # terminal rows the wide K5 and select read are the full-dynamics
    # terminal's ([state; 10 x centroidal] weights, no DCM equality)
    C, dims = kernels._stage_consts(talos, torch.float64, torch.device("cpu"), wide=True)
    assert len(dims) == kernels._WIDE_DIMS_INTS
    assert list(dims[:6]) == [23, 29, 28, 22, 2, 6]  # nj, nq, nv, nu, nk, fs
    field = dict(zip([n for n, k in kernels._WIDE_DIMS_FIELDS for _ in range(k)], dims))
    w_term = talos._const(C)["w_term"]
    assert (field["n_term_cost"], field["n_term_eq"]) == (w_term.shape[0], 0)
    o = field["o_wterm"]
    assert torch.equal(C[o: o + w_term.shape[0]], w_term)
    with pytest.raises(NotImplementedError, match="at most 16 joints"):
        kernels._stage_consts(talos, torch.float64, torch.device("cpu"))


def test_wide_fd_refusals_before_the_launch(monkeypatch):
    """On the card path (the `_*_cuda` wrappers, given CPU tensors here):
    five feet with 6D contacts (30 rows) are refused before the library is
    loaded; the wide linearization's shared memory a block (`fd_smem`:
    Talos 77.8 KiB in f32, 155.5 KiB in f64, 183.9 KiB in f64 with the cones
    and landing rows) is held against the device's opt-in maximum, mocked
    here at 100 kB: f64 refused, f32 goes on to the launch.  A wide fused
    tick over a full-dynamics OCP is refused."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics
    from simple_mpc_tpu_torch.ocp.base import index_params
    from simple_mpc_tpu_torch.parallel import tile_problem
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    class Launched(Exception):
        pass

    def library():
        raise Launched

    monkeypatch.setattr(kernels, "smem_optin", lambda device: 100_000)
    monkeypatch.setattr(kernels, "_library", library)

    five = _go2_fd(6, extra_feet=("FL_calf",))
    tree = tile_problem(five.problem, 1).stage_params
    p = type(tree)._make(a[:, 0] for a in tree)
    with pytest.raises(NotImplementedError, match="at most 24 contact rows"):
        kernels._fd_dynamics_cuda(five, five.problem.x0[None], torch.zeros((1, five.nu),
                                  dtype=torch.float64), p, wide=True)

    talos, _, _ = make_talos_fulldynamics(2, device="cpu")
    full = make_talos_fulldynamics(2, device="cpu", force_cone=True)[0]
    full.settings.land_cstr = True
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP

    full = FullDynamicsOCP(full.settings, full.model_handler, "cpu", torch.float64)
    full.create_problem(np.asarray(full.model_handler.reference_state), 2, 6, -9.81, False)
    assert kernels.fd_smem(talos, torch.float32) == 79_632
    assert kernels.fd_smem(talos, torch.float64) == 159_264
    assert kernels.fd_smem(full, torch.float64) == 188_336
    for dtype, fits in ((torch.float64, False), (torch.float32, True)):
        ocp, _, _ = make_talos_fulldynamics(2, device="cpu", dtype=dtype)
        solver = ProxDDPSolver(ocp, SolverSettings())
        probs = tile_problem(ocp.problem, 1)
        xs = ocp.problem.x0[None, None].expand(1, 3, -1).contiguous()
        us = torch.zeros((1, 2, ocp.nu), dtype=dtype)
        args = (solver, probs.stage_params, xs, us, torch.zeros((1, 2, 0), dtype=dtype),
                torch.zeros((1, 2, ocp.n_in), dtype=dtype), torch.ones(1, dtype=dtype))
        with pytest.raises(Launched if fits else NotImplementedError):
            kernels._linearize_cuda(*args, fd=True, wide=True)
    # the kinodynamics wrappers refuse a full-dynamics OCP on either unit
    with pytest.raises(ValueError, match="kinodynamics OCP"):
        kernels._linearize_cuda(*args, wide=True)
    p0 = index_params(talos.problem.stage_params, 0)
    assert p0.f_ref.shape == (2, 6)
    with pytest.raises(NotImplementedError, match="full-dynamics instance is not ported"):
        kernels._tick_cuda(SimpleNamespace(ocp=talos, settings=None, T=2),
                           SimpleNamespace(plan=torch.zeros((1, 4, 2)),
                                           takeoff=torch.zeros((1, 2, 4))),
                           talos.problem.x0[None], wide=True)


# ---------------------------------------------------------------------------
# The CUDA kernels against their twins (on the card)
# ---------------------------------------------------------------------------


def _kernel_case(dtype, nb, T, seed, force_cone=False, land_kp=False):
    """A perturbed Talos full-dynamics problem on the card: states, torques,
    multipliers, a swing foot on alternate stages, landing flags, perturbed
    reference rotations and random force references; candidates around
    it."""
    from simple_mpc_tpu_torch.configs import make_talos_fulldynamics
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.ocp.fulldynamics import FullDynamicsOCP
    from simple_mpc_tpu_torch.parallel import tile_problem

    ocp, mh, x0 = make_talos_fulldynamics(T, device="cuda", dtype=dtype,
                                          force_cone=force_cone)
    if land_kp:
        s = ocp.settings
        s.land_cstr = True
        s.Kp_correction, s.Kd_correction = GAINS["vector"]
        ocp = FullDynamicsOCP(s, mh, "cuda", dtype)
        ocp.create_problem(x0, T, 6, -9.81, False)
    rng = np.random.default_rng(seed)
    xs = np.repeat(x0[None, None], nb, 0).repeat(T + 1, 1)
    xs = xs + 0.03 * rng.normal(size=xs.shape)
    xs[..., 3:7] /= np.linalg.norm(xs[..., 3:7], axis=-1, keepdims=True)
    us = 20.0 * rng.normal(size=(nb, T, ocp.nu))
    sp = tile_problem(ocp.problem, nb).stage_params
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device="cuda")  # noqa: E731
    act = sp.contact_active.clone()
    act[:, ::2, 1] = 0.0
    land = sp.land.clone()
    land[:, 1::2, 0] = 1.0
    R = t(np.einsum("btkij,btkjl->btkil", sp.foot_ref_R.double().cpu().numpy(),
                    _rotations(rng, (nb, T, 2))))
    sp = tree_map(torch.Tensor.contiguous, sp._replace(
        contact_active=act, land=land, foot_ref_R=R,
        f_ref=t(50.0 * rng.normal(size=sp.f_ref.shape))))
    lam_eq = t(0.01 * rng.normal(size=(nb, T, ocp.n_eq)))
    lam_in = t(np.abs(rng.normal(size=(nb, T, ocp.n_in))))
    mu = t(np.geomspace(1e-2, 1e-3, nb))
    xs_c = np.stack([xs, xs + 1e-3 * rng.normal(size=xs.shape)], 1)
    xs_c[..., 3:7] /= np.linalg.norm(xs_c[..., 3:7], axis=-1, keepdims=True)
    us_c = np.stack([us, us + rng.normal(size=us.shape)], 1)
    return ocp, sp, t(xs), t(us), lam_eq, lam_in, mu, t(xs_c), t(us_c)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / max(1.0, float(b.double().abs().max())))


def _run_wide(dtype, nb, T, seed, u_scale=None, **kw):
    """(kernel outputs, twin outputs, f64 twin outputs on the same inputs)
    of the three wide kernels, and the launches they made."""
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.ocp.base import tree_map
    from simple_mpc_tpu_torch.solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, sp, xs, us, le, li, mu, xs_c, us_c = _kernel_case(dtype, nb, T, seed, **kw)
    solver = ProxDDPSolver(ocp, SolverSettings(u_scale=u_scale))
    x = xs[:, :-1].reshape(nb * T, -1).contiguous()
    u = us.reshape(nb * T, -1).contiguous()
    p = tree_map(lambda a: a.reshape((nb * T,) + a.shape[2:]).contiguous(), sp)
    n = [k.launches for k in kernels.KERNELS]
    got = (list(kernels.fd_stage_linearize(solver, sp, xs, us, le, li, mu).values())
           + list(kernels.fd_stage_eval(solver, sp, xs_c, us_c, le, li, mu))
           + list(kernels.fd_dynamics(ocp, x, u, p)))
    launched = {k.__name__: k.launches - m for k, m in zip(kernels.KERNELS, n)
                if k.launches != m}

    def twins(cast):
        c = (lambda a: a.double()) if cast else (lambda a: a)
        spc = tree_map(c, sp)
        return (list(kernels._linearize_traj_plain(
                    solver, spc, c(xs), c(us), c(le), c(li), c(mu)).values())
                + list(kernels._eval_traj_plain(solver, spc, c(xs_c), c(us_c), c(le), c(li),
                                                c(mu)))
                + list(kernels.fd_dynamics_plain(ocp, c(x), c(u), tree_map(c, p))))

    return got, twins(False), twins(True), launched


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["example", "cones", "land_kp_uscale"])
def test_wide_fd_kernels_match_twins_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kw = dict(example={}, cones=dict(force_cone=True),
              land_kp_uscale=dict(force_cone=True, land_kp=True, u_scale="auto"))[case]
    got, twin, _, launched = _run_wide(torch.float64, 2, 6, 5, **kw)
    assert launched == dict(wide_fd_stage_linearize=1, wide_fd_stage_eval=1,
                            wide_fd_dynamics=1)
    for a, b in zip(got, twin):
        if b.numel():
            assert _rel(a, b) < 1e-10, (case, _rel(a, b))
    got, twin, twin64, _ = _run_wide(torch.float32, 2, 6, 5, **kw)
    for i, (a, b, c) in enumerate(zip(got, twin, twin64)):
        if b.numel():
            own = _rel(b, c)
            assert _rel(a, c) <= 10 * own + 1e-7, (case, i, _rel(a, c), own)
