"""PyTorch port vs JAX package: CentroidalID (the CoM and swing-foot tasks
and the orientation-only base task over the kinodynamics ID), f64 CPU.

On Talos (two quad feet: 6D wrenches, SE3 swing tasks) and on Solo12 (four
point feet: 3D forces, position swing tasks), each with one foot out of
contact and its target moved and turned, the CoM target moved, at a
perturbed state: `_extra_tasks` (J, r0, w of each task) and the whole
`_assemble_core` (H, g, A, l, u, M, h, Jc') against JAX's, within 1e-10
relative to max(1, the largest entry).  One JAX CentroidalID a robot,
built without the constructor's dry run (its `solve` stubbed while it
runs), and one XLA compile a robot: `_assemble_core` under one jit, with
the rows of the `_extra_tasks` call inside it returned beside its output.  Both
`set_target` signatures leave the port's targets where JAX's are.

The `cuda` test holds csrc/id_centroidal.cu to the twin on the card.
"""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs six at once, and idle
# torch threads spinning beside the others' work slow every worker down
torch.set_num_threads(1)

TOL = 1e-10
SETTINGS = dict(kp_base=10.0, kp_posture=10.0, kp_contact=50.0, kp_com=50.0,
                kp_feet_tracking=50.0, w_base=1.0, w_posture=0.1, w_contact_motion=100.0,
                w_contact_force=0.05, w_com=10.0, w_feet_tracking=5.0, Lfoot=0.1,
                Wfoot=0.075, qp_iters=60)
SOLO_FEET = ["FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"]
OUT = ("H", "g", "A", "l", "u", "M", "h", "JcT")


def _err(a, b):
    a = a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _handlers(robot):
    """(JAX handler, port handler) of a robot."""
    if robot == "talos":
        from simple_mpc_tpu.configs import talos_handler as jh
        from simple_mpc_tpu_torch.configs import talos_handler as th

        return jh(), th()
    from simple_mpc_tpu.models import robots as jrobots
    from simple_mpc_tpu.models.handler import RobotModelHandler as JMH
    from simple_mpc_tpu_torch.models import robots as trobots
    from simple_mpc_tpu_torch.models.handler import RobotModelHandler as TMH

    out = []
    for robots, MH in ((jrobots, JMH), (trobots, TMH)):
        mh = MH(robots.load_solo12(), "standing", "base_link")
        for f in SOLO_FEET:
            mh.add_point_foot(f, "base_link")
        out.append(mh)
    return tuple(out)


def _targets(nk, rng):
    """The centroidal targets: foot 1 out of contact with its target moved
    and turned, the CoM target moved."""
    a = 0.1
    rot = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    feet_pose = [(rot if k == 1 else np.eye(3),
                  np.array([0.02 * k, 0.1 - 0.05 * k, 0.03 * (k == 1)])) for k in range(nk)]
    feet_vel = [0.1 * rng.standard_normal(6) for _ in range(nk)]
    contacts = [k != 1 for k in range(nk)]
    f = [np.array([1.0, -2.0, 150.0, 0.5, 0.3, -0.2]) for _ in range(nk)]
    return (np.array([0.01, -0.02, 0.6]), np.array([0.1, 0.0, -0.02]), feet_pose, feet_vel,
            contacts, f)


@pytest.fixture(scope="module", params=["talos", "solo12"])
def case(request):
    import jax
    import jax.numpy as jnp

    from simple_mpc_tpu.id import kinodynamics_id as jkid
    from simple_mpc_tpu.id.centroidal_id import CentroidalID as JCID
    from simple_mpc_tpu_torch.id.centroidal_id import CentroidalID
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings

    jmh, tmh = _handlers(request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkid.KinodynamicsID, "solve", lambda self, t, q, v: None)
        jid = JCID(jmh, 1e-3, jkid.IDSettings(**SETTINGS))
    tid = CentroidalID(tmh, 1e-3, IDSettings(**SETTINGS), device="cpu")
    rng = np.random.default_rng(3)
    m = tmh.model
    x = np.asarray(tmh.reference_state)
    q = x[: m.nq].copy()
    q[7:] += 0.05 * rng.standard_normal(m.nq - 7)
    q[:3] += 0.01 * rng.standard_normal(3)
    quat = q[3:7] + 0.02 * rng.standard_normal(4)
    q[3:7] = quat / np.linalg.norm(quat)
    v = 0.2 * rng.standard_normal(m.nv)
    init = ({k: np.asarray(a) for k, a in jid._targets.items()},
            {k: a.clone() for k, a in tid._targets.items()})
    args = _targets(tmh.n_feet, rng)
    jid.set_target(*args)
    tid.set_target(*args)
    jt = dict(jid._targets)
    raw = type(jid)._assemble_core.__wrapped__  # the function under its jit

    def both(qq, vv, tt):
        """_assemble_core, and the rows its `_extra_tasks` call returned."""
        held, extra = [], jid._extra_tasks
        jid._extra_tasks = lambda *a: held.append(extra(*a)) or held[-1]
        try:
            out = raw(jid, qq, vv, tt)
        finally:
            del jid._extra_tasks
        return held[0], out

    jrows, jasm = jax.jit(both)(jnp.asarray(q), jnp.asarray(v), jt)
    tt = {k: a[None] for k, a in tid._targets.items()}
    qt, vt = torch.as_tensor(q)[None], torch.as_tensor(v)[None]
    trows = tid._extra_tasks(qt, vt, tt, torch.float64)
    tasm = tid._assemble_core(qt, vt, tt)
    # the kinodynamics signature: the targets it sets, and the centroidal
    # ones left alone
    kin = (x[: m.nq], x[m.nq:], 0.1 * np.ones(m.nv), [True] * tmh.n_feet,
           [np.ones(tid.fdim)] * tmh.n_feet)
    jid.set_target(*kin)
    tid.set_target(*kin)
    return dict(jrows=jrows, trows=trows, jasm=jasm, tasm=tasm, init=init,
                after=({k: np.asarray(a) for k, a in jid._targets.items()}, tid._targets),
                targets=(jt, tt), tid=tid)


def test_initial_targets_match_jax(case):
    jt, tt = case["init"]
    for k in ("com_t", "com_v_t", "feet_p_t", "feet_R_t", "feet_v_t"):
        assert _err(tt[k], jt[k]) < 1e-12, k


def test_set_target_signatures_match_jax(case):
    """The centroidal signature's targets (with the reference posture
    delegated), then the kinodynamics one's over them."""
    jt, tt = case["targets"]
    for k, a in tt.items():
        assert _err(a[0], jt[k]) < 1e-12, k
    jt, tt = case["after"]
    assert set(jt) == set(tt)
    for k in jt:
        assert _err(tt[k], jt[k]) < 1e-12, k


@pytest.mark.parametrize("part", ["J", "r0", "w"])
def test_extra_tasks_match_jax(case, part):
    i = ("J", "r0", "w").index(part)
    assert len(case["trows"]) == len(case["jrows"])
    for trow, jrow in zip(case["trows"], case["jrows"]):
        assert _err(trow[i][0], jrow[i]) < TOL


@pytest.mark.parametrize("key", OUT)
def test_assemble_core_matches_jax(case, key):
    i = OUT.index(key)
    assert _err(case["tasm"][i][0], case["jasm"][i]) < TOL


def test_base_task_masked_and_swing_rows_weighted(case):
    """The base task's position rows weigh 0, the swing task of the foot in
    contact 0 and of the lifted one w_feet_tracking."""
    tid = case["tid"]
    np.testing.assert_array_equal(tid._base_mask, [0, 0, 0, 1, 1, 1])
    w = [r[2][0].numpy() for r in case["trows"]]
    assert np.all(w[0] == SETTINGS["w_com"])
    for k, wk in enumerate(w[1:]):
        assert np.all(wk == (SETTINGS["w_feet_tracking"] if k == 1 else 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["talos", "solo12"])
def test_centroidal_id_kernel_matches_twin_on_card(robot):
    """csrc/id_centroidal.cu against `_assemble_core` on the card, f64,
    1e-10, at B=4 perturbed states with a foot in swing."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    from simple_mpc_tpu_torch import kernels
    from simple_mpc_tpu_torch.id.centroidal_id import CentroidalID
    from simple_mpc_tpu_torch.id.kinodynamics_id import IDSettings

    dev = torch.device("cuda")
    tmh = _handlers(robot)[1]
    cid = CentroidalID(tmh, 1e-3, IDSettings(**SETTINGS), device=dev)
    rng = np.random.default_rng(8)
    cid.set_target(*_targets(tmh.n_feet, rng))
    m, nb = tmh.model, 4
    q = np.tile(np.asarray(tmh.reference_state)[: m.nq], (nb, 1))
    q[:, 7:] += 0.05 * rng.standard_normal((nb, m.nq - 7))
    v = 0.2 * rng.standard_normal((nb, m.nv))
    tt = {k: a[None].expand((nb,) + a.shape).contiguous() for k, a in cid._targets.items()}
    qt = torch.as_tensor(q, device=dev)
    vt = torch.as_tensor(v, device=dev)
    n = kernels.centroidal_id_assemble.launches
    got = kernels.id_assemble(cid, qt, vt, tt)
    assert kernels.centroidal_id_assemble.launches == n + 1
    for a, b in zip(got, cid._assemble_core(qt, vt, tt)):
        assert _err(a, b.cpu()) < 1e-10
