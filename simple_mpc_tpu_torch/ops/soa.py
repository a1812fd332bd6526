"""Structure-of-arrays rigid-body kernels — batch in the last axis.

Port of `simple_mpc_tpu.ops.soa`.  Every quantity is shaped
(components..., N) where N is the flattened (scenario, stage) batch, and
all small-matrix algebra is unrolled componentwise, so each torch op is
elementwise over the N lanes (on the card: one coalesced pass per op).
Contractions over dof/joint axes are einsums with N minor-most.

Component-axis conventions:
  * 3-vectors / 6-vectors: (..., 3, N) / (..., 6, N), [lin; ang] order
  * rotations: (..., 3, 3, N); quaternions (xyzw): (..., 4, N)
  * configuration q: (nq, N); tangents/velocities: (nv, N)

All functions are dtype-polymorphic and safe under `torch.func.jvp` /
`torch.func.vmap`: every Taylor-guarded branch uses the double
`torch.where` of the JAX package (guard the argument, then select), which
keeps NaN tangents of the branch that is not taken out of the result.
Constant tables come from `world.device_tables` on the input's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.model import FREE, RobotModel
from . import world as _world


def _small2(dtype) -> float:
    """theta^2 threshold below which Taylor expansions are used: theta <
    eps(dtype)^(1/4) (dtype-aware, as `simple_mpc_tpu.ops.lie._small2`)."""
    return float(np.sqrt(torch.finfo(dtype).eps))


# ---------------------------------------------------------------------------
# Small-matrix algebra, unrolled over components, elementwise over lanes
# ---------------------------------------------------------------------------


def mm(A, B):
    """(...,3,3,N) @ (...,3,3,N) -> (...,3,3,N), unrolled."""
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            cols.append(A[..., i, 0, :] * B[..., 0, j, :]
                        + A[..., i, 1, :] * B[..., 1, j, :]
                        + A[..., i, 2, :] * B[..., 2, j, :])
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)


def mtm(A, B):
    """A^T @ B."""
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            cols.append(A[..., 0, i, :] * B[..., 0, j, :]
                        + A[..., 1, i, :] * B[..., 1, j, :]
                        + A[..., 2, i, :] * B[..., 2, j, :])
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)


def mv(A, x):
    """(...,3,3,N) @ (...,3,N) -> (...,3,N)."""
    return torch.stack(
        [A[..., i, 0, :] * x[..., 0, :] + A[..., i, 1, :] * x[..., 1, :]
         + A[..., i, 2, :] * x[..., 2, :] for i in range(3)], dim=-2)


def mtv(A, x):
    """A^T @ x."""
    return torch.stack(
        [A[..., 0, i, :] * x[..., 0, :] + A[..., 1, i, :] * x[..., 1, :]
         + A[..., 2, i, :] * x[..., 2, :] for i in range(3)], dim=-2)


def cross(a, b):
    """Cross product over axis -2."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2)


def _mat3(rows):
    """Build (...,3,3,N) from a 3x3 nested list of (...,N) entries."""
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def transpose3(A):
    return A.transpose(-3, -2)


def eye3(like):
    """(3,3,1)-shaped identity broadcastable against (...,3,3,N)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[..., None]


# ---------------------------------------------------------------------------
# Quaternions (xyzw), components on axis -2
# ---------------------------------------------------------------------------


def quat_to_rotmat(q):
    x, y, z, w = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _mat3([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def quat_normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-2, keepdim=True))


def rotmat_to_quat(R):
    """Branch-free Shepperd (parity with lie.rotmat_to_quat), (...,4,N)."""
    m00, m01, m02 = R[..., 0, 0, :], R[..., 0, 1, :], R[..., 0, 2, :]
    m10, m11, m12 = R[..., 1, 0, :], R[..., 1, 1, :], R[..., 1, 2, :]
    m20, m21, m22 = R[..., 2, 0, :], R[..., 2, 1, :], R[..., 2, 2, :]
    tr = m00 + m11 + m22
    # candidates in (w, x, y, z) order, one per pivot
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-2)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-2)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-2)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-2)
    cands = torch.stack([qw, qx, qy, qz], dim=-3)  # (...,4cand,4comp,N)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-2)
    idx = torch.argmax(pivots, dim=-2)  # (...,N)
    four = torch.arange(4, device=R.device)[:, None]
    onehot = (idx[..., None, :] == four).to(R.dtype)  # (...,4,N)
    q_wxyz = torch.sum(cands * onehot[..., :, None, :], dim=-3)  # (...,4comp,N)
    q = torch.stack([q_wxyz[..., 1, :], q_wxyz[..., 2, :], q_wxyz[..., 3, :],
                     q_wxyz[..., 0, :]], dim=-2)
    w = q[..., 3:4, :]
    q = q * torch.sign(torch.where(w == 0.0, 1.0, w))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3)/SE(3) exp/log (Taylor-guarded as in ops.lie)
# ---------------------------------------------------------------------------


def exp3(w):
    """so(3) (...,3,N) -> R (...,3,3,N): R = (1 - c t^2) I + s W + c w w^T."""
    theta2 = torch.sum(w * w, dim=-2)
    small = theta2 < _small2(w.dtype)
    t2s = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(t2s)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    w0, w1, w2 = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    a = 1.0 - c * theta2
    return _mat3([
        [a + c * w0 * w0, -s * w2 + c * w0 * w1, s * w1 + c * w0 * w2],
        [s * w2 + c * w0 * w1, a + c * w1 * w1, -s * w0 + c * w1 * w2],
        [-s * w1 + c * w0 * w2, s * w0 + c * w1 * w2, a + c * w2 * w2],
    ])


def log3(R):
    """R (...,3,3,N) -> w (...,3,N) (principal branch; parity with lie.log3)."""
    tr = R[..., 0, 0, :] + R[..., 1, 1, :] + R[..., 2, 2, :]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    a = torch.stack([R[..., 2, 1, :] - R[..., 1, 2, :],
                     R[..., 0, 2, :] - R[..., 2, 0, :],
                     R[..., 1, 0, :] - R[..., 0, 1, :]], dim=-2)
    small = cos_t > 1.0 - 0.5 * _small2(cos_t.dtype)
    near_pi = cos_t < -1.0 + 2e-5
    generic = torch.logical_not(small | near_pi)
    cos_g = torch.where(generic, cos_t, 0.0)
    theta_g = torch.arccos(cos_g)
    sin_g = torch.where(generic, torch.sin(theta_g), 1.0)
    w_generic = (theta_g / (2.0 * sin_g))[..., None, :] * a
    t2 = torch.sum(a * a, dim=-2) * 0.25
    w_small = 0.5 * a * (1.0 + t2 / 6.0 + 7.0 * t2 * t2 / 360.0)[..., None, :]
    sin_p = torch.sqrt(torch.clamp(torch.sum(a * a, dim=-2) * 0.25, min=0.0) + 1e-30)
    theta_p = math.pi - torch.arcsin(torch.clamp(sin_p, 0.0, 1.0))
    diag = torch.stack([R[..., 0, 0, :], R[..., 1, 1, :], R[..., 2, 2, :]], dim=-2)
    one_m_cos = torch.where(near_pi, 1.0 - cos_t, 1.0)
    axis_abs = torch.sqrt(torch.clamp(
        (diag - cos_t[..., None, :]) / one_m_cos[..., None, :], min=0.0))
    ones = torch.ones_like(a)
    sgn = torch.where(a >= 0.0, ones, -ones)
    w_pi = theta_p[..., None, :] * axis_abs * sgn
    return torch.where(near_pi[..., None, :], w_pi,
                       torch.where(small[..., None, :], w_small, w_generic))


def so3_jacobians(w):
    """Left Jacobian V and V^-1 of SO(3): V = (1 - c t^2) I + b W + c w w^T,
    Vinv = (1 - e t^2) I - W/2 + e w w^T (same coefficients as ops.lie)."""
    theta2 = torch.sum(w * w, dim=-2)
    small = theta2 < _small2(w.dtype)
    t2s = torch.where(small, 1.0, theta2)
    ts = torch.sqrt(t2s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (ts - torch.sin(ts)) / (t2s * ts))
    denom = 2.0 * ts * torch.where(small, 1.0, torch.sin(ts))
    e = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(ts)) / denom)
    w0, w1, w2 = w[..., 0, :], w[..., 1, :], w[..., 2, :]

    def build(diag_coef, skew_coef, outer_coef):
        return _mat3([
            [diag_coef + outer_coef * w0 * w0,
             -skew_coef * w2 + outer_coef * w0 * w1,
             skew_coef * w1 + outer_coef * w0 * w2],
            [skew_coef * w2 + outer_coef * w0 * w1,
             diag_coef + outer_coef * w1 * w1,
             -skew_coef * w0 + outer_coef * w1 * w2],
            [-skew_coef * w1 + outer_coef * w0 * w2,
             skew_coef * w0 + outer_coef * w1 * w2,
             diag_coef + outer_coef * w2 * w2],
        ])

    V = build(1.0 - c * theta2, b, c)
    Vinv = build(1.0 - e * theta2, -0.5 * torch.ones_like(b), e)
    return V, Vinv


def exp6(v):
    """se(3) (...,6,N) [lin; ang] -> (R, p)."""
    lin, ang = v[..., :3, :], v[..., 3:, :]
    R = exp3(ang)
    V, _ = so3_jacobians(ang)
    return R, mv(V, lin)


def log6(R, p):
    """SE(3) -> tangent (...,6,N) [lin; ang]."""
    w = log3(R)
    _, Vinv = so3_jacobians(w)
    return torch.cat([mv(Vinv, p), w], dim=-2)


def freeflyer_integrate(pq, v):
    """pq (...,7,N) [p; quat xyzw], v (...,6,N) local tangent -> new pq."""
    p, q = pq[..., :3, :], pq[..., 3:7, :]
    R = quat_to_rotmat(q)
    dR, dp = exp6(v)
    q_new = rotmat_to_quat(mm(R, dR))
    p_new = p + mv(R, dp)
    return torch.cat([p_new, q_new], dim=-2)


def freeflyer_difference(pq1, pq2):
    """log6(M1^-1 M2) (...,6,N)."""
    p1, q1 = pq1[..., :3, :], pq1[..., 3:7, :]
    p2, q2 = pq2[..., :3, :], pq2[..., 3:7, :]
    R1 = quat_to_rotmat(q1)
    R2 = quat_to_rotmat(q2)
    dR = mtm(R1, R2)
    dp = mtv(R1, p2 - p1)
    return log6(dR, dp)


# ---------------------------------------------------------------------------
# Spatial algebra, components on axis -2 ([lin; ang])
# ---------------------------------------------------------------------------


def motion_action_inv(R, p, v):
    """Motion in A coords -> B coords, (R, p) = aMb."""
    lin, ang = v[..., :3, :], v[..., 3:, :]
    ang_b = mtv(R, ang)
    lin_b = mtv(R, lin - cross(p, ang))
    return torch.cat([lin_b, ang_b], dim=-2)


def force_action(R, p, f):
    """Force in B coords -> A coords."""
    lin, ang = f[..., :3, :], f[..., 3:, :]
    lin_a = mv(R, lin)
    ang_a = mv(R, ang) + cross(p, lin_a)
    return torch.cat([lin_a, ang_a], dim=-2)


def motion_cross(v, m):
    vl, va = v[..., :3, :], v[..., 3:, :]
    ml, ma = m[..., :3, :], m[..., 3:, :]
    return torch.cat([cross(va, ml) + cross(vl, ma), cross(va, ma)], dim=-2)


def motion_cross_star(v, f):
    vl, va = v[..., :3, :], v[..., 3:, :]
    fl, fa = f[..., :3, :], f[..., 3:, :]
    return torch.cat([cross(va, fl), cross(va, fa) + cross(vl, fl)], dim=-2)


def solve_spd3(A, b):
    """Unrolled 3x3 Cholesky solve, A (...,3,3,N) SPD, b (...,3,N)."""
    a00 = torch.sqrt(torch.clamp(A[..., 0, 0, :], min=1e-30))
    l10 = A[..., 1, 0, :] / a00
    l20 = A[..., 2, 0, :] / a00
    a11 = torch.sqrt(torch.clamp(A[..., 1, 1, :] - l10 * l10, min=1e-30))
    l21 = (A[..., 2, 1, :] - l20 * l10) / a11
    a22 = torch.sqrt(torch.clamp(A[..., 2, 2, :] - l20 * l20 - l21 * l21, min=1e-30))
    y0 = b[..., 0, :] / a00
    y1 = (b[..., 1, :] - l10 * y0) / a11
    y2 = (b[..., 2, :] - l20 * y0 - l21 * y1) / a22
    x2 = y2 / a22
    x1 = (y1 - l21 * x2) / a11
    x0 = (y0 - l10 * x1 - l20 * x2) / a00
    return torch.stack([x0, x1, x2], dim=-2)


def solve_spd6(A, b):
    """Unrolled 6x6 Cholesky solve, A (...,6,6,N) SPD, b (...,6,N)."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[..., i, j, :]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-2)


# ---------------------------------------------------------------------------
# Configuration-space ops (free-flyer root + 1-dof chain layout)
# ---------------------------------------------------------------------------


def _check_layout(model: RobotModel) -> bool:
    """True iff joint 0 is the free-flyer root and 1..nj-1 are 1-dof."""
    return (model.joint_types[0] == FREE
            and all(t != FREE for t in model.joint_types[1:]))


def _require_layout(model: RobotModel, where: str) -> None:
    if not _check_layout(model):
        raise NotImplementedError(
            f"unsupported joint layout for SoA {where}: expected free-flyer "
            "root followed by 1-dof joints")


def integrate(model: RobotModel, q, dq):
    """q (nq,N) (+) dq (nv,N) -> (nq,N)."""
    if model.joint_types and model.joint_types[0] == FREE:
        _require_layout(model, "integrate")
        base = freeflyer_integrate(q[..., :7, :], dq[..., :6, :])
        return torch.cat([base, q[..., 7:, :] + dq[..., 6:, :]], dim=-2)
    if any(t == FREE for t in model.joint_types):
        raise NotImplementedError("unsupported joint layout for SoA integrate")
    return q + dq


def difference(model: RobotModel, q1, q2):
    if model.joint_types and model.joint_types[0] == FREE:
        _require_layout(model, "difference")
        base = freeflyer_difference(q1[..., :7, :], q2[..., :7, :])
        return torch.cat([base, q2[..., 7:, :] - q1[..., 7:, :]], dim=-2)
    if any(t == FREE for t in model.joint_types):
        raise NotImplementedError("unsupported joint layout for SoA difference")
    return q2 - q1


def state_integrate(model: RobotModel, x, dx):
    nq, nv = model.nq, model.nv
    return torch.cat(
        [integrate(model, x[..., :nq, :], dx[..., :nv, :]),
         x[..., nq:, :] + dx[..., nv:, :]], dim=-2)


def state_difference(model: RobotModel, x1, x2):
    nq = model.nq
    return torch.cat(
        [difference(model, x1[..., :nq, :], x2[..., :nq, :]),
         x2[..., nq:, :] - x1[..., nq:, :]], dim=-2)


# ---------------------------------------------------------------------------
# World-frame kernels (ops.world parity, trailing batch)
# ---------------------------------------------------------------------------


def fk_world(model: RobotModel, q):
    """(oR (nj,3,3,N), op (nj,3,N)) — pointer-doubling FK."""
    tab = _world.tables(model)
    dt = _world.device_tables(model, q.dtype, q.device)
    nj = tab.jR.shape[0]
    N = q.shape[-1]
    jR = dt["jR"][..., None]  # (nj,3,3,1)
    jp = dt["jp"][..., None]  # (nj,3,1)

    blocks_R, blocks_p = [], []
    if tab.free_base:
        _require_layout(model, "fk_world")
        blocks_R.append(quat_to_rotmat(q[3:7, :])[None])
        blocks_p.append(q[0:3, :][None])
    if len(tab.one_dof):
        th = q[dt["qidx"], :]  # (n1, N)
        ax = dt["axes"][..., None]  # (n1,3,1)
        prs = dt["is_prismatic"][:, None, None]  # (n1,1,1)
        w = ax * (th[:, None, :] * (1.0 - prs))  # (n1,3,N)
        blocks_R.append(exp3(w))
        blocks_p.append(ax * (th[:, None, :] * prs))
    Rl = torch.cat(blocks_R, dim=0)
    pl = torch.cat(blocks_p, dim=0)
    if not tab.free_base and len(tab.one_dof) != nj:
        raise NotImplementedError("unsupported joint layout for SoA FK")

    R = mm(jR, Rl)
    p = jp + mv(jR, pl.expand(nj, 3, N))

    eR = torch.eye(3, dtype=q.dtype, device=q.device)[..., None].expand(1, 3, 3, N)
    ep = torch.zeros((1, 3, N), dtype=q.dtype, device=q.device)
    for anc in dt["doubling"]:
        Rpad = torch.cat([R, eR], dim=0)
        ppad = torch.cat([p, ep], dim=0)
        Ra = Rpad[anc]
        pa = ppad[anc]
        R = mm(Ra, R)
        p = pa + mv(Ra, p)
    return R, p


def frame_placements_world(model: RobotModel, oR, op, frame_ids=None):
    dt = _world.device_tables(model, oR.dtype, oR.device)
    fR, fp, par = dt["fR"], dt["fp"], dt["fparent"]
    if frame_ids is not None:
        ids = _world.index_tensor(frame_ids, oR.device)
        fR, fp, par = fR[ids], fp[ids], par[ids]
    fR = fR[..., None]
    fp = fp[..., None]
    Rj = oR[par]
    pj = op[par]
    Rw = mm(Rj, fR)
    pw = pj + mv(Rj, fp.expand(fp.shape[:-1] + (oR.shape[-1],)))
    return Rw, pw


def world_axes(model: RobotModel, oR, op):
    """Sw (nv, 6, N): world dof axes measured at the origin."""
    tab = _world.tables(model)
    dt = _world.device_tables(model, oR.dtype, oR.device)
    rows = []
    if tab.free_base:
        R0, p0 = oR[0], op[0]  # (3,3,N), (3,N)
        for d in range(3):  # linear base dofs
            lin = R0[..., :, d, :]
            rows.append(torch.cat([lin, torch.zeros_like(lin)], dim=-2))
        for d in range(3):  # angular base dofs
            col = R0[..., :, d, :]
            rows.append(torch.cat([cross(p0, col), col], dim=-2))
    if len(tab.one_dof):
        jj = dt["one_dof"]
        ax = dt["axes"][..., None]  # (n1,3,1)
        aw = mv(oR[jj], ax.expand(ax.shape[:-1] + (oR.shape[-1],)))
        prs = dt["is_prismatic"][:, None, None]
        lin = (1.0 - prs) * cross(op[jj], aw) + prs * aw
        ang = (1.0 - prs) * aw
        onedof = torch.cat([lin, ang], dim=-2)  # (n1,6,N)
        if rows:
            return torch.cat([torch.stack(rows, dim=0), onedof], dim=0)
        return onedof
    return torch.stack(rows, dim=0)


def body_velocities(model: RobotModel, Sw, v):
    """vW (nj, 6, N) = ancestor-masked sum of dof axis motions."""
    mask = _world.device_tables(model, v.dtype, v.device)["mask"]
    X = Sw * v[:, None, :]  # (nv, 6, N)
    return torch.einsum("jd,dkn->jkn", mask, X)


def com_world(model: RobotModel, oR, op):
    tab = _world.tables(model)
    dt = _world.device_tables(model, oR.dtype, oR.device)
    c = dt["coms"][..., None]
    cj = op + mv(oR, c.expand(c.shape[:-1] + (oR.shape[-1],)))
    return torch.einsum("j,jkn->kn", dt["masses"], cj) / tab.total_mass


def inertia_apply(model: RobotModel, oR, op, mW):
    """out[j] = X*_{O<-j} (I_loc[j] (X_{j<-O} mW[j])), (nj,6,N)->(nj,6,N)."""
    I_loc = _world.device_tables(model, mW.dtype, mW.device)["I_loc"]
    vloc = motion_action_inv(oR, op, mW)
    hloc = torch.einsum("jab,jbn->jan", I_loc, vloc)
    return force_action(oR, op, hloc)


def shift_to_com(h, com):
    """Spatial force at origin -> at CoM: h (...,6,N), com (...,3,N)."""
    lin, ang = h[..., :3, :], h[..., 3:, :]
    return torch.cat([lin, ang - cross(com, lin)], dim=-2)


def agx(model: RobotModel, oR, op, Sw, x, com):
    """Ag(q) @ x about the CoM (6, N) without forming Ag."""
    vW = body_velocities(model, Sw, x)
    hO = inertia_apply(model, oR, op, vW)
    return shift_to_com(torch.sum(hO, dim=0), com)


def ag6(model: RobotModel, oR, op, Sw, com):
    """Ag[:, :6] as (6 momentum coords, 6 base dofs, N)."""
    I_loc = _world.device_tables(model, oR.dtype, oR.device)["I_loc"]
    basis = Sw[:6][None]  # (1, 6dof, 6comp, N)
    vloc = motion_action_inv(oR[:, None], op[:, None], basis)
    hloc = torch.einsum("jab,jdbn->jdan", I_loc, vloc)
    hO = force_action(oR[:, None], op[:, None], hloc)
    cols = torch.sum(hO, dim=0)  # (6dof, 6comp, N)
    cols = shift_to_com(cols, com[None])
    return cols.transpose(-3, -2)  # (6comp, 6dof, N)


def composite_rot_inertia(model: RobotModel, oR, op, com):
    """I_c (3,3,N): composite rotational inertia about the CoM, world axes."""
    tab = _world.tables(model)
    I_loc = _world.device_tables(model, oR.dtype, oR.device)["I_loc"]
    dtype, device = oR.dtype, oR.device
    N = oR.shape[-1]
    nj = oR.shape[0]
    basis = torch.cat(
        [torch.zeros((3, 3, N), dtype=dtype, device=device),
         torch.eye(3, dtype=dtype, device=device)[..., None].expand(3, 3, N)],
        dim=-2)[None]  # (1, 3 basis, 6 comp, N): lin = 0, ang = e_k
    vloc = motion_action_inv(oR[:, None], op[:, None], basis.expand(nj, 3, 6, N))
    hloc = torch.einsum("jab,jdbn->jdan", I_loc, vloc)
    hO = torch.sum(force_action(oR[:, None], op[:, None], hloc), dim=0)
    # I_O[i, k] = ang component i of the response to angular basis k
    I_O = hO[:, 3:, :].transpose(-3, -2)  # (3, 3, N)
    m = tab.total_mass
    c0, c1, c2 = com[..., 0, :], com[..., 1, :], com[..., 2, :]
    cc = _mat3([[c0 * c0, c0 * c1, c0 * c2],
                [c1 * c0, c1 * c1, c1 * c2],
                [c2 * c0, c2 * c1, c2 * c2]])
    c2sum = (c0 * c0 + c1 * c1 + c2 * c2)[..., None, None, :]
    # (c x)(c x) = c c^T - |c|^2 I
    return I_O + m * (cc - c2sum * eye3(com))


def centroidal_solve6(model: RobotModel, oR, op, com, b):
    """Solve  Ag[:, :6] x = b  in closed form, b (6, N) -> x (6, N): un-shift
    the momentum to the origin, invert the composite spatial inertia via its
    (m, c, I_c) parameters (one 3x3 SPD solve), map the world twist back to
    base-local coordinates."""
    tab = _world.tables(model)
    m = tab.total_mass
    lin, ang = b[..., :3, :], b[..., 3:, :]
    ang_O = ang + cross(com, lin)  # un-shift: momentum about the origin
    I_c = composite_rot_inertia(model, oR, op, com)
    # h_ang_O = I_c w + c x h_lin  =>  w = I_c^-1 (ang_O - c x lin)
    w = solve_spd3(I_c, ang_O - cross(com, lin))
    # h_lin = m (vl + w x c)  =>  vl = lin/m - w x c
    vl = lin / m - cross(w, com)
    return motion_action_inv(oR[0], op[0], torch.cat([vl, w], dim=-2))


def bias_hdot(model: RobotModel, oR, op, Sw, vW, v, com):
    """Adot @ v about the CoM (6, N) (ops.world.bias_hdot parity)."""
    dt = _world.device_tables(model, v.dtype, v.device)
    hO = inertia_apply(model, oR, op, vW)
    vb = vW[dt["dof_joint"]]  # (nv, 6, N)
    c = motion_cross(vb, Sw) * v[:, None, :]
    aW = torch.einsum("jd,dkn->jkn", dt["mask"], c)
    fb = motion_cross_star(vW, hO) + inertia_apply(model, oR, op, aW)
    return shift_to_com(torch.sum(fb, dim=0), com)


def frame_velocities_world(model: RobotModel, vW, fRw, fpw, fparent):
    """(v_world_aligned (nf,6,N), v_local (nf,6,N))."""
    if not torch.is_tensor(fparent):
        fparent = _world.index_tensor(fparent, vW.device)
    vj = vW[fparent]
    lin = vj[..., :3, :] + cross(vj[..., 3:, :], fpw)
    ang = vj[..., 3:, :]
    v_loc = torch.cat([mtv(fRw, lin), mtv(fRw, ang)], dim=-2)
    return torch.cat([lin, ang], dim=-2), v_loc
