"""Articulated dynamics in the lanes: unrolled Cholesky, mass matrix, bias
torques, contact Jacobians and the constrained-dynamics KKT solve.

Port of `simple_mpc_tpu.ops.soa_dyn` (kernel K7 of the full-dynamics
path).  Layout (components..., N) as in ops/soa.py; the n x n
factorizations are written out entry by entry, so every torch op is
elementwise over the trailing (lane) axes, and the pivot is floored at
1e-30 exactly as the JAX package does.  The plain Riccati pass
(`kernels.riccati_backward_plain`) factors its Quu with these too.

These functions are the plain twins of the full-dynamics stage kernels
(csrc/fulldyn.cuh): the CPU path and the card's reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from ..models.model import RobotModel
from . import soa
from . import world as _world


def chol_unrolled(A):
    """Lower Cholesky of A (n, n, ...lanes) as a list-of-lists of lane
    tensors."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_unrolled(L, b):
    """Solve (L L^T) x = b with b (n, ...rhs/lanes); extra rhs axes
    broadcast against the lane-shaped L entries."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=0)


def solve_spd(A, b):
    """Unrolled SPD solve, A (n, n, ...), b (n, ...)."""
    return chol_solve_unrolled(chol_unrolled(A), b)


# ---------------------------------------------------------------------------
# World-frame spatial inertias (about the origin), (nj, 6, 6, N)
# ---------------------------------------------------------------------------

_body_cache: dict = {}


def _static_body_params(model: RobotModel):
    """(masses (nj,), local body CoMs (nj, 3), rotational inertias about
    the body CoM in the joint frame (nj, 3, 3)), numpy float64."""
    tab = _world.tables(model)
    hit = _body_cache.get(id(tab))
    if hit is not None and hit[0] is tab:
        return hit[1]
    nj = model.njoints
    masses = np.asarray(tab.masses, np.float64)
    coms = np.asarray(tab.coms, np.float64)
    # I_loc[3:,3:] = I_com_loc - m C C  (C = skew(c_loc))  =>  recover I_com
    I_com = np.empty((nj, 3, 3))
    for j in range(nj):
        c = coms[j]
        C = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0.0]])
        I_com[j] = np.asarray(tab.I_loc[j][3:, 3:]) + masses[j] * (C @ C)
    out = (masses, coms, I_com)
    _body_cache[id(tab)] = (tab, out)
    return out


def _as(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def body_inertias_world(model: RobotModel, oR, op):
    """IW (nj, 6, 6, N): world-frame spatial inertia of every body about
    the world ORIGIN, [lin; ang] order:
        [[m E, -m skew(c)], [m skew(c), I_c - m skew(c) skew(c)]]
    with c the body-CoM world position and I_c = R I_com R^T."""
    masses, coms, I_com = _static_body_params(model)
    N = oR.shape[-1]
    nj = oR.shape[0]
    m = _as(masses, oR)[:, None, None, None]  # (nj,1,1,1)
    cl = _as(coms, oR)[..., None]  # (nj,3,1)
    c = op + soa.mv(oR, cl.expand(nj, 3, N))  # world body CoM
    Ic = soa.mm(soa.mm(oR, _as(I_com, oR)[..., None]), soa.transpose3(oR))
    z = torch.zeros_like(c[:, 0])
    C = soa._mat3([[z, -c[:, 2], c[:, 1]],
                   [c[:, 2], z, -c[:, 0]],
                   [-c[:, 1], c[:, 0], z]])  # (nj,3,3,N)
    E = torch.eye(3, dtype=oR.dtype, device=oR.device)[..., None].expand(nj, 3, 3, N)
    top = torch.cat([m * E, -m * C], dim=-2)  # rows lin
    bot = torch.cat([m * C, Ic - m * soa.mm(C, C)], dim=-2)
    return torch.cat([top, bot], dim=-3)  # (nj,6,6,N)


def _ancestor_dof_matrix(model: RobotModel) -> np.ndarray:
    """(nv, nv) A[d1, d2] = 1 iff dof d1 is ancestor-or-self of the joint
    carrying dof d2 (static selector for the CRBA branch structure)."""
    tab = _world.tables(model)
    return np.asarray(tab.mask)[np.asarray(tab.dof_joint)].T  # (nv, nv)


def crba_world(model: RobotModel, oR, op, Sw, IW=None):
    """Joint-space mass matrix M (nv, nv, N) via world-frame composite
    rigid bodies: M[d1,d2] = Sw_d1 . I^C_{body(deeper dof)} Sw_d2."""
    dt = _world.device_tables(model, oR.dtype, oR.device)
    if IW is None:
        IW = body_inertias_world(model, oR, op)
    # subtree composite seen by each dof: IC[d] = sum_{j descendant} IW[j]
    IC = torch.einsum("jd,jabn->dabn", dt["mask"], IW)  # (nv,6,6,N)
    F = torch.einsum("dabn,dbn->dan", IC, Sw)  # (nv,6,N)
    G = torch.einsum("dan,ean->den", Sw, F)  # G[d1,d2] = Sw_d1 . IC_d2 Sw_d2
    # M[d1,d2] = G[d1,d2] if d1 ancestor of body(d2); G[d2,d1] if d2
    # ancestor of body(d1); 0 for branch-disjoint dof pairs
    A = torch.as_tensor(_ancestor_dof_matrix(model) > 0, device=oR.device)[..., None]
    zero = torch.zeros((), dtype=oR.dtype, device=oR.device)
    return torch.where(A, G, torch.where(A.transpose(0, 1), G.transpose(0, 1), zero))


def nle_world(model: RobotModel, oR, op, Sw, vW, v, IW=None):
    """Nonlinear effects b(q, v) (nv, N): Coriolis/centrifugal + gravity
    via the base-acceleration trick in world coordinates."""
    dt = _world.device_tables(model, oR.dtype, oR.device)
    if IW is None:
        IW = body_inertias_world(model, oR, op)
    mask = dt["mask"]
    # bias body accelerations: aW[j] = sum_{d in anc(j)} (vW_{b(d)} x Sw_d) v_d
    vb = vW[dt["dof_joint"]]  # (nv,6,N)
    c = soa.motion_cross(vb, Sw) * v[:, None, :]
    aW = torch.einsum("jd,dkn->jkn", mask, c)
    ag = _as(np.concatenate([-np.asarray(model.gravity, np.float64), np.zeros(3)]),
             oR)[:, None]  # fictitious base acceleration
    a_tot = aW + ag[None]
    f = (torch.einsum("jabn,jbn->jan", IW, a_tot)
         + soa.motion_cross_star(vW, torch.einsum("jabn,jbn->jan", IW, vW)))
    Fsub = torch.einsum("jd,jan->dan", mask, f)  # subtree force per dof
    return torch.einsum("dan,dan->dn", Sw, Fsub)


# ---------------------------------------------------------------------------
# Contact Jacobians (world-aligned / local), (nc*dim, nv, N)
# ---------------------------------------------------------------------------


def contact_jacobians(model: RobotModel, oR, op, Sw, feet_ids, dim: int):
    """Stacked contact Jacobians of the feet frames: dim=3 -> LOCAL linear
    rows, dim=6 -> LOCAL_WORLD_ALIGNED.  Returns (J (nk*dim, nv, N), fRw,
    fpw)."""
    tab = _world.tables(model)
    ids = np.asarray(feet_ids)
    fRw, fpw = soa.frame_placements_world(model, oR, op, ids)  # (nk,3,3,N),(nk,3,N)
    maskf = _as(np.asarray(tab.mask)[tab.fparent[ids]], oR)  # (nk,nv)
    nk, nv, N = len(ids), model.nv, Sw.shape[-1]
    lin = Sw[None, :, :3, :] + soa.cross(
        Sw[None, :, 3:, :].expand(nk, nv, 3, N), fpw[:, None])  # (nk, nv, 3, N)
    ang = Sw[None, :, 3:, :].expand(lin.shape)
    if dim == 3:
        # LOCAL: rotate the world-aligned point velocity into the foot frame
        J = soa.mtv(fRw[:, None], lin)  # (nk, nv, 3, N)
    else:
        J = torch.cat([lin, ang], dim=-2)  # (nk, nv, 6, N)
    J = J * maskf[:, :, None, None]
    # (nk, nv, dim, N) -> (nk, dim, nv, N) -> (nk*dim, nv, N)
    J = J.transpose(1, 2)
    return J.reshape(nk * dim, nv, J.shape[-1]), fRw, fpw


def _baumgarte_rows(gain, dim: int, n_contacts: int, like):
    """Static (n_contacts * dim,) per-row gain vector from a scalar or a
    per-dimension (dim,) Baumgarte gain (the same vector corrector gain is
    installed on every contact)."""
    arr = np.asarray(gain, dtype=np.float64).reshape(-1)
    if arr.size == 1:
        arr = np.full(dim, arr[0])
    if arr.size != dim:
        raise ValueError(
            f"Baumgarte gain must be scalar or ({dim},); got shape {arr.shape}")
    return _as(np.tile(arr, n_contacts), like)


def constrained_fwd_dynamics_soa(
    model: RobotModel,
    q,  # (nq, N)
    v,  # (nv, N)
    tau,  # (nv, N)
    feet_ids,
    active,  # (nk, N)
    dim: int = 3,
    ref_R=None,  # (nk, 3, 3, N)
    ref_p=None,  # (nk, 3, N)
    kp=0.0,  # Baumgarte gains: scalar or per-dimension (dim,) vector,
    kd=0.0,  # the same for every contact
    prox_mu: float = 1e-9,
    precomp=None,  # optional (oR, op, Sw, vW, IW) to share with the caller
):
    """Constrained articulated forward dynamics in the lanes: the KKT
    system of the active contacts with Baumgarte correction and a proximal
    term, through the masked Schur complement (Delassus matrix).

    Returns (ddq (nv, N), forces (nk, dim, N))."""
    dtype = q.dtype
    nk = len(feet_ids)
    nc = nk * dim
    N = q.shape[-1]

    if precomp is None:
        oR, op = soa.fk_world(model, q)
        Sw = soa.world_axes(model, oR, op)
        vW = soa.body_velocities(model, Sw, v)
        IW = body_inertias_world(model, oR, op)
    else:
        oR, op, Sw, vW, IW = precomp

    M = crba_world(model, oR, op, Sw, IW)
    b = nle_world(model, oR, op, Sw, vW, v, IW)

    # contact Jacobians + their time derivative along the flow q' = v
    def jac_of(qq):
        oR2, op2 = soa.fk_world(model, qq)
        Sw2 = soa.world_axes(model, oR2, op2)
        return contact_jacobians(model, oR2, op2, Sw2, feet_ids, dim)[0]

    t0 = torch.zeros((), dtype=dtype, device=q.device)
    Jc, Jdot = jvp(lambda t: jac_of(soa.integrate(model, q, t * v)), (t0,),
                   (torch.ones((), dtype=dtype, device=q.device),))
    jdot_v = torch.einsum("rvn,vn->rn", Jdot, v)

    kp_rows, kd_rows = (_baumgarte_rows(g, dim, nk, q) for g in (kp, kd))
    corr = kd_rows[:, None] * torch.einsum("rvn,vn->rn", Jc, v)
    if np.any(np.asarray(kp)):
        fRw, fpw = soa.frame_placements_world(model, oR, op, np.asarray(feet_ids))
        pr = torch.zeros((nk, 3, 1), dtype=dtype, device=q.device) if ref_p is None else ref_p
        if dim == 3:
            err = soa.mtv(fRw, fpw - pr)
        else:
            Rr = (torch.eye(3, dtype=dtype, device=q.device)[..., None].expand(nk, 3, 3, N)
                  if ref_R is None else ref_R)
            e6 = soa.log6(soa.mtm(Rr, fRw), soa.mtv(Rr, fpw - pr))
            err = torch.cat([soa.mv(Rr, e6[:, :3]), soa.mv(Rr, e6[:, 3:])], dim=-2)
        corr = corr + kp_rows[:, None] * err.reshape(nc, N)
    rhs_c = jdot_v + corr

    Lm = chol_unrolled(M)
    # one multi-rhs solve: [Jc^T | tau - b]
    rhs_all = torch.cat([Jc.transpose(0, 1), (tau - b)[:, None, :]], dim=1)  # (nv, nc+1, N)
    sol = chol_solve_unrolled(Lm, rhs_all)
    Minv_Jt, free_acc = sol[:, :nc, :], sol[:, nc, :]

    m_rows = active.repeat_interleave(dim, dim=0).to(dtype)  # (nc, N)
    A = torch.einsum("rvn,vsn->rsn", Jc, Minv_Jt)  # Delassus (nc, nc, N)
    prox = max(prox_mu, 50.0 * float(torch.finfo(dtype).eps))
    eye = torch.eye(nc, dtype=dtype, device=q.device)[..., None]
    # diag term = (1 - m) + prox, matching the generic path
    A = A * m_rows[:, None, :] * m_rows[None, :, :] + eye * (prox + 1.0) - eye * m_rows[None, :, :]
    rhs = m_rows * (torch.einsum("rvn,vn->rn", Jc, free_acc) + rhs_c)
    f = -solve_spd(A, rhs) * m_rows
    ddq = free_acc + torch.einsum("vrn,rn->vn", Minv_Jt, f)
    return ddq, f.reshape(nk, dim, N)
