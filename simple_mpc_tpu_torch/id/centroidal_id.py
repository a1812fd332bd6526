"""Centroidal-MPC tracking ID: the CoM and swing-foot task extension.

Port of `simple_mpc_tpu.id.centroidal_id` (reference
src/inverse-dynamics/centroidal-id.cpp): the base task masked to its
orientation (:10-20), a CoM task (:22-29) and per-foot SE3 swing-tracking
tasks, masked to the position for point feet and active only for the feet
out of contact (:31-52, 105-139); `set_target` delegates to the
kinodynamics base with the reference posture (:88-145).  TSID's
add/removeTask churn is weight masking: the tracking rows are always in the
QP with weight w_feet_tracking (1 - contact).

The assembly runs through `kernels.id_assemble`: on the card
`kernels.centroidal_id_assemble` (csrc/id_centroidal.cu); its twin is
`_assemble_core` with `_extra_tasks` below, whose J-dot v terms are
`torch.func.jvp`s along the flow q' = v as in `KinodynamicsID`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from ..models.handler import QUAD
from ..ops import soa, soa_dyn
from .kinodynamics_id import IDSettings, KinodynamicsID


def _com_jacobian(m, oR, op, Sw, com):
    """J_com = Ag[:3] / mass as (3, nv, N), one agx column per dof."""
    nv, N = m.nv, Sw.shape[-1]
    basis = torch.eye(nv, dtype=Sw.dtype, device=Sw.device)[..., None].expand(nv, nv, N)
    cols = vmap(lambda e: soa.agx(m, oR, op, Sw, e, com)[:3])(basis)  # (nv, 3, N)
    return cols.transpose(0, 1) / m.total_mass()


class CentroidalID(KinodynamicsID):
    def __init__(self, model_handler, control_dt: float, settings, device="cuda",
                 dtype=torch.float64):
        if isinstance(settings, dict):
            settings = IDSettings.from_dict(settings)
        # base task orientation-only mask (centroidal-id.cpp:10-20)
        self._base_mask = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
        self.device, self.dtype = torch.device(device), dtype
        m = model_handler.model
        nk = model_handler.n_feet
        # initial targets from the reference-state FK (centroidal-id.cpp:55-84)
        x_ref = np.asarray(model_handler.reference_state, np.float64)
        q_ref = torch.as_tensor(x_ref[: m.nq])[:, None]
        oR, op = soa.fk_world(m, q_ref)
        fR, fp = soa.frame_placements_world(m, oR, op,
                                            np.asarray(model_handler.feet_frame_ids))
        self._targets = dict(
            com_t=self._tensor(soa.com_world(m, oR, op)[:, 0]),
            com_v_t=self._tensor(np.zeros(3)),
            feet_p_t=self._tensor(fp[..., 0]),
            feet_R_t=self._tensor(fR[..., 0]),
            feet_v_t=self._tensor(np.zeros((nk, 6))))
        # the reference posture of the kinodynamics targets, made once
        self._posture = (self._tensor(x_ref[: m.nq]), self._tensor(x_ref[m.nq:]),
                         self._tensor(np.zeros(m.nv)))
        super().__init__(model_handler, control_dt, settings, device, dtype)

    # ------------------------------------------------------------------
    def set_target(self, *args, **kwargs):
        """Either the centroidal signature (com_pos, com_vel, feet_pose,
        feet_vel, contacts, f) with feet_pose a sequence of (R, p) and
        feet_vel of 6-vectors per foot, or the kinodynamics one (q_target,
        v_target, a_target, contacts, f), which the constructor uses.
        Tensors already on the ID's device are taken as they are."""
        if len(args) == 5 or "q_target" in kwargs:
            return super().set_target(*args, **kwargs)
        com_pos, com_vel, feet_pose, feet_vel, contacts, f_target = args

        def stack(xs, shape):
            return torch.stack([self._tensor(x).reshape(shape) for x in xs])

        self._targets.update(
            com_t=self._tensor(com_pos), com_v_t=self._tensor(com_vel),
            feet_R_t=stack([R for R, _ in feet_pose], (3, 3)),
            feet_p_t=stack([p for _, p in feet_pose], (3,)),
            feet_v_t=stack(feet_vel, (6,)))
        # delegate with the reference posture (centroidal-id.cpp:140-144)
        super().set_target(*self._posture, contacts, f_target)

    # ------------------------------------------------------------------
    def _extra_tasks(self, q, v, targets, dtype):
        """The CoM and swing-foot task rows (J (B, rows, nz), r0 (B, rows),
        w (B, rows)) of B robots: q (B, nq), v (B, nv), targets with a
        leading B."""
        s, m = self.settings, self.model
        nv, nz, nk = self.nv, self.nz, self.nk
        nb, device = q.shape[0], q.device
        Q, V = q.T, v.T
        t0 = torch.zeros((), dtype=dtype, device=device)
        one = torch.ones_like(t0)
        rows = []

        def kin(qq):
            oR, op = soa.fk_world(m, qq)
            return oR, op, soa.world_axes(m, oR, op)

        def padded(J):  # (rows, nv, B) -> (B, rows, nz)
            out = torch.zeros((nb, J.shape[0], nz), dtype=dtype, device=device)
            out[:, :, :nv] = J.permute(2, 0, 1)
            return out

        # CoM task (centroidal-id.cpp:22-29): J_com = Ag_lin / mass
        if s.w_com > 0.0:
            kp = s.kp_com
            kd = 2.0 * np.sqrt(kp)
            oR, op, Sw = kin(Q)
            com = soa.com_world(m, oR, op)
            Jcom = _com_jacobian(m, oR, op, Sw, com)  # (3, nv, B)
            com_v = torch.einsum("rvn,vn->rn", Jcom, V)

            def hlin(t):
                oR2, op2, Sw2 = kin(soa.integrate(m, Q, t * V))
                com2 = soa.com_world(m, oR2, op2)
                return soa.agx(m, oR2, op2, Sw2, V, com2)[:3] / m.total_mass()

            jdotv = jvp(hlin, (t0,), (one,))[1]
            a_des = kp * (targets["com_t"].T - com) + kd * (targets["com_v_t"].T - com_v)
            rows.append((padded(Jcom), (jdotv - a_des).T,
                         torch.full((nb, 3), s.w_com, dtype=dtype, device=device)))

        # swing-foot tracking (centroidal-id.cpp:31-52, 105-139): active for
        # feet NOT in contact; position-only for point feet
        if s.w_feet_tracking > 0.0:
            kp = s.kp_feet_tracking
            kd = 2.0 * np.sqrt(kp)

            def jacobians(qq):
                oR2, op2, Sw2 = kin(qq)
                J6 = soa_dyn.contact_jacobians(m, oR2, op2, Sw2, self.feet_fids, 6)[0]
                return J6.reshape(nk, 6, nv, nb)

            J6, J6dot = jvp(lambda t: jacobians(soa.integrate(m, Q, t * V)), (t0,), (one,))
            jdotv6 = torch.einsum("krvn,vn->krn", J6dot, V)
            oR, op, _ = kin(Q)
            fR, fp = soa.frame_placements_world(m, oR, op, np.asarray(self.feet_fids))
            ndim = 6 if self.mh.feet_types[0] == QUAD else 3
            contacts = targets["contacts"]
            for k in range(nk):
                e_pos = targets["feet_p_t"][:, k].T - fp[k]
                if ndim == 6:
                    Rk = fR[k]
                    e_rot = soa.mv(Rk, soa.log3(soa.mtm(Rk, targets["feet_R_t"][:, k].permute(
                        1, 2, 0))))
                    e = torch.cat([e_pos, e_rot], dim=0)
                    v_ref = targets["feet_v_t"][:, k].T
                else:
                    e = e_pos
                    v_ref = targets["feet_v_t"][:, k, :3].T
                Jk, jdv = J6[k, :ndim], jdotv6[k, :ndim]
                vf = torch.einsum("rvn,vn->rn", Jk, V)
                a_des = kp * e + kd * (v_ref - vf)
                w = s.w_feet_tracking * (1.0 - contacts[:, k])
                rows.append((padded(Jk), (jdv - a_des).T,
                             torch.ones((nb, ndim), dtype=dtype, device=device) * w[:, None]))
        return rows
