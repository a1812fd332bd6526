"""Whole-body inverse-dynamics QP: the 1 kHz low-level control layer.

Port of `simple_mpc_tpu.id.kinodynamics_id` (`IDSettings`,
`KinodynamicsID`; reference src/inverse-dynamics/kinodynamics-id.cpp,
kinodynamics-id.hpp:22-47): a task-space ID problem over z = [ddq; f] with
  * the floating-base dynamics equality  M6 ddq + h6 = (Jc')6 f,
  * per-foot rigid-contact tasks (PD'd motion, Kd = 2 sqrt(Kp)) as hard
    equalities or weighted costs (`contact_motion_equality`),
  * posture and base SE3 motion tasks,
  * friction cones, normal-force bounds ([0.01, 10] m g), joint position /
    velocity viability bounds and actuation bounds,
solved by the ADMM QP (`id/qp.py`).  TSID's add/removeRigidContact is bound
and weight masking over one static problem, as in the JAX package.

The assembly and the QP take a leading batch of robots (`solve` runs one
robot as a batch of 1) and run through `kernels.id_assemble` and
`kernels.qp_admm`: their plain twins on CPU tensors, CUDA kernels
(csrc/id.cu or, for 6D feet and wide models, csrc/id_wide.cu, and
csrc/qp.cu) on the card.  The twin of the assembly is
`KinodynamicsID._assemble_core`, on the SoA rigid-body functions with the
robots in the lanes; its J-dot v is a `torch.func.jvp` along the flow
q' = v, as the JAX package takes it.  Point feet take 3D forces and the
friction pyramid; quad feet (Talos's soles) 6D wrenches, their
LOCAL_WORLD_ALIGNED [lin; ang] Jacobian rows and the 17-row wrench cone
of `ocp/cones.py` (`IDSettings.Lfoot`, `Wfoot`).  `CentroidalID`
(`id/centroidal_id.py`) adds its tasks through `_extra_tasks` and masks the
base task with `_base_mask`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
from torch.func import jvp

from ..models.handler import QUAD, RobotModelHandler
from ..ocp.cones import friction_cone_mat, wrench_cone_mat
from ..ops import soa, soa_dyn
from ..solver.proxddp import full_precision_matmuls

_INF = 1e20


@dataclasses.dataclass
class IDSettings:
    """Field parity with KinodynamicsID::Settings (kinodynamics-id.hpp:22-47)."""

    friction_coefficient: float = 0.6
    contact_weight_ratio_max: float = 10.0
    contact_weight_ratio_min: float = 0.01
    kp_base: float = 0.0
    kp_posture: float = 0.0
    kp_contact: float = 0.0
    w_base: float = -1.0
    w_posture: float = -1.0
    w_contact_motion: float = -1.0
    w_contact_force: float = -1.0
    contact_motion_equality: bool = False
    # CentroidalID extras (centroidal-id.hpp:17-26)
    kp_com: float = 0.0
    kp_feet_tracking: float = 0.0
    w_com: float = -1.0
    w_feet_tracking: float = -1.0
    # foot geometry for the 6D wrench cone (TSID Contact6d corner points)
    Lfoot: float = 0.1
    Wfoot: float = 0.075
    qp_iters: int = 100

    @classmethod
    def from_dict(cls, d: dict) -> "IDSettings":
        from ..utils.config import settings_from_dict

        return settings_from_dict(cls, d)


class KinodynamicsID:
    def __init__(self, model_handler: RobotModelHandler, control_dt: float, settings,
                 device="cuda", dtype=torch.float64):
        if isinstance(settings, dict):
            settings = IDSettings.from_dict(settings)
        full_precision_matmuls()
        self.settings = settings
        self.mh = model_handler
        self.model = model_handler.model
        self.device, self.dtype = torch.device(device), dtype
        self.dt = float(control_dt)
        m = self.model
        self.nq, self.nv = m.nq, m.nv
        self.nu = m.nv - 6
        self.nk = model_handler.n_feet
        self.fdim = 6 if (model_handler.feet_types
                          and model_handler.feet_types[0] == QUAD) else 3
        self.nz = self.nv + self.nk * self.fdim
        self.weight = model_handler.mass * 9.81
        self.max_f = settings.contact_weight_ratio_max * self.weight
        self.min_f = settings.contact_weight_ratio_min * self.weight
        self.feet_fids = list(model_handler.feet_frame_ids)
        if not hasattr(self, "_base_mask"):
            self._base_mask = np.ones(6)  # CentroidalID masks to orientation
        self._cone_mat = (friction_cone_mat(settings.friction_coefficient)
                          if self.fdim == 3 else
                          wrench_cone_mat(settings.friction_coefficient,
                                          settings.Lfoot, settings.Wfoot))
        self.n_cone = self._cone_mat.shape[0]
        self._consts = {}

        # default target: reference state, all feet in contact, weight/n on z
        # (kinodynamics-id.cpp:95-117)
        x_ref = np.asarray(model_handler.reference_state)
        f0 = np.zeros((self.nk, self.fdim))
        f0[:, 2] = self.weight / self.nk
        if not hasattr(self, "_targets"):
            self._targets = {}
        self.set_target(x_ref[: self.nq], x_ref[self.nq:], np.zeros(self.nv),
                        [True] * self.nk, f0)
        self._last = None
        self._qp_warm = None
        # dry run (kinodynamics-id.cpp:113-117)
        self.solve(0.0, x_ref[: self.nq], x_ref[self.nq:])

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def const(self, like) -> dict:
        """The model and task constants on `like`'s device and dtype, made
        once for each."""
        key = (like.dtype, like.device)
        if key not in self._consts:
            m = self.model

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                                       device=like.device)

            self._consts[key] = dict(
                cone=t(self._cone_mat),
                vmax=t(m.velocity_limit[6:]), qlo=t(m.lower_limit[7:]),
                qhi=t(m.upper_limit[7:]), taumax=t(m.effort_limit[6:]))
        return self._consts[key]

    # ------------------------------------------------------------------
    def set_target(self, q_target, v_target, a_target, contact_state_target, f_target):
        """(kinodynamics-id.cpp:120-186).  Tensors already on the ID's device
        are taken as they are (no copy, no host sync); f_target is a
        sequence of per-foot forces or a (nk, >= fdim) tensor."""
        if torch.is_tensor(f_target):
            f = f_target.reshape(self.nk, -1)[:, : self.fdim]
        else:
            f = torch.stack([torch.as_tensor(fk).reshape(-1)[: self.fdim].to(
                dtype=self.dtype, device=self.device) for fk in f_target])
        if not torch.is_tensor(contact_state_target):
            contact_state_target = np.asarray(contact_state_target, dtype=np.float64)
        self._targets.update(
            q_t=self._tensor(q_target), v_t=self._tensor(v_target),
            a_t=self._tensor(a_target), contacts=self._tensor(contact_state_target),
            f_t=self._tensor(f))

    # ------------------------------------------------------------------
    def _assemble_core(self, q, v, targets):
        """QP-data assembly (H, g, A, l, u, M, h, JcT), robots in the leading
        axis: q (B, nq), v (B, nv), targets with leading B.  The plain twin
        of `kernels.id_assemble`."""
        s, m = self.settings, self.model
        nv, nu, nk, fd, nz = self.nv, self.nu, self.nk, self.fdim, self.nz
        dtype, device = q.dtype, q.device
        nb = q.shape[0]
        c = self.const(q)
        q_t, v_t, a_t = targets["q_t"], targets["v_t"], targets["a_t"]
        contacts, f_t = targets["contacts"], targets["f_t"]
        Q, V = q.T, v.T  # robots in the lanes

        oR, op = soa.fk_world(m, Q)
        Sw = soa.world_axes(m, oR, op)
        vW = soa.body_velocities(m, Sw, V)
        IW = soa_dyn.body_inertias_world(m, oR, op)
        M = soa_dyn.crba_world(m, oR, op, Sw, IW).permute(2, 0, 1)  # (B, nv, nv)
        h = soa_dyn.nle_world(m, oR, op, Sw, vW, V, IW).T  # (B, nv)

        # LOCAL_WORLD_ALIGNED Jacobians (TSID useLocalFrame(false)) and
        # their J-dot v along the flow, in one jvp
        bid = self.mh.base_frame_id

        def jacobians(qq):
            oR2, op2 = soa.fk_world(m, qq)
            Sw2 = soa.world_axes(m, oR2, op2)
            J6 = soa_dyn.contact_jacobians(m, oR2, op2, Sw2, self.feet_fids + [bid], 6)[0]
            J6 = J6.reshape(nk + 1, 6, nv, nb)
            return J6[:nk, :fd].reshape(nk * fd, nv, nb), J6[nk]

        t0 = torch.zeros((), dtype=dtype, device=device)
        (Jc, Jb6), (Jdot, Jbdot) = jvp(lambda t: jacobians(soa.integrate(m, Q, t * V)),
                                       (t0,), (torch.ones_like(t0),))
        jdot_v = torch.einsum("rvn,vn->nr", Jdot, V)  # (B, nk*fd)
        vf = torch.einsum("rvn,vn->nr", Jc, V)
        Jc = Jc.permute(2, 0, 1)  # (B, nk*fd, nv)
        JcT = Jc.mT

        def where(cond, a, b):
            return torch.where(cond, torch.as_tensor(a, dtype=dtype, device=device),
                               torch.as_tensor(b, dtype=dtype, device=device))

        def zeros(rows):
            return torch.zeros((nb, rows, nz), dtype=dtype, device=device)

        def ident(rows, col):
            J = zeros(rows)
            J[:, :, col: col + rows] = torch.eye(rows, dtype=dtype, device=device)
            return J

        # ---- task residuals (costs): rows J_r z + r0, weights w ----------
        rows_J: List[torch.Tensor] = []
        rows_r0: List[torch.Tensor] = []
        rows_w: List[torch.Tensor] = []

        # posture task on actuated joints (kinodynamics-id.cpp:58-63)
        if s.w_posture > 0.0:
            kp, w = s.kp_posture, s.w_posture
            kd = 2.0 * np.sqrt(kp)
            a_des = a_t[:, 6:] + kp * (q_t[:, 7:] - q[:, 7:]) + kd * (v_t[:, 6:] - v[:, 6:])
            rows_J.append(ident(nu, 6))
            rows_r0.append(-a_des)
            rows_w.append(torch.full((nb, nu), w, dtype=dtype, device=device))

        # base SE3 task (kinodynamics-id.cpp:66-72; vel/acc rotated to
        # world-aligned with the measured base pose, :219-225)
        if s.w_base > 0.0:
            kp, w = s.kp_base, s.w_base
            kd = 2.0 * np.sqrt(kp)
            ids = np.asarray([bid])
            Rb, pb = (a[0] for a in soa.frame_placements_world(m, oR, op, ids))
            oRt, opt = soa.fk_world(m, q_t.T)
            Rt, pt = (a[0] for a in soa.frame_placements_world(m, oRt, opt, ids))
            e6 = torch.cat([pt - pb, soa.mv(Rb, soa.log3(soa.mtm(Rb, Rt)))], dim=0)
            v_t_wa = torch.cat([soa.mv(Rb, v_t[:, :3].T), soa.mv(Rb, v_t[:, 3:6].T)], dim=0)
            a_t_wa = torch.cat([soa.mv(Rb, a_t[:, :3].T), soa.mv(Rb, a_t[:, 3:6].T)], dim=0)
            vb = torch.einsum("rvn,vn->rn", Jb6, V)
            jdotv_b = torch.einsum("rvn,vn->rn", Jbdot, V)
            a_des_b = a_t_wa + kp * e6 + kd * (v_t_wa - vb)
            Jb = zeros(6)
            Jb[:, :, :nv] = Jb6.permute(2, 0, 1)
            rows_J.append(Jb)
            rows_r0.append((jdotv_b - a_des_b).T)
            mask = torch.as_tensor(self._base_mask, dtype=dtype, device=device)
            rows_w.append(w * mask.expand(nb, 6))

        # contact force regularization (w_contact_force, setTarget refs)
        act_rows = torch.repeat_interleave(contacts, fd, dim=-1)  # (B, nk*fd)
        if s.w_contact_force > 0.0:
            rows_J.append(ident(nk * fd, nv))
            rows_r0.append(-f_t.reshape(nb, nk * fd))
            rows_w.append(act_rows * s.w_contact_force)

        # contact motion: anchored at the measured foot pose each solve, so
        # the position error is 0 and the correction is velocity damping
        # (kinodynamics-id.cpp:196-217)
        kp_c = s.kp_contact
        kd_c = 2.0 * np.sqrt(kp_c) if kp_c > 0 else 0.0
        motion_rhs = jdot_v + kd_c * vf  # J ddq + rhs = 0 desired
        if (not s.contact_motion_equality) and s.w_contact_motion > 0.0:
            Jm = zeros(nk * fd)
            Jm[:, :, :nv] = Jc
            rows_J.append(Jm)
            rows_r0.append(motion_rhs)
            rows_w.append(act_rows * s.w_contact_motion)

        for (Je, r0e, we) in self._extra_tasks(q, v, targets, dtype):
            rows_J.append(Je)
            rows_r0.append(r0e)
            rows_w.append(we)

        Jr = torch.cat(rows_J, dim=1)
        r0 = torch.cat(rows_r0, dim=1)
        w = torch.cat(rows_w, dim=1)
        H = (Jr.mT * w[:, None, :]) @ Jr + 1e-8 * torch.eye(nz, dtype=dtype, device=device)
        g = (Jr.mT @ (w * r0)[..., None])[..., 0]

        # ---- constraints: l <= A z <= u ----------------------------------
        A_rows: List[torch.Tensor] = []
        lo: List[torch.Tensor] = []
        hi: List[torch.Tensor] = []

        # floating-base dynamics (TSID equality): M6 ddq - (Jc'f)6 = -h6
        A_rows.append(torch.cat([M[:, :6], -JcT[:, :6]], dim=2))
        lo.append(-h[:, :6])
        hi.append(-h[:, :6])

        act = act_rows > 0.5
        # contact motion hard equality (contact_motion_equality mode)
        if s.contact_motion_equality:
            Am = zeros(nk * fd)
            Am[:, :, :nv] = Jc
            A_rows.append(Am)
            lo.append(where(act, -motion_rhs, -_INF))
            hi.append(where(act, -motion_rhs, _INF))

        # inactive contact force = 0 (TSID removeRigidContact equivalent)
        A_rows.append(ident(nk * fd, nv))
        lo.append(where(act, -_INF, 0.0))
        hi.append(where(act, _INF, 0.0))

        # friction pyramid / wrench cone rows per foot + normal-force bounds
        # (active)
        Acone = zeros(nk * self.n_cone)
        for k in range(nk):
            Acone[:, k * self.n_cone: (k + 1) * self.n_cone,
                  nv + k * fd: nv + (k + 1) * fd] = c["cone"]
        A_rows.append(Acone)
        cone_act = torch.repeat_interleave(contacts, self.n_cone, dim=-1) > 0.5
        lo.append(torch.full((nb, nk * self.n_cone), -_INF, dtype=dtype, device=device))
        hi.append(where(cone_act, 0.0, _INF))
        Afz = zeros(nk)
        for k in range(nk):
            Afz[:, k, nv + k * fd + 2] = 1.0
        A_rows.append(Afz)
        lo.append(where(contacts > 0.5, self.min_f, -_INF))
        hi.append(where(contacts > 0.5, self.max_f, _INF))

        # joint pos/vel viability bounds -> ddq box (TaskJointPosVelAccBounds)
        dt = self.dt
        qj, vj = q[:, 7:], v[:, 6:]
        dd_hi = torch.minimum((c["vmax"] - vj) / dt, 2.0 * (c["qhi"] - qj - vj * dt) / dt**2)
        dd_lo = torch.maximum((-c["vmax"] - vj) / dt, 2.0 * (c["qlo"] - qj - vj * dt) / dt**2)
        A_rows.append(ident(nu, 6))
        lo.append(torch.minimum(dd_lo, dd_hi))
        hi.append(torch.maximum(dd_lo, dd_hi))

        # actuation bounds: tau = (M ddq + h - Jc' f) actuated rows
        A_rows.append(torch.cat([M[:, 6:], -JcT[:, 6:]], dim=2))
        lo.append(-c["taumax"] - h[:, 6:])
        hi.append(c["taumax"] - h[:, 6:])

        A = torch.cat(A_rows, dim=1)
        return H, g, A, torch.cat(lo, dim=1), torch.cat(hi, dim=1), M, h, JcT

    def _extra_tasks(self, q, v, targets, dtype):
        """Hook for CentroidalID's CoM + swing-tracking tasks."""
        return []

    def _solve_core(self, q, v, targets, warm):
        from .. import kernels

        H, g, A, l, u, M, h, JcT = kernels.id_assemble(self, q, v, targets)
        sol = kernels.qp_admm(H, g, A, l, u, iters=self.settings.qp_iters,
                              z0=None if warm is None else warm[0],
                              y0=None if warm is None else warm[1])
        nv = self.nv
        ddq, f = sol.z[:, :nv], sol.z[:, nv:]
        tau = (torch.baddbmm(h[..., None], M, ddq[..., None])
               - JcT @ f[..., None])[:, 6:, 0]
        return tau, ddq, f.reshape(-1, self.nk, self.fdim), sol

    # ------------------------------------------------------------------
    def solve(self, t, q_meas, v_meas):
        """QP solve at the measured state (nq,), (nv,) -> actuated torques
        (kinodynamics-id.cpp:188-232); the ID's assembly and QP run as a
        batch of one robot."""
        q, v = self._tensor(q_meas)[None], self._tensor(v_meas)[None]
        targets = {k: a[None] for k, a in self._targets.items()}
        tau, ddq, f, sol = self._solve_core(q, v, targets, self._qp_warm)
        self._last = (tau[0], ddq[0], f[0])
        self._qp_warm = (sol.z, sol.y)
        return self._last[0]

    def get_accelerations(self):
        """(kinodynamics-id.cpp:234-237)"""
        return self._last[1]

    def get_forces(self):
        return self._last[2]
