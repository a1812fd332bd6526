"""Full-dynamics OCP — constrained articulated dynamics with rigid contact.

Port of `simple_mpc_tpu.ocp.fulldynamics` (reference src/fulldynamics.cpp,
FullDynamicsOCP), SoA path only.  State (q, v); control = joint torques
(nu = nv-6), actuation [0; I].  Dynamics = constrained forward dynamics over
the active contact set with Baumgarte correction and proximal
regularization, 3D LOCAL point or 6D LOCAL_WORLD_ALIGNED contacts,
semi-implicit Euler.  Costs: state / control / centroidal / foot pose /
contact force.  Constraints: torque box, joint-limit box, per-contact cones
on the implicit contact forces, landing velocity + height equalities.
Terminal: state + 10x centroidal cost, optional DCM equality.

`stage_eval_soa` runs the constrained dynamics (kernel K7, ops/soa_dyn.py)
once per lane and shares it between the force cost, the cones and the
integrator.  It is the plain twin of the full-dynamics stage kernels
(`kernels.fd_stage_linearize`, `fd_stage_eval`, `fd_dynamics`); the
single-state helpers `get_contact_forces` and `state_derivative` go through
`kernels.fd_dynamics`, so on the card they launch its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import soa, soa_dyn
from ..ops import world as _world
from . import cones
from .base import MultibodyOCPHandler, tree_map
from .spaces import MultibodyPhaseSpace


def _dvec(w):
    w = np.asarray(w, dtype=np.float64)
    return np.diag(w) if w.ndim == 2 else w


@dataclasses.dataclass
class FullDynamicsSettings:
    """Field parity with FullDynamicsSettings (fulldynamics.hpp:28-65)."""

    timestep: float = 0.01
    w_x: np.ndarray = None
    w_u: np.ndarray = None
    w_cent: np.ndarray = None
    w_forces: np.ndarray = None
    w_frame: np.ndarray = None
    gravity: np.ndarray = None
    force_size: int = 3
    Kp_correction: np.ndarray = None
    Kd_correction: np.ndarray = None
    umin: np.ndarray = None
    umax: np.ndarray = None
    qmin: np.ndarray = None
    qmax: np.ndarray = None
    mu: float = 0.8
    Lfoot: float = 0.1
    Wfoot: float = 0.075
    torque_limits: bool = True
    kinematics_limits: bool = True
    force_cone: bool = True
    land_cstr: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "FullDynamicsSettings":
        from ..utils.config import settings_from_dict

        return settings_from_dict(cls, d)


class FullStageParams(NamedTuple):
    contact_active: torch.Tensor  # (nk,)
    foot_ref_R: torch.Tensor  # (nk,3,3)
    foot_ref_p: torch.Tensor  # (nk,3)
    x_ref: torch.Tensor  # (nx,)
    u_ref: torch.Tensor  # (nu,) control-cost target (zeros in reference)
    f_ref: torch.Tensor  # (nk, force_size) contact-force cost references
    land: torch.Tensor  # (nk,)


class FullTermParams(NamedTuple):
    x_ref: torch.Tensor
    dcm_ref: torch.Tensor


class FullDynamicsOCP(MultibodyOCPHandler):
    stage_params_type = FullStageParams
    term_params_type = FullTermParams
    full_dynamics = True

    def __init__(self, settings, model_handler, device="cuda",
                 dtype=torch.float64):
        if isinstance(settings, dict):
            settings = FullDynamicsSettings.from_dict(settings)
        super().__init__(settings, model_handler, device, dtype)
        self.model = model_handler.model
        self.space = MultibodyPhaseSpace(self.model)
        self.nk = model_handler.n_feet
        self.fs = settings.force_size
        nv = self.model.nv
        self.nv, self.nq = nv, self.model.nq
        self.nu = nv - 6
        self.mass = model_handler.mass
        self.feet_fids = list(model_handler.feet_frame_ids)
        # Vector Baumgarte corrector gains, one entry per contact dimension,
        # installed identically on every contact (fulldynamics.cpp:58-74;
        # the reference rejects sizes != force_size, :41-48)
        self.vel_dim = 3 if settings.force_size == 3 else 6

        def _gain(g):
            if g is None:
                return 0.0
            arr = np.asarray(g, dtype=np.float64).reshape(-1)
            if arr.size == 1:
                return float(arr[0])
            if arr.size != self.vel_dim:
                raise ValueError(
                    "Force must be of same size as Kp correction"
                    f" (got {arr.size}, force_size={settings.force_size})")
            return arr

        self.kp = _gain(settings.Kp_correction)
        self.kd = _gain(settings.Kd_correction)
        self.prox_mu = 1e-9
        n_land_vel = self.nk * (3 if self.fs == 3 else 6) if settings.land_cstr else 0
        n_land_h = self.nk if (settings.land_cstr and self.fs == 3) else 0
        self.n_eq = n_land_vel + n_land_h
        n_box = (2 * self.nu if settings.torque_limits else 0) + (
            2 * (nv - 6) if settings.kinematics_limits else 0)
        n_cone = self.nk * (5 if self.fs == 3 else 17) if settings.force_cone else 0
        self.n_in = n_box + n_cone
        self.n_term_eq = 3
        self._use_term_eq = False
        self._consts = {}

    @property
    def u_scale(self):
        """Per-joint torque magnitudes for solver nondimensionalization
        (SolverSettings.u_scale="auto"): each torque scaled by its own
        actuator effort limit."""
        lim = np.asarray(self.model.effort_limit[6:], np.float64)
        return np.where(np.isfinite(lim) & (lim > 0), lim, 1.0)

    def _const(self, like) -> dict:
        """Settings-derived constant tensors on `like`'s device and dtype."""
        key = (like.dtype, like.device)
        c = self._consts.get(key)
        if c is None:
            s = self.settings

            def t(a):
                return torch.as_tensor(np.array(a, np.float64), dtype=like.dtype,
                                       device=like.device)

            c = dict(
                g=t(s.gravity),
                w=t(np.concatenate(
                    [_dvec(s.w_x), _dvec(s.w_u), _dvec(s.w_cent)]
                    + [_dvec(s.w_frame)] * self.nk + [_dvec(s.w_forces)] * self.nk)),
                w_term=t(np.concatenate([_dvec(s.w_x), 10.0 * _dvec(s.w_cent)])),
                feet_par=_world.index_tensor(
                    _world.tables(self.model).fparent[np.asarray(self.feet_fids)],
                    like.device),
                kp_rows=soa_dyn._baumgarte_rows(self.kp, self.vel_dim, self.nk, like),
                kd_rows=soa_dyn._baumgarte_rows(self.kd, self.vel_dim, self.nk, like),
            )
            if s.torque_limits:
                c["umin"] = t(s.umin)[:, None]
                c["umax"] = t(s.umax)[:, None]
            if s.kinematics_limits:
                c["qmin"] = t(s.qmin)[:, None]
                c["qmax"] = t(s.qmax)[:, None]
            if s.force_cone:
                c["cone"] = t(cones.friction_cone_mat(s.mu) if self.fs == 3
                              else cones.wrench_cone_mat(s.mu, s.Lfoot, s.Wfoot))
            self._consts[key] = c
        return c

    # -- params --------------------------------------------------------------
    def make_stage_params(self, active, poses_R, poses_p, forces, land):
        return FullStageParams(
            contact_active=self._tensor(active),
            foot_ref_R=self._tensor(poses_R),
            foot_ref_p=self._tensor(poses_p),
            x_ref=self._tensor(self.model_handler.reference_state),
            u_ref=self._tensor(np.zeros(self.nu)),
            f_ref=self._tensor(np.asarray(forces, np.float64).reshape(self.nk, self.fs)),
            land=self._tensor(land),
        )

    def make_term_params(self, x0, terminal_constraint):
        self._use_term_eq = bool(terminal_constraint)
        self.n_term_eq = 3 if terminal_constraint else 0
        return FullTermParams(
            x_ref=self._tensor(self.model_handler.reference_state),
            dcm_ref=self._com0(x0))

    # -- the stage (K7 + K1) ---------------------------------------------------
    def _constrained_acc_soa(self, X, U, P, precomp=None):
        """(ddq (nv, N), forces (nk, fs, N)): the constrained dynamics over
        the masked contact set, with the per-stage foot pose references as
        the Baumgarte anchors."""
        N = X.shape[-1]
        tau = torch.cat([torch.zeros((6, N), dtype=X.dtype, device=X.device), U], dim=0)
        return soa_dyn.constrained_fwd_dynamics_soa(
            self.model, X[: self.nq], X[self.nq:], tau, self.feet_fids,
            P.contact_active, dim=self.vel_dim, ref_R=P.foot_ref_R,
            ref_p=P.foot_ref_p, kp=self.kp, kd=self.kd, prox_mu=self.prox_mu,
            precomp=precomp)

    def stage_eval_soa(self, X, U, P: FullStageParams):
        """Trailing-batch stage evaluation: X (nx, N), U (nu, N), P leaves
        with their stage axis moved to the back (f_ref (nk, fs, N)).
        Returns (r (78,N) for Go2, w (nr,), geq (n_eq,N), h (n_in,N),
        xnext (nx,N)); reference semantics fulldynamics.cpp:88-211."""
        s = self.settings
        m = self.model
        N = X.shape[-1]
        c = self._const(X)
        q, v = X[: self.nq], X[self.nq:]

        oR, op = soa.fk_world(m, q)
        Sw = soa.world_axes(m, oR, op)
        vW = soa.body_velocities(m, Sw, v)
        IW = soa_dyn.body_inertias_world(m, oR, op)
        com = soa.com_world(m, oR, op)
        fRw, fpw = soa.frame_placements_world(m, oR, op, self.feet_fids)
        hg = soa.agx(m, oR, op, Sw, v, com)
        a, forces = self._constrained_acc_soa(X, U, P, precomp=(oR, op, Sw, vW, IW))

        dt = s.timestep
        v_next = v + dt * a
        xnext = torch.cat([soa.integrate(m, q, dt * v_next), v_next], dim=0)

        # costs (fulldynamics.cpp:88-137 inventory)
        r_state = soa.state_difference(m, P.x_ref, X)
        r_u = U - P.u_ref
        if self.fs == 6:
            dR = soa.mtm(P.foot_ref_R, fRw)
            dp = soa.mtv(P.foot_ref_R, fpw - P.foot_ref_p)
            foot_r = soa.log6(dR, dp).reshape(-1, N)
        else:
            foot_r = (fpw - P.foot_ref_p).reshape(-1, N)
        rf = ((forces - P.f_ref) * P.contact_active[:, None, :]).reshape(-1, N)
        r = torch.cat([r_state, r_u, hg, foot_r, rf], dim=0)

        # equality constraints: landing velocity (world-aligned) + height
        if s.land_cstr:
            v_wa, _ = soa.frame_velocities_world(m, vW, fRw, fpw, c["feet_par"])
            vf = v_wa[:, :3] if self.fs == 3 else v_wa
            on = ((P.land > 0.5) & (P.contact_active > 0.5))[:, None, :]
            geq = torch.where(on, vf, 0.0).reshape(-1, N)
            if self.fs == 3:
                land_r = fpw[:, 2] - P.foot_ref_p[:, 2]
                geq = torch.cat([geq, torch.where(on[:, 0], land_r, 0.0)], dim=0)
        else:
            geq = torch.zeros((0, N), dtype=X.dtype, device=X.device)

        # inequalities: torque box, joint box, cones on the implicit forces
        rows = []
        if s.torque_limits:
            b = torch.cat([U - c["umax"], c["umin"] - U], dim=0)
            rows.append(torch.where(torch.isfinite(b), b, -1.0))
        if s.kinematics_limits:
            qj = X[7: self.nq]
            b = torch.cat([qj - c["qmax"], c["qmin"] - qj], dim=0)
            rows.append(torch.where(torch.isfinite(b), b, -1.0))
        if s.force_cone:
            cr = torch.einsum("cf,kfn->kcn", c["cone"], forces)
            if self.fs == 3:
                cr = torch.cat([cr[:, :1] + cones.FRICTION_EPS, cr[:, 1:]], dim=1)
            cr = torch.where(P.contact_active[:, None, :] > 0.5, cr, -1.0)
            rows.append(cr.reshape(-1, N))
        h = (torch.cat(rows, dim=0) if rows
             else torch.zeros((0, N), dtype=X.dtype, device=X.device))
        return r, c["w"], geq, h, xnext

    # -- single-state helpers (the SoA dynamics at N=1) ------------------------
    def _dynamics(self, x, u, p):
        from .. import kernels  # the kernels import the OCP package

        ddq, f = kernels.fd_dynamics(self, x[None], u[None],
                                     tree_map(lambda a: a[None], p))
        return ddq[0], f[0]

    def get_contact_forces(self, x, u, p):
        """Constraint forces (nk, fs) (MPC::getContactForces capability,
        mpc.cpp:354-380)."""
        return self._dynamics(x, u, p)[1]

    def state_derivative(self, x, u, p):
        """Continuous xdot [v; a] (MPC::getStateDerivative, mpc.cpp:346-352)."""
        return torch.cat([x[self.nq:], self._dynamics(x, u, p)[0]])

    # -- reference get/setters (mirror kinodynamics + force-cost refs) -------
    def set_reference_pose(self, t: int, ee_name: str, R, pos):
        k = self.model_handler.foot_nb(ee_name)
        sp = self.problem.stage_params
        fR, fp = sp.foot_ref_R.clone(), sp.foot_ref_p.clone()
        fR[t, k] = self._tensor(R)
        fp[t, k] = self._tensor(pos)
        self._set_stage(foot_ref_R=fR, foot_ref_p=fp)

    def set_reference_poses(self, t: int, pose_refs: dict):
        for name, (R, pos) in pose_refs.items():
            self.set_reference_pose(t, name, R, pos)

    def get_reference_pose(self, t: int, ee_name: str):
        k = self.model_handler.foot_nb(ee_name)
        sp = self.problem.stage_params
        return sp.foot_ref_R[t, k], sp.foot_ref_p[t, k]

    def set_reference_force(self, t: int, ee_name: str, force_ref):
        k = self.model_handler.foot_nb(ee_name)
        f_ref = self.problem.stage_params.f_ref.clone()
        f_ref[t, k] = self._tensor(force_ref)
        self._set_stage(f_ref=f_ref)

    def set_reference_forces(self, t: int, force_refs: dict):
        for name, f in force_refs.items():
            self.set_reference_force(t, name, f)

    def get_reference_force(self, t: int, ee_name: str):
        k = self.model_handler.foot_nb(ee_name)
        return self.problem.stage_params.f_ref[t, k]

    def get_velocity_base(self, t: int):
        return self.problem.stage_params.x_ref[t, self.nq: self.nq + 6]

    def set_pose_base(self, t: int, pose_base):
        x_ref = self.problem.stage_params.x_ref.clone()
        x_ref[t, :7] = self._tensor(pose_base)
        self._set_stage(x_ref=x_ref)

    def get_pose_base(self, t: int):
        return self.problem.stage_params.x_ref[t, :7]

    def set_terminal_reference_state(self, x_ref):
        tp = self.problem.term_params._replace(x_ref=self._tensor(x_ref))
        self.problem = dataclasses.replace(self.problem, term_params=tp)
