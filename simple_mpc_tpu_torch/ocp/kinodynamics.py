"""Kinodynamics OCP — whole-body kinematics + centroidal dynamics.

Port of `simple_mpc_tpu.ocp.kinodynamics` (reference src/kinodynamics.cpp,
KinodynamicsOCP), SoA path only.  State (q, v) on the multibody phase
space; control u = [forces (nk*fs); ddq_joints (nv-6)].  The base
acceleration follows from centroidal wrench consistency
(KinodynamicsFwdDynamics, kinodynamics.cpp:85-89) via semi-implicit Euler.
Constraints: joint-limit box, per-contact zero frame velocity, optional
cones and land heights.  Terminal: state + 10x centroidal momentum cost,
optional DCM-position equality.

`stage_eval_soa` is kernel K1 of the solver's path (plain PyTorch in this
port; the single-state helpers evaluate it with one lane, N=1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import soa
from ..ops import world as _world
from . import cones
from .base import MultibodyOCPHandler
from .spaces import MultibodyPhaseSpace


def _dvec(w):
    w = np.asarray(w, dtype=np.float64)
    return np.diag(w) if w.ndim == 2 else w


@dataclasses.dataclass
class KinodynamicsSettings:
    """Field parity with KinodynamicsSettings (kinodynamics.hpp:24-51)."""

    timestep: float = 0.01
    w_x: np.ndarray = None
    w_u: np.ndarray = None
    w_cent: np.ndarray = None
    w_centder: np.ndarray = None
    w_frame: np.ndarray = None
    gravity: np.ndarray = None
    force_size: int = 3
    qmin: np.ndarray = None
    qmax: np.ndarray = None
    mu: float = 0.8
    Lfoot: float = 0.1
    Wfoot: float = 0.075
    kinematics_limits: bool = True
    force_cone: bool = False
    land_cstr: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "KinodynamicsSettings":
        from ..utils.config import settings_from_dict

        return settings_from_dict(cls, d)


class KinoStageParams(NamedTuple):
    contact_active: torch.Tensor  # (nk,)
    foot_ref_R: torch.Tensor  # (nk,3,3) pose-cost references
    foot_ref_p: torch.Tensor  # (nk,3)
    x_ref: torch.Tensor  # (nx,) state-cost target (holds base pose/vel refs)
    u_ref: torch.Tensor  # (nu,) control-cost target (holds force refs)
    land: torch.Tensor  # (nk,) land-constraint flags


class KinoTermParams(NamedTuple):
    x_ref: torch.Tensor
    dcm_ref: torch.Tensor  # (3,) terminal DCM target


class KinodynamicsOCP(MultibodyOCPHandler):
    stage_params_type = KinoStageParams
    term_params_type = KinoTermParams

    def __init__(self, settings, model_handler, device="cuda",
                 dtype=torch.float64):
        if isinstance(settings, dict):
            settings = KinodynamicsSettings.from_dict(settings)
        super().__init__(settings, model_handler, device, dtype)
        self.model = model_handler.model
        self.space = MultibodyPhaseSpace(self.model)
        self.nk = model_handler.n_feet
        self.fs = settings.force_size
        nv = self.model.nv
        self.nv = nv
        self.nq = self.model.nq
        self.nu = self.nk * self.fs + (nv - 6)
        self.mass = model_handler.mass
        self.feet_fids = list(model_handler.feet_frame_ids)
        # constraint sizes (static maximal structure, masked by activity)
        self.vel_dim = 3 if self.fs == 3 else 6
        n_land = self.nk if (settings.land_cstr and self.fs == 3) else 0
        self.n_eq = self.nk * self.vel_dim + n_land
        n_box = 2 * (nv - 6) if settings.kinematics_limits else 0
        n_cone = self.nk * (5 if self.fs == 3 else 17) if settings.force_cone else 0
        self.n_in = n_box + n_cone
        self.n_term_eq = 0  # set by make_term_params when DCM equality enabled
        self._use_term_eq = False
        self._consts = {}

    @property
    def u_scale(self):
        """Per-coordinate control magnitudes for solver nondimensionalization
        (SolverSettings.u_scale="auto"): contact forces ~ m*g, contact
        torques (fs=6) ~ m*g*footprint, joint accelerations ~ 1."""
        s = self.settings
        g = abs(float(np.asarray(s.gravity)[2])) if s.gravity is not None else 9.81
        mg = float(self.mass) * g
        blk = np.full(self.fs, mg)
        if self.fs == 6:
            blk[3:] = mg * max(float(s.Lfoot), float(s.Wfoot))
        w = np.ones(self.nu)
        w[: self.nk * self.fs] = np.tile(blk, self.nk)
        return w

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
                    [_dvec(s.w_x), _dvec(s.w_u), _dvec(s.w_cent),
                     _dvec(s.w_centder)] + [_dvec(s.w_frame)] * self.nk)),
                w_term=t(np.concatenate([_dvec(s.w_x), 10.0 * _dvec(s.w_cent)])),
                feet_par=_world.index_tensor(
                    _world.tables(self.model).fparent[np.asarray(self.feet_fids)],
                    like.device),
            )
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
        return KinoStageParams(
            contact_active=self._tensor(active),
            foot_ref_R=self._tensor(poses_R),
            foot_ref_p=self._tensor(poses_p),
            x_ref=self._tensor(self.model_handler.reference_state),
            u_ref=self._tensor(np.concatenate(
                [np.asarray(forces, np.float64).reshape(-1), np.zeros(self.nv - 6)])),
            land=self._tensor(land),
        )

    def make_term_params(self, x0, terminal_constraint):
        self._use_term_eq = bool(terminal_constraint)
        self.n_term_eq = 3 if terminal_constraint else 0
        return KinoTermParams(
            x_ref=self._tensor(self.model_handler.reference_state),
            dcm_ref=self._com0(x0))

    # -- the stage kernel (K1) ----------------------------------------------
    def _acc_soa(self, q, v, U, P):
        """Generalized acceleration (nv, N) from centroidal wrench
        consistency, plus the kinematic quantities the costs reuse."""
        m = self.model
        N = q.shape[-1]
        c = self._const(q)
        f = (U[: self.nk * self.fs].reshape(self.nk, self.fs, N)
             * P.contact_active[:, None, :])
        ddq_j = U[self.nk * self.fs:]

        oR, op = soa.fk_world(m, q)
        Sw = soa.world_axes(m, oR, op)
        com = soa.com_world(m, oR, op)
        vW = soa.body_velocities(m, Sw, v)
        fRw, fpw = soa.frame_placements_world(m, oR, op, self.feet_fids)
        hg = soa.agx(m, oR, op, Sw, v, com)
        bias = soa.bias_hdot(m, oR, op, Sw, vW, v, com)

        # external centroidal wrench from the commanded forces
        Wlin = self.mass * c["g"][:, None] + torch.sum(f[:, :3], dim=0)
        Wang = torch.sum(soa.cross(fpw - com[None], f[:, :3]), dim=0)
        if self.fs == 6:
            Wang = Wang + torch.sum(f[:, 3:], dim=0)
        Wr = torch.cat([Wlin, Wang], dim=-2)

        # dynamics (KinodynamicsFwdDynamics)
        acc_j = torch.cat([torch.zeros((6, N), dtype=q.dtype, device=q.device),
                           ddq_j], dim=0)
        rhs = Wr - bias - soa.agx(m, oR, op, Sw, acc_j, com)
        a_base = soa.centroidal_solve6(m, oR, op, com, rhs)
        a = torch.cat([a_base, ddq_j], dim=0)
        return a, dict(vW=vW, fRw=fRw, fpw=fpw, hg=hg, Wr=Wr)

    def stage_eval_soa(self, X, U, P: KinoStageParams):
        """Trailing-batch stage evaluation: X (nx, N), U (nu, N), P leaves
        with their stage axis moved to the back.  Returns (r (nr,N), w (nr,),
        geq (n_eq,N), h (n_in,N), xnext (nx,N))."""
        s = self.settings
        m = self.model
        N = X.shape[-1]
        c = self._const(X)
        q, v = X[: self.nq], X[self.nq:]
        a, k = self._acc_soa(q, v, U, P)
        fRw, fpw = k["fRw"], k["fpw"]

        # semi-implicit Euler (kinodynamics.cpp:85-89)
        dt = s.timestep
        v_next = v + dt * a
        xnext = torch.cat([soa.integrate(m, q, dt * v_next), v_next], dim=0)

        # costs
        r_state = soa.state_difference(m, P.x_ref, X)
        r_u = U - P.u_ref
        if self.fs == 6:
            refR = P.foot_ref_R  # (nk,3,3,N)
            dR = soa.mtm(refR, fRw)
            dp = soa.mtv(refR, fpw - P.foot_ref_p)
            foot_r = soa.log6(dR, dp).reshape(-1, N)
        else:
            foot_r = (fpw - P.foot_ref_p).reshape(-1, N)
        r = torch.cat([r_state, r_u, k["hg"], k["Wr"], foot_r], dim=0)
        w = c["w"]

        # equality constraints: stance-foot zero velocity (+ land heights)
        _, v_loc = soa.frame_velocities_world(m, k["vW"], fRw, fpw, c["feet_par"])
        vf = v_loc[:, :3] if self.vel_dim == 3 else v_loc
        geq = (vf * (P.contact_active > 0.5)[:, None, :]).reshape(-1, N)
        if s.land_cstr and self.fs == 3:
            land_r = fpw[:, 2] - P.foot_ref_p[:, 2]
            land_on = (P.land > 0.5) & (P.contact_active > 0.5)
            geq = torch.cat([geq, torch.where(land_on, land_r, 0.0)], dim=0)

        # inequalities: joint box (+ force cones), linear in (x, u)
        rows = []
        if s.kinematics_limits:
            qj = X[7: self.nq]
            b = torch.cat([qj - c["qmax"], c["qmin"] - qj], dim=0)
            rows.append(torch.where(torch.isfinite(b), b, -1.0))
        if s.force_cone:
            fk_all = U[: self.nk * self.fs].reshape(self.nk, self.fs, N)
            cr = torch.einsum("cf,kfn->kcn", c["cone"], fk_all)
            if self.fs == 3:
                cr = torch.cat([cr[:, :1] + cones.FRICTION_EPS, cr[:, 1:]], dim=1)
            cr = torch.where(P.contact_active[:, None, :] > 0.5, cr, -1.0)
            rows.append(cr.reshape(-1, N))
        h = (torch.cat(rows, dim=0) if rows
             else torch.zeros((0, N), dtype=X.dtype, device=X.device))
        return r, w, geq, h, xnext

    def state_derivative(self, x, u, p):
        """Continuous xdot [v; a] (MPC::getStateDerivative, mpc.cpp:346-352)
        as one lane of `kernels.state_derivative` (K11: csrc/acc.cu, or
        csrc/acc_wide.cu for 6D feet, on the card; `_acc_soa` on the CPU)."""
        from .. import kernels

        return kernels.state_derivative(self, x[None], u[None],
                                        type(p)._make(a[None] for a in p))[0]

    # -- reference get/setters (kinodynamics.cpp:155-338) --------------------
    def get_reference_force(self, t: int, ee_name: str):
        k = self.model_handler.foot_nb(ee_name)
        return self.problem.stage_params.u_ref[t, k * self.fs: (k + 1) * self.fs]
