"""Centroidal OCP formulation: the 9-dim point-mass and angular-momentum model.

Port of `simple_mpc_tpu.ocp.centroidal` (reference src/centroidal-dynamics.cpp,
CentroidalOCP), SoA path.  State x = [com(3); h_lin(3); h_ang(3)] on a
vector space; control = the stacked per-foot forces (3D) or wrenches (6D).
Explicit-Euler integrated ODE (centroidal-dynamics.cpp:79-81), a friction
pyramid or wrench cone per active contact (:85-104), base pose and velocity
references stored in the momentum-cost references scaled by the mass
(:227-257).

`stage_eval_soa` is the plain twin of the stage of csrc/centroidal.cu
(`kernels.centroidal_stage_linearize` / `centroidal_stage_eval`); the
single-state helpers evaluate it with one lane.  Out-of-range stage indices
raise IndexError; the JAX package's `.at[]` updates silently drop them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import soa
from . import cones
from .base import OCPHandler, _lanes
from .spaces import VectorSpace


def _dvec(w):
    """Vector or (diagonal) matrix weights: the diagonal."""
    w = np.asarray(w, dtype=np.float64)
    return np.diag(w) if w.ndim == 2 else w


@dataclasses.dataclass
class CentroidalSettings:
    """Field parity with CentroidalSettings (centroidal-dynamics.hpp:33-52)."""

    timestep: float = 0.01
    w_com: np.ndarray = None  # (3,) or (3,3)
    w_u: np.ndarray = None
    w_linear_mom: np.ndarray = None
    w_angular_mom: np.ndarray = None
    w_linear_acc: np.ndarray = None
    w_angular_acc: np.ndarray = None
    gravity: np.ndarray = None  # (3,)
    mu: float = 0.8
    Lfoot: float = 0.1
    Wfoot: float = 0.075
    force_size: int = 3

    @classmethod
    def from_dict(cls, d: dict) -> "CentroidalSettings":
        from ..utils.config import settings_from_dict

        return settings_from_dict(cls, d)


class CentroidalStageParams(NamedTuple):
    contact_active: torch.Tensor  # (nk,)
    contact_pose: torch.Tensor  # (nk, 3) foot positions for the torque arms
    com_ref: torch.Tensor  # (3,)
    u_ref: torch.Tensor  # (nu,)
    linmom_ref: torch.Tensor  # (3,) = v_base_lin * mass
    angmom_ref: torch.Tensor  # (3,) = v_base_ang * mass
    land: torch.Tensor  # (nk,) unused by this formulation


class CentroidalTermParams(NamedTuple):
    linmom_ref: torch.Tensor
    angmom_ref: torch.Tensor
    com_ref: torch.Tensor  # terminal-constraint CoM target (disabled by default)


class CentroidalOCP(OCPHandler):
    stage_params_type = CentroidalStageParams
    term_params_type = CentroidalTermParams
    # the stage, its line search and its ODE run in csrc/centroidal.cu
    centroidal = True

    def __init__(self, settings, model_handler, device="cuda", dtype=torch.float64):
        if isinstance(settings, dict):
            settings = CentroidalSettings.from_dict(settings)
        super().__init__(settings, model_handler, device, dtype)
        self.space = VectorSpace(9)
        self.nk = model_handler.n_feet
        self.fs = settings.force_size
        self.nu = self.nk * self.fs
        self.mass = model_handler.mass
        self.n_eq = 0
        self.n_in = self.nk * (5 if self.fs == 3 else 17)
        self.n_term_eq = 0  # terminal CoM constraint disabled (ref :318-328)
        self._consts = {}

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
                w=t(np.concatenate([_dvec(s.w_com), _dvec(s.w_u), _dvec(s.w_linear_mom),
                                    _dvec(s.w_angular_mom), _dvec(s.w_linear_acc),
                                    _dvec(s.w_angular_acc)])),
                w_term=t(np.concatenate([_dvec(s.w_linear_mom), _dvec(s.w_angular_mom)])),
                cone=t(cones.friction_cone_mat(s.mu) if self.fs == 3
                       else cones.wrench_cone_mat(s.mu, s.Lfoot, s.Wfoot)),
            )
            self._consts[key] = c
        return c

    # -- params construction -------------------------------------------------
    def make_stage_params(self, active, poses_R, poses_p, forces, land):
        z = self._tensor(np.zeros(3))
        return CentroidalStageParams(
            contact_active=self._tensor(active),
            contact_pose=self._tensor(poses_p),
            com_ref=z,
            u_ref=self._tensor(np.asarray(forces, np.float64).reshape(-1)),
            linmom_ref=z,
            angmom_ref=z,
            land=self._tensor(land),
        )

    def make_term_params(self, x0, terminal_constraint):
        z = self._tensor(np.zeros(3))
        return CentroidalTermParams(linmom_ref=z, angmom_ref=z,
                                    com_ref=self._tensor(x0)[:3])

    # -- the stage (CentroidalFwdDynamics + IntegratorEuler, the costs and
    # the cones) on N lanes ---------------------------------------------------
    def _wrench(self, X, U, P):
        """The active forces' sum (3, N) and their torque about the CoM,
        with the active wrenches' own torques (3, N)."""
        N = X.shape[-1]
        f = U.reshape(self.nk, self.fs, N) * P.contact_active[:, None, :]
        fsum = torch.sum(f[:, :3], dim=0)
        arm = P.contact_pose - X[None, :3]
        tau = torch.sum(soa.cross(arm, f[:, :3]), dim=0)
        if self.fs == 6:
            tau = tau + torch.sum(f[:, 3:], dim=0)
        return fsum, tau

    def _ode_from(self, X, fsum, tau):
        """[h / m; sum f + m g; tau] (9, N)."""
        g = self._const(X)["g"][:, None]
        return torch.cat([X[3:6] / self.mass, fsum + self.mass * g, tau], dim=0)

    def _ode_soa(self, X, U, P):
        return self._ode_from(X, *self._wrench(X, U, P))

    def stage_eval_soa(self, X, U, P: CentroidalStageParams):
        """Trailing-batch stage evaluation: X (9, N), U (nu, N), P leaves
        with their stage axis moved to the back.  Returns (r (27,N) for
        Talos's wrenches, w (nr,), geq (0,N), h (n_in,N), xnext (9,N))."""
        N = X.shape[-1]
        c = self._const(X)
        g = c["g"][:, None]
        fsum, tau = self._wrench(X, U, P)
        r = torch.cat([X[:3] - P.com_ref, U - P.u_ref, X[3:6] - P.linmom_ref,
                       X[6:9] - P.angmom_ref, fsum / self.mass + g, tau], dim=0)
        xnext = X + self.settings.timestep * self._ode_from(X, fsum, tau)
        fk = U.reshape(self.nk, self.fs, N)
        cr = torch.einsum("cf,kfn->kcn", c["cone"], fk)
        if self.fs == 3:
            cr = torch.cat([cr[:, :1] + cones.FRICTION_EPS, cr[:, 1:]], dim=1)
        cr = torch.where(torch.isfinite(cr), cr, -1.0)
        cr = torch.where(P.contact_active[:, None, :] > 0.5, cr, -1.0)
        geq = torch.zeros((0, N), dtype=X.dtype, device=X.device)
        return r, c["w"], geq, cr.reshape(-1, N), xnext

    # -- single-state helpers (any leading batch shape) -----------------------
    def ode(self, x, u, p: CentroidalStageParams):
        """The continuous ODE [h/m; sum f + m g; tau]; x (..., 9), u (..., nu),
        p leaves with the same leading axes."""
        P = tree_lanes(p, x.shape[:-1])
        return self._ode_soa(_lanes(x), _lanes(u), P).T.reshape(x.shape)

    def dynamics(self, x, u, p):
        """Explicit Euler (centroidal-dynamics.cpp:79-81)."""
        return x + self.settings.timestep * self.ode(x, u, p)

    def term_residuals(self, x, p: CentroidalTermParams):
        r = torch.cat([x[..., 3:6] - p.linmom_ref, x[..., 6:9] - p.angmom_ref], dim=-1)
        return r, self._const(x)["w_term"]

    def term_eq_constraints(self, x, p):
        return torch.zeros(x.shape[:-1] + (0,), dtype=x.dtype, device=x.device)

    # -- reference get/setters (semantics of centroidal-dynamics.cpp) -------
    def _set_stage(self, **leaves):
        sp = self.problem.stage_params._replace(**leaves)
        self.problem = dataclasses.replace(self.problem, stage_params=sp)

    def _set_row(self, name, t, value):
        a = getattr(self.problem.stage_params, name).clone()
        a[t] = self._tensor(value)
        self._set_stage(**{name: a})

    def set_reference_pose(self, t: int, ee_name: str, R, pos):
        k = self.model_handler.foot_nb(ee_name)
        a = self.problem.stage_params.contact_pose.clone()
        a[t, k] = self._tensor(pos)
        self._set_stage(contact_pose=a)

    def get_reference_pose(self, t: int, ee_name: str):
        k = self.model_handler.foot_nb(ee_name)
        p = self.problem.stage_params.contact_pose
        return torch.eye(3, dtype=p.dtype, device=p.device), p[t, k]

    def compute_control_from_forces(self, force_refs: dict):
        """The stacked control reference from per-foot force references
        (CentroidalOCP::computeControlFromForces, centroidal-dynamics.cpp:
        108-119); returns the vector."""
        us = []
        for n in self.model_handler.feet_names:
            f = self._tensor(force_refs[n])
            if f.shape[0] != self.fs:
                raise RuntimeError(
                    "force size in settings does not match reference force size")
            us.append(f)
        return torch.cat(us)

    def set_reference_forces(self, t: int, force_refs: dict):
        self.set_reference_control(t, self.compute_control_from_forces(force_refs))

    def set_reference_force(self, t: int, ee_name: str, force_ref):
        k = self.model_handler.foot_nb(ee_name)
        u = self.problem.stage_params.u_ref[t].clone()
        u[k * self.fs: (k + 1) * self.fs] = self._tensor(force_ref)
        self.set_reference_control(t, u)

    def get_reference_force(self, t: int, ee_name: str):
        k = self.model_handler.foot_nb(ee_name)
        return self.problem.stage_params.u_ref[t, k * self.fs: (k + 1) * self.fs]

    def set_velocity_base(self, t: int, velocity_base):
        """Stored as momentum refs x mass (centroidal-dynamics.cpp:227-239)."""
        v = self._tensor(velocity_base)
        sp = self.problem.stage_params
        lin, ang = sp.linmom_ref.clone(), sp.angmom_ref.clone()
        lin[t] = v[:3] * self.mass
        ang[t] = v[3:] * self.mass
        self._set_stage(linmom_ref=lin, angmom_ref=ang)

    def get_velocity_base(self, t: int):
        sp = self.problem.stage_params
        return torch.cat([sp.linmom_ref[t] / self.mass, sp.angmom_ref[t] / self.mass])

    def set_pose_base(self, t: int, pose_base):
        self._set_row("com_ref", t, pose_base)

    def get_pose_base(self, t: int):
        return self.problem.stage_params.com_ref[t]

    def set_reference_state(self, t: int, x_ref):
        """[pose_base(3); velocity_base(6)] (centroidal-dynamics.cpp
        setReferenceState / getReferenceState)."""
        x_ref = self._tensor(x_ref)
        self.set_pose_base(t, x_ref[:3])
        self.set_velocity_base(t, x_ref[3:])

    def get_reference_state(self, t: int):
        return torch.cat([self.get_pose_base(t), self.get_velocity_base(t)])

    def set_all_foot_translations(self, refs):
        """Batched (T, nk, 3) write of every stage's foot positions (the
        fused equivalent of the setReferencePose loop, mpc.cpp:304-308)."""
        self._set_stage(contact_pose=self._tensor(refs))

    def state_derivative(self, x, u, p):
        """Continuous xdot (MPC::getStateDerivative, mpc.cpp:346-352) as one
        lane of `kernels.state_derivative` (csrc/centroidal.cu on the card,
        `ode` on the CPU)."""
        from .. import kernels

        return kernels.state_derivative(self, x[None], u[None],
                                        type(p)._make(a[None] for a in p))[0]

    def update_terminal_constraint(self, com_ref):
        tp = self.problem.term_params._replace(com_ref=self._tensor(com_ref))
        self.problem = dataclasses.replace(self.problem, term_params=tp)

    def get_problem_state(self, data_handler):
        return data_handler.get_centroidal_state()

    def x0_from_measurement(self, x):
        """[com; h_lin; h_ang] from measured full robot states x (..., nq+nv)
        (the counterpart of get_centroidal_state)."""
        m = self.model_handler.model
        X = _lanes(x)
        q, v = X[: m.nq], X[m.nq:]
        oR, op = soa.fk_world(m, q)
        Sw = soa.world_axes(m, oR, op)
        com = soa.com_world(m, oR, op)
        hg = soa.agx(m, oR, op, Sw, v, com)
        return torch.cat([com, hg], dim=0).T.reshape(x.shape[:-1] + (9,))

    def write_references(self, stage_params, term_params, foot_refs,
                         x_reference, velocity_base, com_ref):
        """Pure per-tick reference update: the net effect of
        set_all_foot_translations + set_reference_state(T-1, x_reference) +
        set_velocity_base(T-1, velocity_base) + update_terminal_constraint
        (the velocity_base write overwrites the momentum refs of
        x_reference[3:]); any leading batch axes."""
        def last(a, v):
            return torch.cat([a[..., :-1, :], v[..., None, :]], dim=-2)

        sp = stage_params._replace(
            contact_pose=foot_refs,
            com_ref=last(stage_params.com_ref, x_reference[..., :3]),
            linmom_ref=last(stage_params.linmom_ref, velocity_base[..., :3] * self.mass),
            angmom_ref=last(stage_params.angmom_ref, velocity_base[..., 3:] * self.mass))
        return sp, term_params._replace(com_ref=com_ref)


def tree_lanes(p, batch_shape):
    """Stage params with leading `batch_shape` -> leaves with their
    components first and the flattened batch in the lanes."""
    nb = len(batch_shape)

    def lanes(a):
        flat = a.reshape((-1,) + tuple(a.shape[nb:]))
        return flat.movedim(0, -1)

    return type(p)._make(lanes(a) for a in p)
