"""In-framework rigid-contact simulator: the plant of the closed loop.

Port of `simple_mpc_tpu.sim.simulator` (`SimSettings`, `Simulator`):
feet at or below the ground plane become active 3D point contacts solved by
the masked constrained dynamics of the full-dynamics path (LOCAL contact
frames, Baumgarte correction toward a vertical-only anchor), with one
active-set refinement for unilaterality (solve, drop the contacts that pull
on the ground, solve again) and a semi-implicit Euler step with the Lie
integrate.

`step` moves one robot; it runs as a batch of one through
`kernels.sim_step`, which takes a leading batch of robots: the plain twin
`step_plain` below on CPU tensors, the CUDA kernel (csrc/sim.cu, kernel
K10) on the card.  The twin
is built from the port's SoA functions with the robots in the lanes:
`soa.fk_world`, `soa.frame_placements_world`, twice
`soa_dyn.constrained_fwd_dynamics_soa` and `soa.integrate`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models.model import RobotModel
from ..ops import soa, soa_dyn
from ..solver.proxddp import full_precision_matmuls


@dataclasses.dataclass(frozen=True)
class SimSettings:
    dt: float = 1e-3
    ground_height: float = 0.0
    contact_margin: float = 1e-4  # activation band below the plane
    baumgarte_kp: float = 400.0  # [1/s^2] position correction
    baumgarte_kd: float = 40.0  # [1/s]


class SimStep(NamedTuple):
    q: torch.Tensor  # (B, nq)
    v: torch.Tensor  # (B, nv)
    f_w: torch.Tensor  # (B, nk, 3) world ground-reaction forces
    active: torch.Tensor  # (B, 2, nk) contact masks of the two solves


class Simulator:
    """Torque-in, state-out simulator (BulletRobot capability:
    execute(tau) + measureState)."""

    def __init__(self, model: RobotModel, feet_frame_ids: Sequence[int],
                 settings: SimSettings = SimSettings(), device="cuda"):
        full_precision_matmuls()
        self.model = model
        self.settings = settings
        self.feet_fids = list(feet_frame_ids)
        self.nk = len(self.feet_fids)
        self.device = torch.device(device)

    def _dynamics(self, Q, V, tau_full, active, anchors):
        """The masked constrained dynamics on (., B) lanes: (ddq, LOCAL
        contact forces (nk, 3, B))."""
        s = self.settings
        return soa_dyn.constrained_fwd_dynamics_soa(
            self.model, Q, V, tau_full, self.feet_fids, active, dim=3, ref_p=anchors,
            kp=s.baumgarte_kp, kd=s.baumgarte_kd)

    def step_plain(self, q, v, tau_joints) -> SimStep:
        """Plain twin of K10 on (B, ...) robots."""
        s, m = self.settings, self.model
        Q, V = q.T, v.T
        dtype = q.dtype
        oR, op = soa.fk_world(m, Q)
        feet_R, feet_p = soa.frame_placements_world(m, oR, op, np.asarray(self.feet_fids))
        active0 = ((s.ground_height - feet_p[:, 2]) > -s.contact_margin).to(dtype)
        # vertical-only anchor: keep xy, pin z to the plane
        anchors = torch.cat([feet_p[:, :2], torch.full_like(feet_p[:, 2:], s.ground_height)],
                            dim=1)
        tau_full = torch.cat([torch.zeros_like(V[:6]), tau_joints.T], dim=0)
        _, f_loc = self._dynamics(Q, V, tau_full, active0, anchors)
        # unilateral refinement: drop contacts pulling on the ground
        active1 = active0 * (soa.mv(feet_R, f_loc)[:, 2] > 0.0).to(dtype)
        ddq, f_loc = self._dynamics(Q, V, tau_full, active1, anchors)
        v_next = V + s.dt * ddq
        q_next = soa.integrate(m, Q, s.dt * v_next)
        return SimStep(q_next.T, v_next.T, soa.mv(feet_R, f_loc).permute(2, 0, 1),
                       torch.stack([active0, active1]).permute(2, 0, 1))

    def step(self, q, v, tau_joints):
        """One semi-implicit Euler step of one robot under actuated joint
        torques: q (nq,), v (nv,), tau_joints (nu,), taken onto the
        simulator's device.  Returns (q_next, v_next, f_w (nk, 3))."""
        from .. import kernels

        q, v, tau = (torch.as_tensor(x, device=self.device)[None] for x in (q, v, tau_joints))
        return tuple(x[0] for x in kernels.sim_step(self, q, v, tau)[:3])

    def contact_forces(self, q, v, tau_joints):
        """World ground-reaction forces at the current state."""
        return self.step(q, v, tau_joints)[2]

    def rollout(self, q0, v0, taus):
        """(N, nu) torque sequence -> the stacked (q, v, f) of N steps."""
        q, v = q0, v0
        out = []
        for tau in taus:
            q, v, f = self.step(q, v, tau)
            out.append((q, v, f))
        return tuple(torch.stack(x) for x in zip(*out))
