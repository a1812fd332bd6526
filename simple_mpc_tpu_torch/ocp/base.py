"""OCP formulation base: stage-parameter NamedTuples + problem assembly.

Port of `simple_mpc_tpu.ocp.base` (reference: src/ocp-handler.cpp
createProblem/createStages and the reference get/setters).  A problem is
x0 + stage parameters stacked over the horizon (NamedTuples of tensors with
a leading T axis) + terminal parameters; heterogeneous stage structure is
masking over a static maximal structure.  Setters replace tensors rather
than mutating them, so a problem handed to the solver is never changed
behind its back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.handler import RobotModelHandler, _host, _placements


def tree_map(fn, tree, *rest):
    """Map over the tensor leaves of a NamedTuple (or a bare tensor)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(
            tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for leaf in tree for x in tree_leaves(leaf)]
    return [tree]


def _cast(dtype):
    def cast(a):
        return a.to(dtype) if a.is_floating_point() else a
    return cast


@dataclasses.dataclass(frozen=True)
class Problem:
    """Trajectory-optimization problem as data (aligator TrajOptProblem
    equivalent, ocp-handler.cpp:130): x0 + stacked stage params + terminal
    params.  A scenario batch (`parallel.tile_problem`) adds a leading B axis
    to every leaf."""

    x0: torch.Tensor
    stage_params: Any  # NamedTuple, leaves have leading dim T
    term_params: Any  # NamedTuple (single stage)

    @property
    def horizon(self) -> int:
        return int(tree_leaves(self.stage_params)[0].shape[0])

    def _map(self, fn) -> "Problem":
        return Problem(x0=fn(self.x0), stage_params=tree_map(fn, self.stage_params),
                       term_params=tree_map(fn, self.term_params))

    def astype(self, dtype) -> "Problem":
        """Cast every floating leaf (the card's path runs f32 on a problem
        built in f64)."""
        return self._map(_cast(dtype))

    def to(self, device) -> "Problem":
        return self._map(lambda a: a.to(device))


def stack_params(params_list: Sequence[Any]):
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def index_params(stacked: Any, t):
    return tree_map(lambda x: x[t], stacked)


def update_params(stacked: Any, t, new: Any):
    def upd(s, n):
        s = s.clone()
        s[t] = n
        return s
    return tree_map(upd, stacked, new)


def roll_params(stacked: Any, new_last: Any):
    """Drop stage 0, append new_last — the receding-horizon shift
    (problem.replaceStageCircular + cycleProblem, mpc.cpp:225-226)."""
    return tree_map(lambda s, n: torch.cat([s[1:], n[None]], dim=0),
                    stacked, new_last)


class OCPHandler:
    """Abstract base (reference ocp-handler.hpp:42-164).

    `device` and `dtype` say where the problem's tensors live; the stage
    kernels follow the device and dtype of their inputs.
    """

    def __init__(self, settings, model_handler: RobotModelHandler,
                 device="cuda", dtype=torch.float64):
        self.settings = settings
        self.model_handler = model_handler
        self.device = torch.device(device)
        self.dtype = dtype
        self.problem: Optional[Problem] = None

    nu: int
    n_eq: int = 0
    n_in: int = 0
    n_term_eq: int = 0

    def _tensor(self, a) -> torch.Tensor:
        """Host data as a tensor in the problem's dtype on its device."""
        if torch.is_tensor(a):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.array(a, np.float64), dtype=self.dtype,
                               device=self.device)

    # -- problem construction (ocp-handler.cpp:96-137) ----------------------
    def create_problem(self, x0, horizon: int, force_size: int, gravity: float,
                       terminal_constraint: bool = False) -> Problem:
        """All-feet-in-contact standing horizon; per-foot vertical force
        m*g/n_feet."""
        mh = self.model_handler
        nk = mh.n_feet
        fref = np.zeros(force_size)
        fref[2] = -mh.mass * gravity / nk
        # foot poses from the reference state FK
        q_ref = _host(mh.reference_state[: mh.model.nq])
        _, _, fR, fp = _placements(mh.model, q_ref)
        poses_R = fR[mh.feet_frame_ids].numpy()
        poses_p = fp[mh.feet_frame_ids].numpy()

        contact_states = [dict((n, True) for n in mh.feet_names)] * horizon
        contact_poses = [(poses_R, poses_p)] * horizon
        contact_forces = [np.tile(fref, (nk, 1))] * horizon
        stages = self.create_stages(contact_states, contact_poses, contact_forces)
        term = self.make_term_params(x0, terminal_constraint)
        self.problem = Problem(x0=self._tensor(x0), stage_params=stages,
                               term_params=term)
        self.terminal_constraint = terminal_constraint
        return self.problem

    def create_stages(self, contact_phases: List[Dict[str, bool]],
                      contact_poses, contact_forces):
        """Walk a contact-phase sequence; flag land_constraint on the
        contact-making stage (ocp-handler.cpp:21-56)."""
        mh = self.model_handler
        params = []
        for t, phase in enumerate(contact_phases):
            land = {}
            for name in mh.feet_names:
                land[name] = bool(t >= 1 and phase[name]
                                  and not contact_phases[t - 1][name])
            active = np.array([float(phase[n]) for n in mh.feet_names])
            land_v = np.array([float(land[n]) for n in mh.feet_names])
            pR, pp = contact_poses[t]
            params.append(
                self.make_stage_params(active, np.asarray(pR), np.asarray(pp),
                                       np.asarray(contact_forces[t]), land_v)
            )
        return stack_params(params)

    # -- common reference plumbing (ocp-handler.cpp:58-94) -------------------
    def set_reference_control(self, t: int, u_ref):
        sp = self.problem.stage_params
        u = sp.u_ref.clone()
        u[t] = self._tensor(u_ref)
        self.problem = dataclasses.replace(self.problem,
                                           stage_params=sp._replace(u_ref=u))

    def get_reference_control(self, t: int):
        return self.problem.stage_params.u_ref[t]

    def get_contact_state(self, t: int):
        return [bool(b) for b in
                (self.problem.stage_params.contact_active[t] > 0.5).tolist()]

    def get_contact_support(self, t: int) -> int:
        return int(round(float(self.problem.stage_params.contact_active[t].sum())))

    def set_init_state(self, x0):
        self.problem = dataclasses.replace(self.problem, x0=self._tensor(x0))

    # -- pure hooks of the fused MPC tick -------------------------------------
    def x0_from_measurement(self, x):
        """Problem initial state from a measured full robot state (q, v):
        the identity for multibody-state formulations."""
        return x

    def write_references(self, stage_params, term_params, foot_refs,
                         x_reference, velocity_base, com_ref):
        """Pure counterpart of the per-tick reference writes of
        MPC.update_step_tracker_references; returns new param tuples."""
        raise NotImplementedError
