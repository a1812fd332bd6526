"""RobotModelHandler / RobotDataHandler — API parity layer.

Port of `simple_mpc_tpu.models.handler` (reference: src/robot-handler.cpp:
12-149, include/simple-mpc/robot-handler.hpp:28-271).  The model handler is
host-side (feet registry, reference state, "<foot>_ref" OP frames); the data
handler caches FK, every frame placement, the CoM and the centroidal
momentum of one state.  Both run on the host in float64: they compute the
same math as the solver's kernels (`ops/soa.py` with one lane, N=1), once
per MPC tick.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import soa
from .model import Frame, RobotModel

POINT = 0  # 3D contact force
QUAD = 1  # 6D wrench, 4 corner points

_HOST = dict(dtype=torch.float64, device="cpu")


def _host(x) -> torch.Tensor:
    """A state on the host in float64 (the handler's working precision)."""
    if torch.is_tensor(x):
        return x.detach().to(**_HOST)
    return torch.as_tensor(np.array(x, np.float64))


def _placements(model: RobotModel, q: torch.Tensor):
    """(oR, op, fR, fp) at one configuration q (nq,), lane axis dropped."""
    oR, op = soa.fk_world(model, q[:, None])
    fR, fp = soa.frame_placements_world(model, oR, op)
    return oR, op, fR[..., 0], fp[..., 0]


class RobotModelHandler:
    """Feet registry + reference state over a RobotModel
    (reference robot-handler.hpp:28-225; foot types POINT/QUAD :30-35)."""

    def __init__(self, model: RobotModel, reference_configuration_name: str,
                 base_frame_name: str):
        self.model = model
        self.base_frame_name = base_frame_name
        self.base_frame_id = model.frame_id(base_frame_name)
        q_ref = model.reference_configurations[reference_configuration_name]
        self.reference_state = np.concatenate([q_ref, np.zeros(model.nv)])
        self.mass = model.total_mass()
        self.feet_names: List[str] = []
        self.feet_frame_ids: List[int] = []
        self.feet_ref_frame_ids: List[int] = []
        self.feet_types: List[int] = []
        self.feet_contact_points: Dict[int, np.ndarray] = {}

    # -- feet registry (robot-handler.cpp:28-77) ----------------------------
    def _add_foot_frames(self, foot_name: str, reference_parent_frame_name: str):
        foot_frame_id = self.model.frame_id(foot_name)
        self.feet_names.append(foot_name)
        self.feet_frame_ids.append(foot_frame_id)
        parent_frame = self.model.frames[self.model.frame_id(reference_parent_frame_name)]
        # "<foot>_ref" OP frame on the reference parent's joint, placed at the
        # foot's pose under the reference configuration (robot-handler.cpp:39-54)
        q_ref = _host(self.reference_state[: self.model.nq])
        _, _, fR, fp = _placements(self.model, q_ref)
        fR, fp = fR.numpy(), fp.numpy()
        pf_id = self.model.frame_id(reference_parent_frame_name)
        R_rel = fR[pf_id].T @ fR[foot_frame_id]
        p_rel = fR[pf_id].T @ (fp[foot_frame_id] - fp[pf_id])
        ref_id = self.model.add_frame(
            Frame(foot_name + "_ref", parent_frame.parent_joint,
                  np.asarray(parent_frame.R) @ R_rel,
                  np.asarray(parent_frame.p) + np.asarray(parent_frame.R) @ p_rel)
        )
        self.feet_ref_frame_ids.append(ref_id)

    def add_point_foot(self, foot_name: str, reference_parent_frame_name: str) -> int:
        self._add_foot_frames(foot_name, reference_parent_frame_name)
        self.feet_types.append(POINT)
        return len(self.feet_types) - 1

    def add_quad_foot(self, foot_name: str, reference_parent_frame_name: str,
                      contact_points: np.ndarray) -> int:
        self._add_foot_frames(foot_name, reference_parent_frame_name)
        self.feet_types.append(QUAD)
        self.feet_contact_points[len(self.feet_types) - 1] = np.asarray(contact_points)
        return len(self.feet_types) - 1

    def set_foot_reference_placement(self, foot_nb: int, R: np.ndarray, p: np.ndarray):
        """Mutate the ref-frame placement (robot-handler.cpp:78-80)."""
        fid = self.feet_ref_frame_ids[foot_nb]
        f = self.model.frames[fid]
        self.model.frames[fid] = Frame(f.name, f.parent_joint, np.asarray(R), np.asarray(p))

    # -- queries -------------------------------------------------------------
    @property
    def n_feet(self) -> int:
        return len(self.feet_names)

    def foot_nb(self, name: str) -> int:
        return self.feet_names.index(name)

    def get_reference_state(self) -> np.ndarray:
        return self.reference_state

    def difference(self, x1, x2) -> torch.Tensor:
        """[pin::difference(q1,q2); v2-v1] (robot-handler.cpp:81-96)."""
        return soa.state_difference(self.model, _host(x1)[:, None],
                                    _host(x2)[:, None])[:, 0]

    def integrate(self, x, dx) -> torch.Tensor:
        return soa.state_integrate(self.model, _host(x)[:, None],
                                   _host(dx)[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class DataCache:
    """Functional equivalent of pinocchio::Data after updateInternalData
    (robot-handler.cpp:114-140).  Host float64 tensors."""

    q: torch.Tensor
    v: torch.Tensor
    oR: torch.Tensor  # (nj,3,3)
    op: torch.Tensor  # (nj,3)
    fR: torch.Tensor  # (nframes,3,3)
    fp: torch.Tensor  # (nframes,3)
    com: torch.Tensor  # (3,)
    hg: torch.Tensor  # (6,) centroidal momentum [lin; ang]


class RobotDataHandler:
    """Compute cache layer (robot-handler.hpp:227-271)."""

    def __init__(self, model_handler: RobotModelHandler):
        self.model_handler = model_handler
        self.data: Optional[DataCache] = None
        self.update(model_handler.reference_state)

    def update(self, x) -> DataCache:
        m = self.model_handler.model
        x = _host(x)
        q, v = x[: m.nq], x[m.nq:]
        oR, op = soa.fk_world(m, q[:, None])
        fR, fp = soa.frame_placements_world(m, oR, op)
        com = soa.com_world(m, oR, op)
        Sw = soa.world_axes(m, oR, op)
        hg = soa.agx(m, oR, op, Sw, v[:, None], com)
        self.data = DataCache(q=q, v=v, oR=oR[..., 0], op=op[..., 0],
                              fR=fR[..., 0], fp=fp[..., 0], com=com[:, 0],
                              hg=hg[:, 0])
        return self.data

    def get_centroidal_state(self) -> torch.Tensor:
        """9-dim [com; h_lin; h_ang] (robot-handler.cpp:142-149)."""
        return torch.cat([self.data.com, self.data.hg])

    def get_foot_pose(self, foot_nb: int):
        fid = self.model_handler.feet_frame_ids[foot_nb]
        return self.data.fR[fid], self.data.fp[fid]

    def get_foot_ref_pose(self, foot_nb: int):
        fid = self.model_handler.feet_ref_frame_ids[foot_nb]
        # ref frames may be added after the cache was built; recompute lazily
        m = self.model_handler.model
        fR, fp = soa.frame_placements_world(m, self.data.oR[..., None],
                                            self.data.op[..., None])
        return fR[fid, ..., 0], fp[fid, ..., 0]

    def get_base_frame_pose(self):
        fid = self.model_handler.base_frame_id
        return self.data.fR[fid], self.data.fp[fid]
