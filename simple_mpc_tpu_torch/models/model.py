"""Static robot-model representation (host-side numpy).

A copy of `simple_mpc_tpu.models.model`, kept in the PyTorch port so the
port never imports the JAX package.  Capability parity with the reference's
RobotModelHandler / Pinocchio model layer (reference:
src/robot-handler.cpp:12-96, include/simple-mpc/robot-handler.hpp:28-225):
the model is a frozen, host-side object whose arrays become constant device
tensors in the kernels.

Conventions (Pinocchio-compatible):
  * configuration q: [base_pos(3), base_quat(xyzw)(4), q_joints(nj)]  (nq)
  * velocity v:      [v_base_LOCAL(3), w_base_LOCAL(3), qdot_joints]  (nv)
  * each movable joint j has a fixed placement (R, p) in its parent's joint
    frame and, for revolute/prismatic, a unit axis in its own frame.
  * body inertia attached to joint j: mass m_j, CoM c_j (joint frame),
    rotational inertia I_j about the CoM (joint frame axes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Joint type codes (static Python ints -> unrolled kernels)
FREE = 0
REVOLUTE = 1
PRISMATIC = 2


@dataclasses.dataclass(frozen=True, eq=False)
class Frame:
    """Operational frame rigidly attached to a joint."""

    name: str
    parent_joint: int
    R: np.ndarray  # (3,3) placement in parent joint frame
    p: np.ndarray  # (3,)


@dataclasses.dataclass(eq=False)
class RobotModel:
    """Fixed-topology rigid-body model (host-side, hashable by identity).

    Equivalent capability: pinocchio::Model as used by the reference
    (robot-handler.hpp:118-141).
    """

    name: str
    joint_names: Tuple[str, ...]
    joint_types: Tuple[int, ...]
    parents: Tuple[int, ...]  # parent joint index, -1 = world
    jR: np.ndarray  # (nj, 3, 3) joint placement rotation in parent joint frame
    jp: np.ndarray  # (nj, 3)    joint placement translation
    axes: np.ndarray  # (nj, 3)  joint axis (revolute/prismatic), zeros for free
    # inertia of the body attached to each joint (in that joint's frame):
    mass: np.ndarray  # (nj,)
    com: np.ndarray  # (nj, 3)
    inertia: np.ndarray  # (nj, 3, 3) about CoM
    frames: List[Frame] = dataclasses.field(default_factory=list)
    # limits (per configuration/velocity coordinate)
    lower_limit: Optional[np.ndarray] = None  # (nq,)
    upper_limit: Optional[np.ndarray] = None  # (nq,)
    velocity_limit: Optional[np.ndarray] = None  # (nv,)
    effort_limit: Optional[np.ndarray] = None  # (nv,)
    friction: Optional[np.ndarray] = None  # (nv,) dry friction coeff
    damping: Optional[np.ndarray] = None  # (nv,) viscous damping
    rotor_inertia: Optional[np.ndarray] = None  # (nv,) apparent rotor inertia
    rotor_gear_ratio: Optional[np.ndarray] = None  # (nv,) gear ratios
    reference_configurations: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    gravity: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, -9.81]))

    # ---- derived layout ---------------------------------------------------
    def __post_init__(self):
        idx_q, idx_v = [], []
        q, v = 0, 0
        for t in self.joint_types:
            idx_q.append(q)
            idx_v.append(v)
            if t == FREE:
                q += 7
                v += 6
            else:
                q += 1
                v += 1
        self.idx_q: Tuple[int, ...] = tuple(idx_q)
        self.idx_v: Tuple[int, ...] = tuple(idx_v)
        self.nq: int = q
        self.nv: int = v
        self.njoints: int = len(self.joint_types)
        if self.lower_limit is None:
            self.lower_limit = np.full(self.nq, -np.inf)
        if self.upper_limit is None:
            self.upper_limit = np.full(self.nq, np.inf)
        if self.velocity_limit is None:
            self.velocity_limit = np.full(self.nv, np.inf)
        if self.effort_limit is None:
            self.effort_limit = np.full(self.nv, np.inf)
        if self.friction is None:
            self.friction = np.zeros(self.nv)
        if self.damping is None:
            self.damping = np.zeros(self.nv)
        if self.rotor_inertia is None:
            self.rotor_inertia = np.zeros(self.nv)
        if self.rotor_gear_ratio is None:
            self.rotor_gear_ratio = np.ones(self.nv)
        self._frame_index = {f.name: i for i, f in enumerate(self.frames)}
        self._joint_index = {n: i for i, n in enumerate(self.joint_names)}

    # ---- queries ----------------------------------------------------------
    @property
    def nu(self) -> int:
        """Number of actuated coordinates (underactuated floating base)."""
        return self.nv - 6 if self.joint_types and self.joint_types[0] == FREE else self.nv

    def total_mass(self) -> float:
        """pinocchio::computeTotalMass equivalent (robot-handler.cpp:24)."""
        return float(np.sum(self.mass))

    def frame_id(self, name: str) -> int:
        return self._frame_index[name]

    def joint_id(self, name: str) -> int:
        return self._joint_index[name]

    def has_frame(self, name: str) -> bool:
        return name in self._frame_index

    def add_frame(self, frame: Frame) -> int:
        """Dynamic OP-frame registration (robot-handler.cpp:39-41)."""
        self.frames.append(frame)
        self._frame_index[frame.name] = len(self.frames) - 1
        return len(self.frames) - 1

    def neutral(self) -> np.ndarray:
        q = np.zeros(self.nq)
        for j, t in enumerate(self.joint_types):
            if t == FREE:
                q[self.idx_q[j] + 6] = 1.0  # identity quaternion (xyzw)
        return q

    def frames_arrays(self):
        """Stacked frame placements (nf,3,3),(nf,3) + parent joints (nf,)."""
        if not self.frames:
            return np.zeros((0, 3, 3)), np.zeros((0, 3)), np.zeros((0,), dtype=np.int32)
        R = np.stack([f.R for f in self.frames])
        p = np.stack([f.p for f in self.frames])
        par = np.array([f.parent_joint for f in self.frames], dtype=np.int32)
        return R, p, par
