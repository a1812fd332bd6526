"""URDF -> RobotModel compiler (host-side, runs once at setup).

A copy of `simple_mpc_tpu.models.urdf` (numpy only).

Capability parity with pinocchio's URDF parsing + buildReducedModel as used
by the reference test fixtures (reference: tests/test_utils.cpp:21-62).
Supports revolute/continuous/prismatic/fixed joints, a free-flyer root
joint, fixed-joint folding (inertia merging + frame recording), and locked
joints for reduced models.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from .model import FREE, PRISMATIC, REVOLUTE, Frame, RobotModel


def _rpy_to_matrix(r: float, p: float, y: float) -> np.ndarray:
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(el) -> tuple[np.ndarray, np.ndarray]:
    if el is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
    return _rpy_to_matrix(*rpy), xyz


class _Inertia:
    """Spatial inertia: mass, CoM, rotational inertia about CoM."""

    def __init__(self, m=0.0, c=None, I=None):
        self.m = m
        self.c = np.zeros(3) if c is None else c
        self.I = np.zeros((3, 3)) if I is None else I

    @staticmethod
    def from_urdf(el) -> "_Inertia":
        if el is None:
            return _Inertia()
        m = float(el.find("mass").get("value")) if el.find("mass") is not None else 0.0
        R, p = _parse_origin(el.find("origin"))
        iel = el.find("inertia")
        if iel is not None:
            ixx, iyy, izz = (float(iel.get(k, "0")) for k in ("ixx", "iyy", "izz"))
            ixy, ixz, iyz = (float(iel.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        else:
            I = np.zeros((3, 3))
        return _Inertia(m, p, R @ I @ R.T)

    def transformed(self, R: np.ndarray, p: np.ndarray) -> "_Inertia":
        """Express this inertia in a frame A where (R, p) = aMb."""
        return _Inertia(self.m, R @ self.c + p, R @ self.I @ R.T)

    def __add__(self, other: "_Inertia") -> "_Inertia":
        m = self.m + other.m
        if m <= 0.0:
            return _Inertia()
        c = (self.m * self.c + other.m * other.c) / m

        def shift(I, mi, ci):
            d = ci - c
            return I + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        return _Inertia(m, c, shift(self.I, self.m, self.c) + shift(other.I, other.m, other.c))


class _UrdfJoint:
    def __init__(self, el):
        self.name = el.get("name")
        self.type = el.get("type")
        self.parent = el.find("parent").get("link")
        self.child = el.find("child").get("link")
        self.R, self.p = _parse_origin(el.find("origin"))
        ax = el.find("axis")
        self.axis = (
            np.array([float(v) for v in ax.get("xyz").split()]) if ax is not None
            else np.array([1.0, 0.0, 0.0])
        )
        n = np.linalg.norm(self.axis)
        if n > 0:
            self.axis = self.axis / n
        lim = el.find("limit")
        self.lower = float(lim.get("lower", "-inf")) if lim is not None else -np.inf
        self.upper = float(lim.get("upper", "inf")) if lim is not None else np.inf
        self.effort = float(lim.get("effort", "inf")) if lim is not None else np.inf
        self.velocity = float(lim.get("velocity", "inf")) if lim is not None else np.inf
        dyn = el.find("dynamics")
        self.damping = float(dyn.get("damping", "0")) if dyn is not None else 0.0
        self.friction = float(dyn.get("friction", "0")) if dyn is not None else 0.0
        if self.type == "continuous":
            self.type = "revolute"
            self.lower, self.upper = -np.inf, np.inf


def load_urdf(
    path_or_string: str,
    name: Optional[str] = None,
    free_flyer: bool = True,
    locked_joints: Sequence[str] = (),
    locked_values: Optional[Dict[str, float]] = None,
) -> RobotModel:
    """Compile a URDF into a RobotModel.

    locked_joints are folded as fixed at locked_values[name] (default 0) —
    the buildReducedModel capability (reference tests/test_utils.cpp:40-62).
    """
    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()
    locked_values = locked_values or {}
    locked = set(locked_joints)

    links: Dict[str, ET.Element] = {el.get("name"): el for el in root.findall("link")}
    joints = [_UrdfJoint(el) for el in root.findall("joint")]
    children: Dict[str, List[_UrdfJoint]] = {}
    child_links = set()
    for j in joints:
        children.setdefault(j.parent, []).append(j)
        child_links.add(j.child)
    root_links = [ln for ln in links if ln not in child_links]
    if len(root_links) != 1:
        raise ValueError(f"expected one root link, found {root_links}")
    root_link = root_links[0]

    # accumulators for the output model
    joint_names: List[str] = []
    joint_types: List[int] = []
    parents: List[int] = []
    jR: List[np.ndarray] = []
    jp: List[np.ndarray] = []
    axes: List[np.ndarray] = []
    inertias: List[_Inertia] = []
    frames: List[Frame] = []
    lower, upper, vel_lim, eff_lim, damping, friction = [], [], [], [], [], []

    def link_inertia(link_name: str) -> _Inertia:
        el = links[link_name]
        return _Inertia.from_urdf(el.find("inertial"))

    def add_movable(uj: Optional[_UrdfJoint], parent_idx: int, R: np.ndarray,
                    p: np.ndarray, child_link: str, jtype: int):
        """Register a movable joint placed at (R,p) rel. to parent joint."""
        idx = len(joint_names)
        joint_names.append(uj.name if uj else "root_joint")
        joint_types.append(jtype)
        parents.append(parent_idx)
        jR.append(R)
        jp.append(p)
        axes.append(uj.axis if (uj and jtype != FREE) else np.zeros(3))
        inertias.append(link_inertia(child_link))
        frames.append(Frame(child_link, idx, np.eye(3), np.zeros(3)))
        if jtype == FREE:
            lower.extend([-np.inf] * 3 + [-1.0001] * 4)
            upper.extend([np.inf] * 3 + [1.0001] * 4)
            vel_lim.extend([np.inf] * 6)
            eff_lim.extend([np.inf] * 6)
            damping.extend([0.0] * 6)
            friction.extend([0.0] * 6)
        else:
            lower.append(uj.lower)
            upper.append(uj.upper)
            vel_lim.append(uj.velocity)
            eff_lim.append(uj.effort)
            damping.append(uj.damping)
            friction.append(uj.friction)
        return idx

    def walk(link_name: str, joint_idx: int, R_acc: np.ndarray, p_acc: np.ndarray):
        """Process all child joints of link_name; (R_acc,p_acc) = placement of
        link_name's frame relative to supporting movable joint joint_idx."""
        for uj in children.get(link_name, []):
            Rj = R_acc @ uj.R
            pj = R_acc @ uj.p + p_acc
            is_locked = uj.name in locked
            if uj.type == "fixed" or is_locked:
                if is_locked and uj.type != "fixed":
                    qv = locked_values.get(uj.name, 0.0)
                    if uj.type == "revolute":
                        c, s = math.cos(qv), math.sin(qv)
                        a = uj.axis
                        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
                        Rq = np.eye(3) + s * K + (1 - c) * (K @ K)
                        Rj = Rj @ Rq
                    elif uj.type == "prismatic":
                        pj = pj + Rj @ (uj.axis * locked_values.get(uj.name, 0.0))
                # merge child link inertia into current movable joint's body
                inertias[joint_idx] = inertias[joint_idx] + link_inertia(uj.child).transformed(Rj, pj)
                frames.append(Frame(uj.child, joint_idx, Rj, pj))
                walk(uj.child, joint_idx, Rj, pj)
            elif uj.type in ("revolute", "prismatic"):
                jtype = REVOLUTE if uj.type == "revolute" else PRISMATIC
                idx = add_movable(uj, joint_idx, Rj, pj, uj.child, jtype)
                walk(uj.child, idx, np.eye(3), np.zeros(3))
            elif uj.type == "floating":
                idx = add_movable(uj, joint_idx, Rj, pj, uj.child, FREE)
                walk(uj.child, idx, np.eye(3), np.zeros(3))
            else:
                raise ValueError(f"unsupported joint type {uj.type} ({uj.name})")

    if free_flyer:
        add_movable(None, -1, np.eye(3), np.zeros(3), root_link, FREE)
        walk(root_link, 0, np.eye(3), np.zeros(3))
    else:
        # root link welded to world: its inertia is unused (fixed base)
        raise NotImplementedError("fixed-base models not needed yet")

    model = RobotModel(
        name=name or root.get("name", "robot"),
        joint_names=tuple(joint_names),
        joint_types=tuple(joint_types),
        parents=tuple(parents),
        jR=np.stack(jR),
        jp=np.stack(jp),
        axes=np.stack(axes),
        mass=np.array([i.m for i in inertias]),
        com=np.stack([i.c for i in inertias]),
        inertia=np.stack([i.I for i in inertias]),
        frames=frames,
        lower_limit=np.array(lower),
        upper_limit=np.array(upper),
        velocity_limit=np.array(vel_lim),
        effort_limit=np.array(eff_lim),
        damping=np.array(damping),
        friction=np.array(friction),
    )
    return model
