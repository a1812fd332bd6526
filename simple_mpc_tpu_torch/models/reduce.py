"""Locked-joint model reduction — pinocchio::buildReducedModel equivalent.

A copy of `simple_mpc_tpu.models.reduce` (numpy only), kept in the PyTorch
port so the port never imports the JAX package.

Capability parity with the reference's Talos fixture construction
(reference: tests/test_utils.cpp:27-63, utils.py loadTalos): the full model
is reduced by locking a set of joints at a reference configuration; each
locked joint becomes a fixed transform, its body inertia is folded into the
supporting kept joint's body, its operational frames are re-parented, and
every named reference configuration is re-indexed onto the kept joints.

Host-side, runs once at setup — the output is an ordinary frozen RobotModel
whose (smaller) topology the kernels take as usual.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from .model import FREE, PRISMATIC, REVOLUTE, Frame, RobotModel


def _rot_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    a = np.asarray(axis, float)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


class _SpatialInertia:
    """mass, CoM, rotational inertia about CoM — all in one frame."""

    def __init__(self, m: float, c: np.ndarray, I: np.ndarray):
        self.m, self.c, self.I = float(m), np.asarray(c, float), np.asarray(I, float)

    def transformed(self, R: np.ndarray, p: np.ndarray) -> "_SpatialInertia":
        """Express in frame A given aMb = (R, p) with self in frame B."""
        return _SpatialInertia(self.m, R @ self.c + p, R @ self.I @ R.T)

    def __add__(self, o: "_SpatialInertia") -> "_SpatialInertia":
        m = self.m + o.m
        if m <= 0.0:
            return _SpatialInertia(0.0, np.zeros(3), np.zeros((3, 3)))
        c = (self.m * self.c + o.m * o.c) / m

        def shift(I, mi, ci):
            d = ci - c
            return I + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        return _SpatialInertia(
            m, c, shift(self.I, self.m, self.c) + shift(o.I, o.m, o.c))


def _q_block(model: RobotModel, q: np.ndarray, j: int) -> np.ndarray:
    iq = model.idx_q[j]
    n = 7 if model.joint_types[j] == FREE else 1
    return np.asarray(q[iq: iq + n], float)


def build_reduced_model(
    model: RobotModel,
    locked_joint_names: Sequence[str],
    q_ref: Optional[np.ndarray] = None,
    name: Optional[str] = None,
) -> RobotModel:
    """Reduce `model` by locking the named joints at configuration `q_ref`
    (default: neutral).  Kept joints preserve their relative order; locked
    subtrees' inertias fold into their supporting kept joint at the locked
    configuration, exactly as pinocchio::buildReducedModel
    (reference tests/test_utils.cpp:63)."""
    locked = set(locked_joint_names)
    unknown = locked - set(model.joint_names)
    if unknown:
        raise ValueError(f"unknown joints to lock: {sorted(unknown)}")
    if model.joint_names and model.joint_names[0] in locked:
        raise ValueError("cannot lock the root (free-flyer) joint")
    q_ref = model.neutral() if q_ref is None else np.asarray(q_ref, float)
    if q_ref.shape != (model.nq,):
        raise ValueError(f"q_ref must have shape ({model.nq},)")

    # support[j] = (new_joint_idx, R, p): placement of old joint j's
    # post-motion frame relative to its supporting kept joint's frame (with
    # locked joints at their q_ref values; identity for kept joints).
    support: Dict[int, tuple] = {}

    joint_names, joint_types, parents = [], [], []
    jR, jp, axes = [], [], []
    inertias: list[_SpatialInertia] = []
    lower, upper, vel_lim, eff_lim, damping, friction = [], [], [], [], [], []
    rot_in, rot_gr = [], []
    old_kept: list[int] = []  # old joint idx per new joint

    def _limit_slices(j: int):
        iq, iv = model.idx_q[j], model.idx_v[j]
        nqj = 7 if model.joint_types[j] == FREE else 1
        nvj = 6 if model.joint_types[j] == FREE else 1
        return slice(iq, iq + nqj), slice(iv, iv + nvj)

    for j in range(model.njoints):
        par = model.parents[j]
        if par < 0:
            Rp, pp, kp = np.eye(3), np.zeros(3), -1
        else:
            kp, Rp, pp = support[par]
        # pre-motion placement of joint j relative to its kept ancestor
        R0 = Rp @ model.jR[j]
        p0 = Rp @ model.jp[j] + pp
        if model.joint_names[j] not in locked:
            new_idx = len(joint_names)
            joint_names.append(model.joint_names[j])
            joint_types.append(model.joint_types[j])
            parents.append(kp)
            jR.append(R0)
            jp.append(p0)
            axes.append(np.asarray(model.axes[j], float))
            inertias.append(_SpatialInertia(
                model.mass[j], model.com[j], model.inertia[j]))
            sq, sv = _limit_slices(j)
            lower.extend(np.asarray(model.lower_limit[sq]))
            upper.extend(np.asarray(model.upper_limit[sq]))
            vel_lim.extend(np.asarray(model.velocity_limit[sv]))
            eff_lim.extend(np.asarray(model.effort_limit[sv]))
            damping.extend(np.asarray(model.damping[sv]))
            friction.extend(np.asarray(model.friction[sv]))
            rot_in.extend(np.asarray(model.rotor_inertia[sv]))
            rot_gr.extend(np.asarray(model.rotor_gear_ratio[sv]))
            old_kept.append(j)
            support[j] = (new_idx, np.eye(3), np.zeros(3))
        else:
            qv = float(_q_block(model, q_ref, j)[0])
            if model.joint_types[j] == REVOLUTE:
                R = R0 @ _rot_axis_angle(model.axes[j], qv)
                p = p0
            elif model.joint_types[j] == PRISMATIC:
                R = R0
                p = p0 + R0 @ (np.asarray(model.axes[j], float) * qv)
            else:
                raise ValueError(
                    f"cannot lock free joint {model.joint_names[j]!r}")
            if kp < 0:
                raise ValueError(
                    f"locked joint {model.joint_names[j]!r} has no kept "
                    "supporting joint")
            inertias[kp] = inertias[kp] + _SpatialInertia(
                model.mass[j], model.com[j], model.inertia[j]
            ).transformed(R, p)
            support[j] = (kp, R, p)

    # re-parent every operational frame onto its supporting kept joint
    frames = []
    for f in model.frames:
        kp, Rs, ps = support[f.parent_joint]
        frames.append(Frame(f.name, kp, Rs @ f.R, Rs @ f.p + ps))

    reduced = RobotModel(
        name=name or model.name,
        joint_names=tuple(joint_names),
        joint_types=tuple(joint_types),
        parents=tuple(parents),
        jR=np.stack(jR), jp=np.stack(jp), axes=np.stack(axes),
        mass=np.array([i.m for i in inertias]),
        com=np.stack([i.c for i in inertias]),
        inertia=np.stack([i.I for i in inertias]),
        frames=frames,
        lower_limit=np.array(lower), upper_limit=np.array(upper),
        velocity_limit=np.array(vel_lim), effort_limit=np.array(eff_lim),
        damping=np.array(damping), friction=np.array(friction),
        rotor_inertia=np.array(rot_in), rotor_gear_ratio=np.array(rot_gr),
        gravity=np.asarray(model.gravity, float).copy(),
    )

    # re-index named reference configurations onto the kept joints
    for cname, q in model.reference_configurations.items():
        reduced.reference_configurations[cname] = np.concatenate(
            [_q_block(model, q, j) for j in old_kept])
    return reduced
