"""Packaged robot loaders (Go2, Solo12, Talos) — the example-robot-data
equivalent.

A copy of `simple_mpc_tpu.models.robots`.  The URDF and SRDF assets are
read by file path from the JAX package's `models/assets/` directory (they
are data files, so reading them imports nothing of that package).  Each loader registers the reference
configuration used by the examples and tests (reference: tests/
test_utils.cpp "standing"; examples/go2_kinodynamics.py:20-23).
"""
from __future__ import annotations

import os

from .model import RobotModel
from .urdf import load_urdf

_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "simple_mpc_tpu", "models", "assets")


def load_go2() -> RobotModel:
    model = load_urdf(os.path.join(_ASSETS, "go2.urdf"), name="go2")
    q = model.neutral()
    q[2] = 0.325
    # (hip, thigh, calf) per leg, order FL FR RL RR
    for i in range(4):
        q[7 + 3 * i: 10 + 3 * i] = [0.0, 0.8, -1.6]
    model.reference_configurations["standing"] = q
    return model


def load_solo12() -> RobotModel:
    model = load_urdf(os.path.join(_ASSETS, "solo12.urdf"), name="solo12")
    q = model.neutral()
    q[2] = 0.24
    for i, sgn in enumerate([1.0, 1.0, -1.0, -1.0]):  # FL FR HL HR
        q[7 + 3 * i: 10 + 3 * i] = [0.0, sgn * 0.8, -sgn * 1.6]
    model.reference_configurations["standing"] = q
    return model


# Joints the reference fixture keeps actuated (tests/test_utils.cpp:27-34):
# legs(12) + torso(2) + arm 1-4 both sides(8) = 22; everything else —
# forearms/wrists (arm 5-7), grippers, head — is locked at half_sitting.
TALOS_LOCKED_JOINTS = tuple(
    f"arm_{side}_{i}_joint" for side in ("left", "right") for i in (5, 6, 7)
) + ("gripper_left_joint", "gripper_right_joint", "head_1_joint", "head_2_joint")


def load_talos(reduced: bool = True) -> RobotModel:
    """Talos biped.  Mirrors the reference fixture pipeline exactly
    (tests/test_utils.cpp:21-63): URDF parse -> SRDF reference
    configurations + rotor parameters -> (reduced=True, default)
    build_reduced_model locking everything but legs+torso+arm 1-4 at
    half_sitting -> the 22-actuated-joint model every reference Talos
    config uses."""
    from .srdf import load_reference_configurations, load_rotor_parameters

    model = load_urdf(os.path.join(_ASSETS, "talos.urdf"), name="talos")
    srdf = os.path.join(_ASSETS, "talos.srdf")
    load_reference_configurations(model, srdf)
    load_rotor_parameters(model, srdf)
    if not reduced:
        return model
    from .reduce import build_reduced_model

    return build_reduced_model(
        model, TALOS_LOCKED_JOINTS,
        q_ref=model.reference_configurations["half_sitting"])


LOADERS = {"go2": load_go2, "solo12": load_solo12, "talos": load_talos}


def load(name: str) -> RobotModel:
    return LOADERS[name]()
