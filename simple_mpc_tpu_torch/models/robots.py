"""Packaged robot loaders (Go2, Solo12) — the example-robot-data equivalent.

A copy of the Go2 and Solo12 loaders of `simple_mpc_tpu.models.robots`.
The URDF assets are read by file path from the JAX package's
`models/assets/` directory (they are data files, so reading them imports
nothing of that package).  Each loader registers the reference
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


LOADERS = {"go2": load_go2, "solo12": load_solo12}


def load(name: str) -> RobotModel:
    return LOADERS[name]()
