"""SRDF parsing — reference-configuration and rotor-parameter loading.

A copy of `simple_mpc_tpu.models.srdf` (numpy and ElementTree only), kept in
the PyTorch port so the port never imports the JAX package.

Capability parity with `pinocchio::srdf::loadReferenceConfigurations` and
`loadRotorParameters` as consumed by the reference fixtures
(reference: tests/test_utils.cpp:22-24 — talos.srdf provides the
"half_sitting" group state and per-joint rotor inertia/gear ratio).
Host-side, runs once at model load.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from .model import FREE, RobotModel


def _root(path_or_string: str) -> ET.Element:
    if path_or_string.lstrip().startswith("<"):
        return ET.fromstring(path_or_string)
    return ET.parse(path_or_string).getroot()


def load_reference_configurations(model: RobotModel, srdf: str,
                                  update_model: bool = True
                                  ) -> Dict[str, np.ndarray]:
    """Parse every `<group_state>` into a full configuration vector keyed
    by its name.  Joints absent from a group state keep their neutral
    value; a free-flyer joint accepts a 7-number `value` (xyz + quat
    xyzw).  With update_model=True (default) the configurations are also
    registered on `model.reference_configurations`, mirroring pinocchio's
    in-place behavior."""
    root = _root(srdf)
    out: Dict[str, np.ndarray] = {}
    for gs in root.findall("group_state"):
        name = gs.get("name")
        q = model.neutral()
        for jel in gs.findall("joint"):
            jname = jel.get("name")
            if jname not in model.joint_names:
                continue  # locked/absent joints are skipped, as pinocchio does
            j = model.joint_id(jname)
            vals = np.array([float(v) for v in jel.get("value").split()])
            iq = model.idx_q[j]
            n = 7 if model.joint_types[j] == FREE else 1
            if vals.size != n:
                raise ValueError(
                    f"group_state {name!r}: joint {jname!r} expects {n} "
                    f"value(s), got {vals.size}")
            q[iq: iq + n] = vals
        out[name] = q
        if update_model:
            model.reference_configurations[name] = q
    return out


def load_rotor_parameters(model: RobotModel, srdf: str,
                          update_model: bool = True):
    """Parse `<rotor_params><joint name=... mass=... gear_ratio=.../>`
    into per-dof rotor inertia ("mass" in pinocchio's SRDF convention)
    and gear-ratio arrays (nv,).  Free-flyer dofs stay at 0 inertia /
    1 gear ratio."""
    root = _root(srdf)
    rotor_inertia = np.zeros(model.nv)
    gear_ratio = np.ones(model.nv)
    rp = root.find("rotor_params")
    if rp is not None:
        for jel in rp.findall("joint"):
            jname = jel.get("name")
            if jname not in model.joint_names:
                continue
            j = model.joint_id(jname)
            if model.joint_types[j] == FREE:
                continue
            iv = model.idx_v[j]
            rotor_inertia[iv] = float(jel.get("mass", "0"))
            gear_ratio[iv] = float(jel.get("gear_ratio", "1"))
    if update_model:
        model.rotor_inertia = rotor_inertia
        model.rotor_gear_ratio = gear_ratio
    return rotor_inertia, gear_ratio
