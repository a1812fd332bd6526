"""Canonical robot + OCP configurations mirroring the reference examples.

Port of the Go2 kinodynamics entries of `simple_mpc_tpu.configs` (the
settings dictionaries of examples/go2_kinodynamics.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .models import robots
from .models.handler import RobotModelHandler

GO2_FEET = ["FL_foot", "FR_foot", "RL_foot", "RR_foot"]


def go2_handler() -> RobotModelHandler:
    model = robots.load_go2()
    mh = RobotModelHandler(model, "standing", "base")
    for f in GO2_FEET:
        mh.add_point_foot(f, "base")
    return mh


def go2_kinodynamics_config(mh: RobotModelHandler) -> dict:
    """examples/go2_kinodynamics.py:40-86 settings."""
    nv = mh.model.nv
    w_x = np.array([0, 0, 100, 10, 10, 0] + [1, 1, 1] * 4
                   + [10, 10, 10, 10, 10, 10] + [0.1, 0.1, 0.1] * 4)
    w_u = np.concatenate([np.tile([0.01, 0.01, 0.01], 4), np.ones(nv - 6) * 1e-5])
    return dict(
        timestep=0.01, w_x=w_x, w_u=w_u,
        w_cent=np.concatenate([[0.0, 0.0, 1.0], [0.1, 0.1, 10.0]]),
        w_centder=np.concatenate([np.zeros(3), np.ones(3) * 0.1]),
        gravity=np.array([0, 0, -9.81]), force_size=3,
        w_frame=np.ones(3) * 2000.0,
        qmin=mh.model.lower_limit[7:], qmax=mh.model.upper_limit[7:],
        mu=0.8, Lfoot=0.01, Wfoot=0.01,
        kinematics_limits=True, force_cone=False, land_cstr=False,
    )


def make_go2_kinodynamics(T: int = 100, device="cpu", dtype=torch.float64):
    """Flagship configuration: Go2 kinodynamic MPC, horizon T, with its
    problem built on `device` in `dtype`."""
    from .ocp.kinodynamics import KinodynamicsOCP

    mh = go2_handler()
    ocp = KinodynamicsOCP(go2_kinodynamics_config(mh), mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 3, -9.81, False)
    return ocp, mh, x0
