"""Canonical robot + OCP configurations mirroring the reference examples.

Port of the Go2 kinodynamics entries of `simple_mpc_tpu.configs` (the
settings dictionaries of examples/go2_kinodynamics.py), and the fused-tick
engines of the JAX package's bench (`bench.py` `_make_fused`).
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


def make_go2_kinodynamics(T: int = 100, device="cuda", dtype=torch.float64):
    """Flagship configuration: Go2 kinodynamic MPC, horizon T, with its
    problem built on `device` in `dtype`."""
    from .ocp.kinodynamics import KinodynamicsOCP

    mh = go2_handler()
    ocp = KinodynamicsOCP(go2_kinodynamics_config(mh), mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 3, -9.81, False)
    return ocp, mh, x0


def make_go2_fused(T: int = 100, device="cuda", dtype=torch.float32, parallel=False):
    """The fused-tick engine of the JAX package's bench (`bench.py:277-311`):
    Go2 kinodynamics, trot 10/30/10/30 at 0.2 m/s, apex 0.15 m, one
    iteration a tick with mu_init 1e-6, init_max_iters 2.  `parallel=False`
    is the throughput configuration (serial Riccati, K3); `parallel=True` the
    B=1 latency configuration (associative-scan Riccati, K6), at full
    precision (the bench's bfloat16 tangents are not ported).  Returns
    (fused, carry)."""
    from .mpc import MPC, FusedMPC, MPCSettings
    from .parallel import BatchedSolver
    from .solver.proxddp import ProxDDPSolver, SolverSettings

    ocp, mh, _ = make_go2_kinodynamics(T, device=device, dtype=dtype)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, max_iters=1, T_fly=30,
                          T_contact=10, swing_apex=0.15, init_max_iters=2), ocp)
    mpc.solver = BatchedSolver(ProxDDPSolver(ocp, SolverSettings(
        tol=mpc.settings.TOL, mu_init=1e-6, max_iters=1, parallel=parallel)))
    FL, FR, RL, RR = mh.feet_names
    allc = {n: True for n in mh.feet_names}
    mpc.generate_cycle_horizon([allc] * 10 + [{FL: True, FR: False, RL: False, RR: True}] * 30
                               + [allc] * 10 + [{FL: False, FR: True, RL: True, RR: False}] * 30)
    mpc.switch_to_walk(np.array([0.2, 0, 0, 0, 0, 0]))
    fused = FusedMPC(mpc)
    return fused, fused.make_carry(mpc)
