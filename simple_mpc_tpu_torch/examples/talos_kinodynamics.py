"""Talos kinodynamics MPC + KinodynamicsID closed loop.

Port of the JAX package's `examples/talos_kinodynamics.py` (reference
examples/talos_kinodynamics.py: biped footsteps, T=100, two 6D quad feet,
ID tracking at 1 kHz):

    python -m simple_mpc_tpu_torch.examples.talos_kinodynamics [n_steps]

runs it on the card in float32 and writes the trajectory to
simple_mpc_tpu_torch/_build/talos_kinodynamics.npz (git-ignored);
`main(n_steps, T, device="cpu", dtype=torch.float64)` runs it on the CPU.
The simulator keeps 3D point contacts at the two sole frames, as the JAX
package's does.
"""
import os
import sys

import numpy as np
import torch

from ..configs import talos_handler
from ..id.kinodynamics_id import IDSettings, KinodynamicsID
from ..mpc import MPC, MPCSettings
from ..ocp.kinodynamics import KinodynamicsOCP
from .loop import run_closed_loop, save_trajectory

ID_SETTINGS = dict(kp_base=10.0, kp_posture=10.0, kp_contact=50.0, w_base=1.0,
                   w_posture=0.1, w_contact_motion=100.0, w_contact_force=0.05,
                   Lfoot=0.1, Wfoot=0.075, qp_iters=60)
MPC_SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.1, T_fly=80,
                    T_contact=20, timestep=0.01)
WALK = np.array([0.1, 0, 0, 0, 0, 0])


def talos_kinodynamics_config(mh):
    """examples/talos_kinodynamics.py settings (6D quad feet)."""
    nv = mh.model.nv
    w_x = np.array([0, 0, 1000, 1000, 1000, 1000] + [10.0] * (nv - 6)
                   + [10, 10, 10, 100, 100, 100] + [1.0] * (nv - 6))
    w_u = np.concatenate([np.tile([1e-2, 1e-2, 1e-2, 1e-2, 1e-2, 1e-2], 2),
                          np.ones(nv - 6) * 1e-4])
    return dict(
        timestep=0.01, w_x=w_x, w_u=w_u,
        w_cent=np.concatenate([[0.0, 0.0, 10.0], [0.1, 0.1, 10.0]]),
        w_centder=np.concatenate([np.zeros(3), np.ones(3) * 0.1]),
        gravity=np.array([0, 0, -9.81]), force_size=6,
        w_frame=np.ones(6) * 2000.0,
        qmin=mh.model.lower_limit[7:], qmax=mh.model.upper_limit[7:],
        mu=0.8, Lfoot=0.1, Wfoot=0.075,
        kinematics_limits=True, force_cone=False, land_cstr=False,
    )


def biped(feet):
    """The example's gait: 20 double support, 80 on the left foot, 20
    double support, 80 on the right."""
    left, right = feet
    return ([{left: True, right: True}] * 20 + [{left: True, right: False}] * 80
            + [{left: True, right: True}] * 20 + [{left: False, right: True}] * 80)


def setup(T=100, device="cuda", dtype=torch.float32, **mpc_settings):
    """(mpc, mh, idq) of the example on `device` in `dtype`; `mpc_settings`
    override fields of its MPCSettings."""
    mh = talos_handler()
    ocp = KinodynamicsOCP(talos_kinodynamics_config(mh), mh, device, dtype)
    ocp.create_problem(np.asarray(mh.reference_state), T, 6, -9.81, False)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81,
                          **{**MPC_SETTINGS, **mpc_settings}), ocp)
    idq = KinodynamicsID(mh, 1e-3, IDSettings(**ID_SETTINGS), device=device, dtype=dtype)
    return mpc, mh, idq


def run(mpc, mh, idq, n_steps=100, log_every=10, gait=None):
    """The biped gait (or `gait`) at 0.1 m/s in closed loop for n_steps MPC
    ticks."""
    return run_closed_loop(mpc, mh, id_solver=idq, n_steps=n_steps, walk_velocity=WALK,
                           gait=biped(mh.feet_names) if gait is None else gait,
                           log_every=log_every)


def main(n_steps=100, T=100, device="cuda", dtype=torch.float32, out=None, log_every=10):
    log = run(*setup(T, device, dtype), n_steps=n_steps, log_every=log_every)
    if out is not None:
        save_trajectory(log, out)
    return log


if __name__ == "__main__":
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
    os.makedirs(build, exist_ok=True)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100,
         out=os.path.join(build, "talos_kinodynamics.npz"))
