"""Go2 kinodynamics MPC + KinodynamicsID closed loop.

Port of the JAX package's `examples/go2_kinodynamics.py` (reference
examples/go2_kinodynamics.py: quadruped trot, 10 double-support + 30
diagonal-pair steps twice, T=50 horizon, ID tracking at 1 kHz):

    python -m simple_mpc_tpu_torch.examples.go2_kinodynamics [n_steps]

runs it on the card in float32 and writes the trajectory to
simple_mpc_tpu_torch/_build/go2_kinodynamics.npz (git-ignored);
`main(n_steps, T, device="cpu", dtype=torch.float64)` runs it on the CPU.
"""
import os
import sys

import numpy as np
import torch

from ..configs import go2_handler, go2_kinodynamics_config
from ..id.kinodynamics_id import IDSettings, KinodynamicsID
from ..mpc import MPC, MPCSettings
from ..ocp.kinodynamics import KinodynamicsOCP
from .loop import run_closed_loop, save_trajectory

ID_SETTINGS = dict(kp_base=10.0, kp_posture=10.0, kp_contact=50.0, w_base=1.0,
                   w_posture=0.1, w_contact_motion=100.0, w_contact_force=0.05, qp_iters=60)
WALK = np.array([0.2, 0, 0, 0, 0, 0])


def trot(feet):
    """The trot gait (go2_kinodynamics.py:135-138): diagonal pairs."""
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    return [ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30


def setup(T=50, device="cuda", dtype=torch.float32):
    """(mpc, mh, idq) of the example on `device` in `dtype`."""
    mh = go2_handler()
    ocp = KinodynamicsOCP(go2_kinodynamics_config(mh), mh, device, dtype)
    ocp.create_problem(np.asarray(mh.reference_state), T, 3, -9.81, False)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, TOL=1e-4, mu_init=1e-8,
                          max_iters=1, num_threads=1, swing_apex=0.05, T_fly=30,
                          T_contact=10, timestep=0.01), ocp)
    idq = KinodynamicsID(mh, 1e-3, IDSettings(**ID_SETTINGS), device=device, dtype=dtype)
    return mpc, mh, idq


def run(mpc, mh, idq, n_steps=100, log_every=10):
    """The trot at 0.2 m/s in closed loop for n_steps MPC ticks."""
    return run_closed_loop(mpc, mh, id_solver=idq, n_steps=n_steps, walk_velocity=WALK,
                           gait=trot(mh.feet_names), log_every=log_every)


def main(n_steps=100, T=50, device="cuda", dtype=torch.float32, out=None, log_every=10):
    log = run(*setup(T, device, dtype), n_steps=n_steps, log_every=log_every)
    if out is not None:
        save_trajectory(log, out)
    return log


if __name__ == "__main__":
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
    os.makedirs(build, exist_ok=True)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100,
         out=os.path.join(build, "go2_kinodynamics.npz"))
