"""Talos full-dynamics MPC with Riccati feedback.

Port of the JAX package's `examples/talos_fulldynamics.py` (reference
examples/talos_fulldynamics.py: biped, two 6D quad contacts, T=100, the
inner loop's torques u = us[0] - K0 difference(x, xs[0]), :203-205):

    python -m simple_mpc_tpu_torch.examples.talos_fulldynamics [n_steps]

runs it on the card in float32 and writes the trajectory to
simple_mpc_tpu_torch/_build/talos_fulldynamics.npz (git-ignored);
`main(n_steps, T, device="cpu", dtype=torch.float64)` runs it on the CPU.
The simulator keeps 3D point contacts at the two sole frames, as the JAX
package's does; a point bears no moment, and at T=100 the loop leaves its
start height's 0.1 m band within a few ticks (ROADMAP Queue 3).
"""
import os
import sys

import torch

from ..configs import make_talos_fulldynamics
from ..mpc import MPC, MPCSettings
from .loop import run_closed_loop, save_trajectory
from .talos_kinodynamics import MPC_SETTINGS, WALK, biped


def setup(T=100, device="cuda", dtype=torch.float32, **mpc_settings):
    """(mpc, mh) of the example on `device` in `dtype`; `mpc_settings`
    override fields of its MPCSettings."""
    ocp, mh, _ = make_talos_fulldynamics(T, device, dtype)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81,
                          **{**MPC_SETTINGS, **mpc_settings}), ocp)
    return mpc, mh


def run(mpc, mh, n_steps=50, log_every=10, gait=None):
    """The biped gait (or `gait`) at 0.1 m/s in closed loop for n_steps MPC
    ticks, with Riccati feedback in the inner loop."""
    return run_closed_loop(mpc, mh, id_solver=None, n_steps=n_steps, walk_velocity=WALK,
                           gait=biped(mh.feet_names) if gait is None else gait,
                           log_every=log_every)


def main(n_steps=50, T=100, device="cuda", dtype=torch.float32, out=None, log_every=10):
    log = run(*setup(T, device, dtype), n_steps=n_steps, log_every=log_every)
    if out is not None:
        save_trajectory(log, out)
    return log


if __name__ == "__main__":
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
    os.makedirs(build, exist_ok=True)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50,
         out=os.path.join(build, "talos_fulldynamics.npz"))
