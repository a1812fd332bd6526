"""Talos centroidal MPC + CentroidalID closed loop.

Port of the JAX package's `examples/talos_centroidal.py` (reference
examples/talos_centroidal.py: biped walk, 20 double + 80 single support
twice, T=100, CentroidalID tracking the CoM and the swing feet at 1 kHz):

    python -m simple_mpc_tpu_torch.examples.talos_centroidal [n_steps]

runs it on the card in float32 and writes the trajectory to
simple_mpc_tpu_torch/_build/talos_centroidal.npz (git-ignored);
`main(n_steps, T, device="cpu", dtype=torch.float64)` runs it on the CPU.
"""
import os
import sys

import torch

from ..configs import talos_centroidal_config, talos_handler
from ..id.centroidal_id import CentroidalID
from ..id.kinodynamics_id import IDSettings
from ..models.handler import RobotDataHandler
from ..mpc import MPC, MPCSettings
from ..ocp.centroidal import CentroidalOCP
from .loop import run_closed_loop, save_trajectory
from .talos_kinodynamics import WALK, biped

ID_SETTINGS = dict(kp_base=10.0, kp_posture=10.0, kp_contact=50.0, kp_com=50.0,
                   kp_feet_tracking=50.0, w_base=1.0, w_posture=0.1,
                   w_contact_motion=100.0, w_contact_force=0.05, w_com=10.0,
                   w_feet_tracking=5.0, Lfoot=0.1, Wfoot=0.075, qp_iters=60)
MPC_SETTINGS = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.1, T_fly=80,
                    T_contact=20, timestep=0.01)


class Adapter:
    """The generic loop's kinodynamics-style `set_target(x, v, a, contacts,
    f)` mapped onto CentroidalID's: x is the interpolated 9-dim centroidal
    state [com; h]; the feet's targets are the MPC's stage-0 foot
    references with identity rotations and zero velocities."""

    def __init__(self, cid, mpc, mh):
        self.cid, self.mpc, self.mh = cid, mpc, mh
        eye = torch.eye(3, dtype=cid.dtype, device=cid.device)
        self._vel = [torch.zeros(6, dtype=cid.dtype, device=cid.device)] * mh.n_feet
        self._eye = eye

    def set_target(self, x_i, _v, a_t, contacts, f_t):
        oh = self.mpc.ocp_handler
        feet_pose = [(self._eye, oh.get_reference_pose(0, name)[1])
                     for name in self.mh.feet_names]
        self.cid.set_target(x_i[:3], x_i[3:6] / self.mh.mass, feet_pose, self._vel,
                            contacts, f_t)

    def solve(self, t, q, v):
        return self.cid.solve(t, q, v)


def setup_mpc(T=100, device="cuda", dtype=torch.float32, **mpc_settings):
    """(mpc, mh) of the example on `device` in `dtype`; `mpc_settings`
    override fields of its MPCSettings."""
    mh = talos_handler()
    ocp = CentroidalOCP(talos_centroidal_config(mh), mh, device, dtype)
    x0 = RobotDataHandler(mh).get_centroidal_state()
    ocp.create_problem(x0, T, 6, -9.81, False)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81,
                          **{**MPC_SETTINGS, **mpc_settings}), ocp)
    return mpc, mh


def setup(T=100, device="cuda", dtype=torch.float32, **mpc_settings):
    """(mpc, mh, id_solver) of the example: the MPC of `setup_mpc` and its
    CentroidalID behind the loop's `Adapter`."""
    mpc, mh = setup_mpc(T, device, dtype, **mpc_settings)
    cid = CentroidalID(mh, 1e-3, IDSettings(**ID_SETTINGS), device=device, dtype=dtype)
    return mpc, mh, Adapter(cid, mpc, mh)


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
         out=os.path.join(build, "talos_centroidal.npz"))
