"""simple_mpc_tpu_torch — PyTorch/CUDA port of simple_mpc_tpu.

The JAX package `simple_mpc_tpu` is the reference; this package re-implements
its main path (Go2 and Talos kinodynamics, full-dynamics and Talos
centroidal OCPs, batched ProxDDP
solver with the serial or the parallel-in-time Riccati pass, host MPC, fused
tick, and the closed loop's interpolation, inverse-dynamics QP and
rigid-contact simulator) with PyTorch,
and the JAX package's device kernels as hand-written CUDA kernels for Hopper
(`kernels.py`, `csrc/`).  It never imports JAX.
"""
__version__ = "0.1.0"

from . import configs, models, ocp, ops, parallel, solver, utils  # noqa: F401
from .id.centroidal_id import CentroidalID  # noqa: F401
from .id.kinodynamics_id import IDSettings, KinodynamicsID  # noqa: F401
from .models.handler import RobotDataHandler, RobotModelHandler  # noqa: F401
from .mpc import MPC, FootTrajectory, MPCSettings  # noqa: F401
from .ocp.centroidal import CentroidalOCP  # noqa: F401
from .ocp.fulldynamics import FullDynamicsOCP  # noqa: F401
from .ocp.kinodynamics import KinodynamicsOCP  # noqa: F401
from .parallel import BatchedSolver, tile_problem  # noqa: F401
from .sim.simulator import SimSettings, Simulator  # noqa: F401
from .solver.proxddp import ProxDDPSolver, Results, SolverSettings  # noqa: F401
from .utils.friction import FrictionCompensation  # noqa: F401
from .utils.interpolator import Interpolator  # noqa: F401
