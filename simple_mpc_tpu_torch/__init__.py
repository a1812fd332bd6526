"""simple_mpc_tpu_torch — PyTorch/CUDA port of simple_mpc_tpu.

The JAX package `simple_mpc_tpu` is the reference; this package re-implements
its main path (Go2 kinodynamics and full-dynamics OCPs, batched ProxDDP
solver with the serial or the parallel-in-time Riccati pass, host MPC, fused
tick) with PyTorch,
and the JAX package's device kernels as hand-written CUDA kernels for Hopper
(`kernels.py`, `csrc/`).  It never imports JAX.
"""
__version__ = "0.1.0"

from . import configs, models, ocp, ops, parallel, solver, utils  # noqa: F401
from .models.handler import RobotDataHandler, RobotModelHandler  # noqa: F401
from .mpc import MPC, FootTrajectory, MPCSettings  # noqa: F401
from .ocp.fulldynamics import FullDynamicsOCP  # noqa: F401
from .ocp.kinodynamics import KinodynamicsOCP  # noqa: F401
from .parallel import BatchedSolver, tile_problem  # noqa: F401
from .solver.proxddp import ProxDDPSolver, Results, SolverSettings  # noqa: F401
