"""Receding-horizon MPC on the port's solver: the host engine and the fused
tick."""
from .foot_trajectory import FootTrajectory
from .fused import FusedMPC, MPCCarry
from .mpc import MPC, MPCSettings

__all__ = ["FootTrajectory", "FusedMPC", "MPC", "MPCCarry", "MPCSettings"]
