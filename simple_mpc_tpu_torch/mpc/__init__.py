"""Receding-horizon MPC on the port's solver."""
from .foot_trajectory import FootTrajectory
from .mpc import MPC, MPCSettings

__all__ = ["FootTrajectory", "MPC", "MPCSettings"]
