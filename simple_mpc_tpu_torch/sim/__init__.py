"""The rigid-contact simulator of the closed loop."""
from .simulator import SimSettings, Simulator  # noqa: F401
