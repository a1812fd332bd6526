"""Scenario batches over one device."""
from .scenarios import BatchedSolver, tile_problem  # noqa: F401
