"""Joint-friction compensation torque.

Port of `simple_mpc_tpu.utils.friction` (reference
src/friction-compensation.cpp:6-31): adds dry (friction*sign(v)) + viscous
(damping*v) terms, coefficients from the model tail(nu).  The coefficients
are copied to the caller's device once, not at every call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.model import RobotModel


class FrictionCompensation:
    def __init__(self, model: RobotModel, with_free_flyer: bool = True, device="cuda",
                 dtype=torch.float64):
        self.nu = model.nv - 6 if with_free_flyer else model.nv
        self.dry_friction = np.asarray(model.friction)[-self.nu:]
        self.viscous_friction = np.asarray(model.damping)[-self.nu:]
        self._coef = {}
        self._put(torch.device(device), dtype)

    def _put(self, device, dtype):
        key = (device, dtype)
        if key not in self._coef:
            self._coef[key] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                                    for a in (self.dry_friction, self.viscous_friction))
        return self._coef[key]

    def compute_friction(self, velocity, torque):
        """torque + viscous*v + dry*sign(v) (functional; the reference
        mutates in place)."""
        if velocity.shape[-1] != self.nu:
            raise ValueError("Velocity has wrong size")
        if torque.shape[-1] != self.nu:
            raise ValueError("Torque has wrong size")
        dry, visc = self._put(velocity.device, velocity.dtype)
        return torque + visc * velocity + dry * torch.sign(velocity)
