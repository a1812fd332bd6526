"""Cone constraint residuals: friction pyramid, wrench cone, boxes.

Port of `simple_mpc_tpu.ocp.cones` (Aligator Friction/WrenchCone residual
capability, reference centroidal-dynamics.cpp:85-104, kinodynamics.cpp:
116-133).  Linear inequalities r = A f <= 0, masked per stage by contact
activity.
"""
from __future__ import annotations

import numpy as np
import torch

# minimum normal force in the friction pyramid's fz row
FRICTION_EPS = 1e-4


def friction_cone_mat(mu: float) -> np.ndarray:
    """(5, 3) pyramid: fz >= eps, |fx| <= mu fz, |fy| <= mu fz."""
    return np.array(
        [
            [0.0, 0.0, -1.0],
            [1.0, 0.0, -mu],
            [-1.0, 0.0, -mu],
            [0.0, 1.0, -mu],
            [0.0, -1.0, -mu],
        ]
    )


def friction_cone(f3, mu: float, eps: float = FRICTION_EPS):
    """Residual (..., 5) <= 0 for 3D forces (..., 3) in the contact frame."""
    A = torch.as_tensor(friction_cone_mat(mu), dtype=f3.dtype, device=f3.device)
    r = f3 @ A.T
    return torch.cat([r[..., :1] + eps, r[..., 1:]], dim=-1)  # fz >= eps


def wrench_cone_mat(mu: float, L: float, W: float) -> np.ndarray:
    """(17, 6) rectangular-foot contact wrench cone (Caron et al. CWC):
    friction pyramid (4), fz>0 (1), CoP box (4), yaw-torque limits (8).
    Wrench ordering [fx, fy, fz, tx, ty, tz] about the foot-frame center.
    """
    rows = []
    # |fx| <= mu fz ; |fy| <= mu fz
    rows += [[1, 0, -mu, 0, 0, 0], [-1, 0, -mu, 0, 0, 0],
             [0, 1, -mu, 0, 0, 0], [0, -1, -mu, 0, 0, 0]]
    # fz >= 0
    rows += [[0, 0, -1, 0, 0, 0]]
    # CoP inside foot: |ty| <= L fz ; |tx| <= W fz   (L = half-length x, W = half-width y)
    rows += [[0, 0, -L, 0, 1, 0], [0, 0, -L, 0, -1, 0],
             [0, 0, -W, 1, 0, 0], [0, 0, -W, -1, 0, 0]]
    # yaw torque limits
    rows += [
        [-W, -L, -(L + W) * mu, mu, mu, -1],
        [-W, L, -(L + W) * mu, mu, -mu, -1],
        [W, -L, -(L + W) * mu, -mu, mu, -1],
        [W, L, -(L + W) * mu, -mu, -mu, -1],
        [W, L, -(L + W) * mu, mu, mu, 1],
        [W, -L, -(L + W) * mu, mu, -mu, 1],
        [-W, L, -(L + W) * mu, -mu, mu, 1],
        [-W, -L, -(L + W) * mu, -mu, -mu, 1],
    ]
    return np.array(rows, dtype=np.float64)


def wrench_cone(f6, mu: float, L: float, W: float):
    """Residual (..., 17) <= 0 for 6D wrenches (..., 6) in the foot frame."""
    A = torch.as_tensor(wrench_cone_mat(mu, L, W), dtype=f6.dtype, device=f6.device)
    return f6 @ A.T


def box(value, lower, upper):
    """Two-sided bound as stacked inequalities (..., 2n) <= 0.

    Infinite bounds produce -inf rows; callers clamp with `mask_ineq`.
    """
    lo = torch.as_tensor(lower, dtype=value.dtype, device=value.device)
    hi = torch.as_tensor(upper, dtype=value.dtype, device=value.device)
    return torch.cat([value - hi, lo - value], dim=-1)


def mask_ineq(r, mask):
    """Deactivate inequality rows: masked-out rows become -1 (satisfied).
    Also neutralizes +/-inf rows coming from unbounded box limits."""
    r = torch.where(torch.isfinite(r), r, -1.0)
    return torch.where(torch.as_tensor(mask, device=r.device), r, -1.0)


def mask_eq(r, mask):
    """Deactivate equality rows (residual forced to 0)."""
    return torch.where(torch.as_tensor(mask, device=r.device), r, 0.0)
