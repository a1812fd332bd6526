"""Swing-foot reference generation — Bézier curves.

Port of `simple_mpc_tpu.mpc.foot_trajectory` (reference
src/foot-trajectory.cpp, FootTrajectory): one 9-control-point Bézier per
swing phase (4x initial point for zero vel/acc/jerk, midpoint = 3/4 initial
+ 1/4 final lifted by swing_apex, 4x final point, foot-trajectory.cpp:
41-62); horizon sampling walks backwards from the landing time: t < 0 ->
final pose, t > T_fly -> initial pose, else curve((T_fly - t)/T_fly)
(foot-trajectory.cpp:64-82).  The MPC runs this on the host in float64,
for all stages of one foot at once; the fused tick's twin samples every
foot of every scenario at once in the problem's dtype and device
(`sample_swing_batched`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Binomial coefficients C(8, i) for the degree-8 Bernstein basis.
_BINOM8 = (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0)


def _f64(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(dtype=torch.float64, device="cpu")
    return torch.as_tensor(np.array(a, np.float64))


def _control_points(p_init, p_final, swing_apex):
    """(..., 9, 3) control points from (..., 3) tensor endpoints."""
    mid = 0.75 * p_init + 0.25 * p_final
    mid = torch.cat([mid[..., :2], mid[..., 2:] + swing_apex], dim=-1)
    return torch.stack([p_init] * 4 + [mid] + [p_final] * 4, dim=-2)


def bezier_control_points(p_init, p_final, swing_apex):
    """(9, 3) control points of the swing Bézier (foot-trajectory.cpp:41-62),
    in float64 on the host."""
    return _control_points(_f64(p_init), _f64(p_final), swing_apex)


def bezier_eval(points, s):
    """Evaluate the degree-8 Bézier at s in [0, 1] (scalar or (..., n)).
    points: (..., 9, 3) -> (3,) or (..., n, 3)."""
    dtype, device = points.dtype, points.device
    i = torch.arange(9, dtype=dtype, device=device)
    s = torch.as_tensor(s, dtype=dtype, device=device)[..., None]
    basis = (torch.tensor(_BINOM8, dtype=dtype, device=device) * s ** i
             * (1.0 - s) ** (8.0 - i))
    return basis @ points


def sample_swing(p_init, p_final, swing_apex, time_to_land, T_fly, horizon):
    """(horizon, 3) foot reference positions over the lookahead window, in
    float64 on the host.

    Stage t samples the swing at countdown `time_to_land - t`: already landed
    -> final, not yet taken off -> initial, in flight -> Bézier.
    """
    return sample_swing_batched(_f64(p_init), _f64(p_final), swing_apex,
                                torch.as_tensor(time_to_land), T_fly, horizon)


def sample_swing_batched(p_init, p_final, swing_apex, time_to_land, T_fly, horizon):
    """`sample_swing` over leading batch axes, in p_init's dtype and device.
    p_init, p_final (..., 3), time_to_land (...) ints -> (..., horizon, 3)."""
    dtype, device = p_init.dtype, p_init.device
    t = (time_to_land.to(dtype)[..., None]
         - torch.arange(horizon, dtype=dtype, device=device))  # (..., horizon)
    s = torch.clamp((T_fly - t) / T_fly, 0.0, 1.0)
    curve = bezier_eval(_control_points(p_init, p_final, swing_apex), s)
    ref = torch.where((t < 0)[..., None], p_final[..., None, :], curve)
    return torch.where((t > T_fly)[..., None], p_init[..., None, :], ref)


class FootTrajectory:
    """Host-facing wrapper with the reference's update/get API
    (foot-trajectory.hpp:24-62)."""

    def __init__(self, initial_poses: Dict[str, np.ndarray], swing_apex: float,
                 T_fly: int, T_contact: int, T: int):
        self.names = list(initial_poses.keys())
        p0 = torch.stack([_f64(initial_poses[n]) for n in self.names])
        self.p_init = p0.clone()
        self.p_final = p0.clone()
        self.swing_apex = float(swing_apex)
        self.T_fly = int(T_fly)
        self.T_contact = int(T_contact)
        self.T = int(T)
        self.references = {n: np.tile(np.asarray(initial_poses[n], np.float64), (T, 1))
                           for n in self.names}

    def update_apex(self, apex: float):
        self.swing_apex = float(apex)

    def update_trajectory(self, update: bool, landing_time: int, ee_trans,
                          final_trans, ee_name: str):
        """(foot-trajectory.cpp:84-96) — refit the Bézier from the current
        foot position when `update`, then resample the horizon."""
        k = self.names.index(ee_name)
        if update:
            self.p_init[k] = _f64(ee_trans)
            self.p_final[k] = _f64(final_trans)
        ref = sample_swing(self.p_init[k], self.p_final[k], self.swing_apex,
                           landing_time, self.T_fly, self.T)
        self.references[ee_name] = ref.numpy()
        return ref

    def get_reference(self, ee_name: str):
        return self.references[ee_name]
