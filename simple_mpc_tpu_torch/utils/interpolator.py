"""Sub-timestep interpolation between MPC knots for the 1 kHz loop.

Port of `simple_mpc_tpu.utils.interpolator` (reference src/interpolator.cpp):
configuration by Lie-group interpolation (:5-24), state = Lie q-part +
linear v-part (:26-48), generic linear (:50-67), contacts = nearest-knot
sample with clamp (:69-78).  The trajectory is a stacked (N, dim) tensor;
the delay is a host scalar, so the knot arithmetic runs in float64 on the
host (the JAX package's in float64) and only the blend touches the
trajectory's device.
"""
from __future__ import annotations

import math

import torch

from ..models.model import RobotModel
from ..ops import soa


def _knot(delay: float, timestep: float, n: int):
    """(knot i, next knot j, progress s in [0, 1)); past the last knot the
    final value is held (s = 0)."""
    step_nb = min(max(int(math.floor(delay / timestep)), 0), n - 1)
    progress = (delay - step_nb * timestep) / timestep
    if step_nb >= n - 1:
        return step_nb, step_nb, 0.0
    return step_nb, step_nb + 1, progress


class Interpolator:
    """Each method takes one delay, or a sequence of delays and returns the
    samples stacked (the sub-steps of one MPC tick in one lane-batched
    call: the same arithmetic per sample, one dispatch of the Lie algebra
    instead of one per sample)."""

    def __init__(self, model: RobotModel):
        self.model = model

    @staticmethod
    def _knots(delay, timestep, n):
        """Knot indices i, j (lists) and progress s (host list), and whether
        one delay was given."""
        one = not isinstance(delay, (list, tuple))
        ks = [_knot(float(d), timestep, n) for d in ([delay] if one else delay)]
        return [k[0] for k in ks], [k[1] for k in ks], [k[2] for k in ks], one

    def _lie(self, qi, qj, s):
        """q_i (+) s (q_j (-) q_i) on the lanes: qi, qj (N, nq), s (N,)."""
        dq = soa.difference(self.model, qi.T, qj.T)
        s = torch.as_tensor(s, dtype=qi.dtype).to(qi.device, non_blocking=True)
        return soa.integrate(self.model, qi.T, s * dq).T

    def interpolate_configuration(self, delay, timestep, qs):
        i, j, s, one = self._knots(delay, timestep, qs.shape[0])
        q = self._lie(qs[i], qs[j], s)
        return q[0] if one else q

    def interpolate_state(self, delay, timestep, xs):
        nq = self.model.nq
        i, j, s, one = self._knots(delay, timestep, xs.shape[0])
        q = self._lie(xs[i, :nq], xs[j, :nq], s)
        st = torch.as_tensor(s, dtype=xs.dtype).to(xs.device, non_blocking=True)[:, None]
        v = xs[j, nq:] * st + xs[i, nq:] * (1.0 - st)
        x = torch.cat([q, v], dim=1)
        return x[0] if one else x

    def interpolate_linear(self, delay, timestep, vs):
        i, j, s, one = self._knots(delay, timestep, vs.shape[0])
        st = torch.as_tensor(s, dtype=vs.dtype).to(vs.device, non_blocking=True)
        st = st.reshape((-1,) + (1,) * (vs.dim() - 1))
        out = vs[j] * st + vs[i] * (1.0 - st)
        return out[0] if one else out

    def interpolate_contacts(self, delay, timestep, cs):
        step_nb = min(max(int(math.floor(float(delay) / timestep)), 0), len(cs) - 1)
        return cs[step_nb]
