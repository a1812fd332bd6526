"""State spaces: vector space and multibody phase space.

Port of `simple_mpc_tpu.ocp.spaces` (Aligator VectorSpace /
MultibodyPhaseSpace capability, reference centroidal-dynamics.cpp:31,
kinodynamics.cpp:46).  The point-wise `integrate` / `difference` take
states with any leading batch shape (..., nx) and run the SoA kernels with
those leading axes flattened into the lanes.
"""
from __future__ import annotations

import torch

from ..models.model import RobotModel
from ..ops import soa


def _lanes(x):
    """(..., n) -> (n, N) with the leading axes flattened into N lanes."""
    return x.reshape(-1, x.shape[-1]).T


class VectorSpace:
    tangent_split = None  # no cheap q/v factorization to exploit

    def __init__(self, nx: int):
        self.nx = nx
        self.ndx = nx

    def integrate(self, x, dx):
        return x + dx

    def difference(self, x1, x2):
        return x2 - x1

    def neutral(self, dtype=torch.float64, device="cpu"):
        return torch.zeros(self.nx, dtype=dtype, device=device)


class MultibodyPhaseSpace:
    """x = [q (nq); v (nv)], tangent [dq (nv); dv (nv)] (Lie on q)."""

    def __init__(self, model: RobotModel):
        self.model = model
        self.nx = model.nq + model.nv
        self.ndx = 2 * model.nv
        # tangent factorizes as [dq; dv]: the solver linearizes per block
        self.tangent_split = model.nv

    def integrate(self, x, dx):
        shape = x.shape
        out = soa.state_integrate(self.model, _lanes(x), _lanes(dx))
        return out.T.reshape(shape)

    def difference(self, x1, x2):
        x1, x2 = torch.broadcast_tensors(x1, x2)
        out = soa.state_difference(self.model, _lanes(x1), _lanes(x2))
        return out.T.reshape(x1.shape[:-1] + (self.ndx,))

    # -- trailing-batch (SoA) twins: X (nx, N), tangents (nv, N) ----------
    def integrate_parts_soa(self, X, dq, dv):
        nq = self.model.nq
        return torch.cat(
            [soa.integrate(self.model, X[:nq], dq), X[nq:] + dv], dim=0)

    def difference_soa(self, X1, X2):
        return soa.state_difference(self.model, X1, X2)
