"""Synthetic inputs for holding the kernels to their plain twins.

`random_lq` makes the inputs of a Riccati backward pass (K3, K6) and of the
linear rollout (K4) with the structure of the main path's: near-identity
dynamics and Gauss-Newton stage Hessians from 80 random rows, drawn with
numpy from a seed so that every device and dtype gets the same problem.
"""
from __future__ import annotations

import numpy as np
import torch


def random_lq(nb, nT, nx, nu, dtype, device, seed=0):
    """(lin, Vx_T, Vxx_T, dx0): lin holds A, B, d, qx, qu, Qxx, Quu, Qux as
    (nb, nT, ...) tensors; Vx_T (nb, nx), Vxx_T (nb, nx, nx) symmetric
    positive definite, dx0 (nb, nx)."""
    g = np.random.default_rng(seed)
    J = g.normal(size=(nb, nT, 80, nx + nu))
    H = np.einsum("btri,btrj->btij", J, J)
    q = g.normal(size=(nb, nT, nx + nu))
    M = g.normal(size=(nb, nx, nx))
    arrs = dict(A=np.eye(nx) + 0.05 * g.normal(size=(nb, nT, nx, nx)),
                B=0.1 * g.normal(size=(nb, nT, nx, nu)),
                d=0.01 * g.normal(size=(nb, nT, nx)), qx=q[..., :nx], qu=q[..., nx:],
                Qxx=H[..., :nx, :nx], Quu=H[..., nx:, nx:], Qux=H[..., nx:, :nx])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return ({k: t(v) for k, v in arrs.items()}, t(g.normal(size=(nb, nx))),
            t(np.einsum("bij,bkj->bik", M, M)), t(g.normal(size=(nb, nx))))
