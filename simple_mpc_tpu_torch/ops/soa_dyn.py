"""Unrolled SPD Cholesky factorization and solve, batch in the trailing axes.

Port of `simple_mpc_tpu.ops.soa_dyn.{chol_unrolled, chol_solve_unrolled,
solve_spd}`.  The n x n factorization is written out entry by entry, so
every torch op is elementwise over the trailing (lane) axes; the pivot is
floored at 1e-30 exactly as the JAX package does.  The plain Riccati pass
(`kernels.riccati_backward_plain`) factors its 24 x 24 Quu with these.
"""
from __future__ import annotations

import torch


def chol_unrolled(A):
    """Lower Cholesky of A (n, n, ...lanes) as a list-of-lists of lane
    tensors."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_unrolled(L, b):
    """Solve (L L^T) x = b with b (n, ...rhs/lanes); extra rhs axes
    broadcast against the lane-shaped L entries."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=0)


def solve_spd(A, b):
    """Unrolled SPD solve, A (n, n, ...), b (n, ...)."""
    return chol_solve_unrolled(chol_unrolled(A), b)
