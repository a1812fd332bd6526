"""Dense ADMM QP solver of the 1 kHz inverse-dynamics layer: the plain
twin of kernel K8.

Port of `simple_mpc_tpu.id.qp` (`QPSolution`, `solve_qp`): one fixed-size
OSQP-form problem

    min 0.5 z'Hz + g'z   s.t.  l <= Az <= u

by over-relaxed ADMM with one Cholesky factorization and a fixed iteration
count, with leading batch axes.  Equalities are rows with |u - l| < 1e-12
and get the stiffer rho 1e3 * rho (OSQP-style); bounds of +-1e20 or +-inf
pass through the clip.  A K = H + sigma I + A' diag(rho) A that is not
positive definite gives NaN, as `jnp.linalg.cholesky` does.

`kernels.qp_admm` runs this on a CPU tensor and launches the CUDA kernel
(csrc/qp.cu) on a CUDA tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver.parallel_riccati import cholesky


class QPSolution(NamedTuple):
    z: torch.Tensor  # (..., n) primal
    y: torch.Tensor  # (..., m) dual
    prim_res: torch.Tensor  # (...,) max |Az - proj(Az)|
    dual_res: torch.Tensor  # (...,)


def rho_rows(l, u, rho: float):
    """Per-row penalty: 1e3 rho on the equality rows, rho elsewhere."""
    return torch.where(torch.abs(u - l) < 1e-12, torch.full_like(l, 1e3 * rho),
                       torch.full_like(l, rho))


def solve_qp(H, g, A, l, u, iters: int = 100, rho: float = 0.1, sigma: float = 1e-6,
             alpha: float = 1.6, z0=None, y0=None) -> QPSolution:
    """Over-relaxed ADMM (OSQP scheme), `iters` fixed steps.  H (..., n, n),
    g (..., n), A (..., m, n), l, u (..., m); warm start z0 (..., n),
    y0 (..., m)."""
    n = H.shape[-1]
    rho_vec = rho_rows(l, u, rho)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    K = H + sigma * eye + (A.mT * rho_vec[..., None, :]) @ A
    L = cholesky(K)

    def mv(M, x):
        return (M @ x[..., None])[..., 0]

    x = torch.zeros_like(g) if z0 is None else z0
    zc = mv(A, x)
    y = torch.zeros_like(l) if y0 is None else y0
    for _ in range(iters):
        rhs = sigma * x - g + mv(A.mT, rho_vec * zc - y)
        x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        Ax = mv(A, x)
        Ax_rel = alpha * Ax + (1.0 - alpha) * zc
        zc_new = torch.minimum(torch.maximum(Ax_rel + y / rho_vec, l), u)
        y = y + rho_vec * (Ax_rel - zc_new)
        zc = zc_new
    Ax = mv(A, x)
    prim = torch.amax(torch.abs(Ax - torch.minimum(torch.maximum(Ax, l), u)), dim=-1)
    dual = torch.amax(torch.abs(mv(H, x) + g + mv(A.mT, y)), dim=-1)
    return QPSolution(z=x, y=y, prim_res=prim, dual_res=dual)
