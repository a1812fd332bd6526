"""Parallel-in-time Riccati backward pass (K6), plain PyTorch twin.

Port of `simple_mpc_tpu.solver.parallel_riccati` (`_combine`,
`_combine_batched`, `parallel_backward`), batched over a leading scenario
axis.  Each stage's control is eliminated with a Cholesky of `Quu + reg I`
(no Jacobi scaling, unlike the serial pass K3), giving an element
e = (A, b, C, eta, J) of the value-function map:

    A_e = A - B Quu^-1 Qux            b_e = d - B Quu^-1 qu
    C_e = sym(B Quu^-1 B')            J_e = sym(Qxx - Qux' Quu^-1 Qux)
    eta_e = -(qx - Qux' Quu^-1 qu)

with the terminal element (0, 0, 0, -Vx_T, Vxx_T).  The suffix composition
e_t o e_t+1 o ... o e_T gives Vxx_t = J and Vx_t = -eta in ceil(log2(T+1))
dependent levels; the gains are then recovered stage-wise.

The scan runs in Hillis-Steele order (level k composes every t with its
partner t + 2^k), the schedule of the CUDA kernel `csrc/parallel_riccati.cu`,
so the two differ by arithmetic only; JAX's `lax.associative_scan` uses
another tree and agrees to roundoff.

Failures follow the JAX functions: a Cholesky whose pivot is not positive
(`jnp.linalg.cholesky`, which symmetrizes its input first) gives a factor of
NaN, and so does a singular solve; `*_ex` keeps both free of host syncs.
"""
from __future__ import annotations

import torch


def _sym(M):
    return 0.5 * (M + M.mT)


def _nan_where(info, X):
    return torch.where((info == 0).view(info.shape + (1,) * 2), X, torch.nan)


def cholesky(M):
    """Lower factor of sym(M); all NaN where M is not positive definite."""
    L, info = torch.linalg.cholesky_ex(_sym(M))
    return _nan_where(info, L)


def solve(M, R):
    """M^-1 R by LU with partial pivoting; all NaN where M is singular."""
    X, info = torch.linalg.solve_ex(M, R)
    return _nan_where(info, X)


def combine(e1, e2):
    """Compose the earlier element e1 with the later (suffix) element e2
    (JAX `_combine`); leaves with any leading batch axes."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    M = solve(eye + C1 @ J2, torch.cat(
        [A1, (b1 + (C1 @ eta2[..., None])[..., 0])[..., None], C1], dim=-1))
    A12 = A2 @ M[..., :n]
    b12 = (A2 @ M[..., n:n + 1])[..., 0] + b2
    C12 = _sym(A2 @ M[..., n + 1:] @ A2.mT + C2)
    N = solve(eye + J2 @ C1, torch.cat(
        [(eta2 - (J2 @ b1[..., None])[..., 0])[..., None], J2 @ A1], dim=-1))
    eta12 = (A1.mT @ N[..., :1])[..., 0] + eta1
    J12 = _sym(A1.mT @ N[..., 1:] + J1)
    return A12, b12, C12, eta12, J12


def suffix_scan(elems):
    """Suffix composition along axis 1 of (B, n, ...) element leaves in
    Hillis-Steele order: after the level of offset 2^k, entry t holds
    e_t o ... o e_min(t + 2^(k+1) - 1, n-1)."""
    n = elems[0].shape[1]
    off = 1
    while off < n:
        new = combine(tuple(e[:, : n - off] for e in elems),
                      tuple(e[:, off:] for e in elems))
        elems = tuple(torch.cat([a, e[:, n - off:]], dim=1) for a, e in zip(new, elems))
        off *= 2
    return elems


def eliminate(lin, Vx_T, Vxx_T, reg):
    """The T stage elements and the terminal one, leaves (B, T+1, ...)."""
    A, B, d = lin["A"], lin["B"], lin["d"]
    qx, qu, Qxx, Quu, Qux = lin["qx"], lin["qu"], lin["Qxx"], lin["Quu"], lin["Qux"]
    nx, nu = A.shape[-1], B.shape[-1]
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    Lq = cholesky(Quu + reg * eye)
    sol = torch.cholesky_solve(torch.cat([Qux, qu[..., None], B.mT], dim=-1), Lq)
    Ui_Qux, Ui_qu, Ui_Bt = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
    Ae = A - B @ Ui_Qux
    be = d - (B @ Ui_qu[..., None])[..., 0]
    Ce = _sym(B @ Ui_Bt)
    Je = _sym(Qxx - Qux.mT @ Ui_Qux)
    etae = -(qx - (Ui_Qux.mT @ qu[..., None])[..., 0])
    zm = torch.zeros_like(Vxx_T)[:, None]
    zv = torch.zeros_like(Vx_T)[:, None]
    return (torch.cat([Ae, zm], 1), torch.cat([be, zv], 1), torch.cat([Ce, zm], 1),
            torch.cat([etae, -Vx_T[:, None]], 1), torch.cat([Je, Vxx_T[:, None]], 1))


def gains(lin, S1, v1, reg):
    """Stage-wise gains from the next value function (S1, v1) (B, T, ...).
    Returns ks (B,T,nu), Ks (B,T,nu,nx), Qus (B,T,nu)."""
    A, B = lin["A"], lin["B"]
    nu = B.shape[-1]
    Vx_g = v1 + (S1 @ lin["d"][..., None])[..., 0]
    Qu_hat = lin["qu"] + (B.mT @ Vx_g[..., None])[..., 0]
    BtS = B.mT @ S1
    Qux_hat = lin["Qux"] + BtS @ A
    Quu_hat = lin["Quu"] + BtS @ B + reg * torch.eye(nu, dtype=B.dtype, device=B.device)
    kK = torch.cholesky_solve(torch.cat([Qu_hat[..., None], Qux_hat], dim=-1),
                              cholesky(Quu_hat))
    return -kK[..., 0], -kK[..., 1:], Qu_hat


def parallel_backward(lin, Vx_T, Vxx_T, reg: float):
    """Plain twin of K6.  lin: A (B,T,nx,nx), B (B,T,nx,nu), d, qx (B,T,nx),
    qu (B,T,nu), Qxx, Quu, Qux; Vx_T (B,nx), Vxx_T (B,nx,nx).  Returns ks
    (B,T,nu), Ks (B,T,nu,nx) and Qus (B,T,nu), the contract of
    `kernels.riccati_backward_plain`."""
    _, _, _, eta, J = suffix_scan(eliminate(lin, Vx_T, Vxx_T, reg))
    return gains(lin, J[:, 1:], -eta[:, 1:], reg)
