"""Proximal augmented-Lagrangian DDP solver, batched over scenarios.

Port of `simple_mpc_tpu.solver.proxddp` (aligator::SolverProxDDP as the
reference consumes it, mpc.cpp:43-53, 84-89, 212-217), structure-of-arrays
path only.  Every tensor carries a leading scenario axis B: xs (B, T+1, nx),
us (B, T, nu), lam_eq (B, T, n_eq), mu (B,).  Each scenario keeps its own
AL penalty, BCL tolerances, line-search choice and divergence flag, exactly
as the JAX package's `BatchedSolver` (a vmap of `run`) does.

One iteration:
  * K1/K2 `kernels.stage_linearize` (`fd_stage_linearize` for full
    dynamics, with K7 inside; for the centroidal formulation, whose 9-dim
    state lives on a vector space, `kernels.stage_route` hands this and the
    terminal and select wrappers on to csrc/centroidal.cu's and
    csrc/linesearch_centroidal.cu's kernels): the stage bundle on N = B*T
    lanes, its forward tangents along the 18 dq, 18 dv and nu du basis directions and
    the Gauss-Newton products;
  * K5 `kernels.term_linearize`: the terminal Jacobian;
  * K3 `kernels.riccati_backward`: the serial Riccati pass, or with
    `SolverSettings(parallel=True)` K6 `kernels.parallel_riccati_backward`,
    the associative-scan pass of O(log T) depth (the B=1 latency path);
  * K4 `kernels.linear_rollout` for every step size, then
    `kernels.candidate_integrate` (the Lie integrate), K1
    `kernels.stage_eval` (`fd_stage_eval`) on every candidate, and
    `kernels.line_search_select`: the terminal AL cost, the AL merit and an
    argmin per scenario, the pick, prim and the BCL multiplier / penalty
    schedule per scenario, with the chosen candidate's initial gap for the
    next iteration (`kernels.state_difference` makes the first one).
Each kernel runs its plain PyTorch twin on CPU tensors.  On the card an
iteration makes no host synchronization: every constant it needs is made
once per solver and device.

Float32 on the card needs the dtype floors of the JAX package (mu >=
sqrt(eps), reg >= 50 eps) and full-precision matmuls: TF32 products are the
card's counterpart of the reduced-precision products that NaN'd the
backward pass on the TPU, so every entry point turns them off.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..ocp.base import tree_map


def full_precision_matmuls():
    """No TF32 anywhere: float32 products run in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """(MPCSettings solver block parity: TOL, mu_init, max_iters —
    mpc.hpp:39-42).  Field meanings as in the JAX package."""

    tol: float = 1e-4
    mu_init: float = 1e-8
    max_iters: int = 100
    reg_init: float = 1e-9
    alphas: tuple = (0.0, 1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # BCL outer-loop schedule: multipliers update only when the inner loop
    # is stationary (|Qu| <= omega) and feasible (prim <= eta); stationary
    # but infeasible stiffens mu by bcl_mu_factor.
    bcl: bool = True
    bcl_alpha: float = 0.1
    bcl_mu_factor: float = 0.1
    bcl_eta_shrink: float = 0.33
    bcl_omega_init: float = 0.1
    bcl_omega_shrink: float = 0.5
    # control scaling: the step is taken in u_hat = u / u_scale ("auto" reads
    # the OCP's u_scale); returned ks/Ks are in physical units
    u_scale: Any = None
    # associative-scan Riccati backward (K6) in place of the serial pass (K3)
    parallel: bool = False


class Results(NamedTuple):
    xs: torch.Tensor  # (B, T+1, nx)
    us: torch.Tensor  # (B, T, nu)
    ks: torch.Tensor  # (B, T, nu) feedforward
    Ks: torch.Tensor  # (B, T, nu, ndx) feedback gains
    lam_eq: torch.Tensor  # (B, T, n_eq)
    lam_in: torch.Tensor  # (B, T, n_in)
    lam_term: torch.Tensor  # (B, n_term_eq)
    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
    merit: torch.Tensor  # (B,)
    mu: torch.Tensor  # (B,) BCL-evolved AL penalty
    diverged: torch.Tensor  # (B,) bool: NaN/Inf in the final iterate
    alpha: torch.Tensor  # (B,) step size the last line search accepted


class ProxDDPSolver:
    """Solver bound to one OCP formulation (static structure)."""

    def __init__(self, ocp, settings: SolverSettings = SolverSettings()):
        self.ocp = ocp
        self.settings = settings
        self.space = ocp.space
        centroidal = getattr(ocp, "centroidal", False)
        if not hasattr(ocp, "stage_eval_soa") or not (
                centroidal or getattr(self.space, "tangent_split", None) is not None):
            raise NotImplementedError(
                "the port's solver runs the SoA path only (stage_eval_soa and "
                "a q/v tangent split, or the centroidal formulation)")
        u_sc = settings.u_scale
        if isinstance(u_sc, str):
            if u_sc != "auto":
                raise ValueError(f"u_scale: expected 'auto' or array, got {u_sc!r}")
            u_sc = getattr(ocp, "u_scale", None)
        self._u_scale = None if u_sc is None else np.asarray(u_sc, np.float64)
        if self._u_scale is not None and self._u_scale.shape != (ocp.nu,):
            raise ValueError(
                f"u_scale shape {self._u_scale.shape} != (nu,) = ({ocp.nu},)")
        self._consts = {}
        # the stage kernels of the formulation (K1+K2 and K1); the kinodynamics
        # wrappers hand a centroidal OCP on to its own (kernels.stage_route)
        if getattr(ocp, "full_dynamics", False):
            self._linearize, self._eval = kernels.fd_stage_linearize, kernels.fd_stage_eval
        else:
            self._linearize, self._eval = kernels.stage_linearize, kernels.stage_eval

    def _const(self, name, values, like):
        """`values` as a tensor on `like`'s device and dtype, made once."""
        key = (name, like.dtype, like.device)
        c = self._consts.get(key)
        if c is None:
            c = torch.as_tensor(np.asarray(values, np.float64), dtype=like.dtype,
                                device=like.device)
            self._consts[key] = c
        return c

    def _su(self, like):
        if self._u_scale is None:
            return None
        return self._const("u_scale", self._u_scale, like)

    # ------------------------------------------------------------------
    # Fused trajectory evaluation
    # ------------------------------------------------------------------
    def _stage_bundle_soa(self, X, U, P, LE, LI, mu):
        """(r_all, w_all, g, h, xnext), all (comps..., N); mu (N,) per lane."""
        r, w, g, h, xnext = self.ocp.stage_eval_soa(X, U, P)
        sh = h + mu * LI
        act = (sh > 0).to(X.dtype)
        r_all = torch.cat([r, g + mu * LE, torch.where(act > 0, sh, 0.0)], dim=0)
        w_all = torch.cat([w[:, None].expand(r.shape), (1.0 / mu).expand(g.shape),
                           act / mu], dim=0)
        return r_all, w_all, g, h, xnext

    # ------------------------------------------------------------------
    # Backward pass (K3 or K6) and candidates (K4)
    # ------------------------------------------------------------------
    def _backward(self, lin, Vx_T, Vxx_T, reg):
        # with u scaling, Qu is the gradient wrt u_hat = u/s; the dual
        # residual is reported in physical units (|dL/du| = |Qu|/s) or the
        # BCL omega gate sees s-inflated values
        su = self._su(Vx_T)
        backward = (kernels.parallel_riccati_backward if self.settings.parallel
                    else kernels.riccati_backward)
        return backward(lin, Vx_T, Vxx_T, reg, dual_scale=None if su is None else 1.0 / su)

    def _candidates(self, xs, us, lin, ks, Ks, dx0, alphas):
        """Linear rollout (aligator RolloutType::LINEAR) for every alpha and
        the Lie integrate: xs (B, nA, T+1, nx), us (B, nA, T, nu)."""
        dxs, dus = kernels.linear_rollout(lin["A"], lin["B"], lin["d"], ks, Ks,
                                          dx0, alphas)
        return kernels.candidate_integrate(self, xs, us, dxs, dus)

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------
    def run(self, problems, xs, us, lams: Optional[tuple] = None, mu=None,
            max_iters: Optional[int] = None) -> Results:
        """ProxDDP iterations from a warm start for a batch of problems
        (every leaf of `problems` carries the leading scenario axis B).

        (solver_->run(problem, xs_warm, us_warm), mpc.cpp:212)
        """
        full_precision_matmuls()
        st = self.settings
        ocp = self.ocp
        nb, T = us.shape[:2]
        dtype, device = xs.dtype, xs.device
        if xs.shape != (nb, T + 1, self.space.nx):
            raise ValueError(f"xs shape {tuple(xs.shape)} != (B, T+1, nx) = "
                             f"({nb}, {T + 1}, {self.space.nx})")
        eps = torch.finfo(dtype).eps

        def full(v):
            return torch.full((nb,), float(v), dtype=dtype, device=device)

        if lams is None:
            lam_eq = torch.zeros((nb, T, ocp.n_eq), dtype=dtype, device=device)
            lam_in = torch.zeros((nb, T, ocp.n_in), dtype=dtype, device=device)
            lam_term = torch.zeros((nb, ocp.n_term_eq), dtype=dtype, device=device)
        else:
            lam_eq, lam_in, lam_term = lams
        # dtype-aware floors: f64 keeps the reference's 1e-8; f32 floors at
        # sqrt(eps) ~ 3e-4 (1/mu enters squared in the AL Hessian)
        mu_floor = math.sqrt(eps)
        if mu is None:
            mu = full(st.mu_init)
        elif torch.is_tensor(mu):
            mu = mu.to(dtype=dtype, device=device).expand(nb).clone()
        else:
            mu = full(mu)
        mu = torch.clamp(mu, min=mu_floor)
        reg = max(float(st.reg_init), 50.0 * eps)
        n_iters = st.max_iters if max_iters is None else max_iters
        alphas = self._const("alphas", st.alphas, xs)
        tol = float(st.tol)

        # the kernels read the parameters once, in (B, T, ...) layout
        sp = tree_map(torch.Tensor.contiguous, problems.stage_params)
        tp = tree_map(torch.Tensor.contiguous, problems.term_params)
        x0 = problems.x0.contiguous()

        eta = torch.clamp(mu ** st.bcl_alpha, min=tol)
        omega = full(-1.0)  # set from the first dual residual
        prim = dual_res = merit = ks = Ks = alpha = None
        # force_initial_condition; later iterations take the chosen
        # candidate's initial gap from the line search
        dx0 = kernels.state_difference(self, xs[:, 0], x0)
        for _ in range(n_iters):
            lin = self._linearize(self, sp, xs, us, lam_eq, lam_in, mu)
            Vx_T, Vxx_T = kernels.term_linearize(self, xs[:, -1], tp, lam_term, mu)
            ks, Ks, dual_res = self._backward(lin, Vx_T, Vxx_T, reg)
            xs_c, us_c = self._candidates(xs, us, lin, ks, Ks, dx0, alphas)
            costs, g_c, h_c, gap_c = self._eval(self, sp, xs_c, us_c, lam_eq, lam_in, mu)
            # the merit, argmin, pick, prim and BCL update (LANCELOT
            # schedule) per scenario
            ls = kernels.line_search_select(self, xs_c, us_c, costs, g_c, h_c, gap_c, tp, x0,
                                            lam_eq, lam_in, lam_term, mu, eta, omega,
                                            dual_res, alphas)
            xs, us, alpha, merit, prim = ls.xs, ls.us, ls.alpha, ls.merit, ls.prim
            lam_eq, lam_in, lam_term = ls.lam_eq, ls.lam_in, ls.lam_term
            mu, eta, omega, dx0 = ls.mu, ls.eta, ls.omega, ls.dx0

        bad = ~(torch.isfinite(xs).all(dim=(1, 2)) & torch.isfinite(us).all(dim=(1, 2))
                & torch.isfinite(merit))
        su = self._su(xs)
        if su is not None:  # gains back to physical u units
            ks = ks * su
            Ks = Ks * su[:, None]
        return Results(xs=xs, us=us, ks=ks, Ks=Ks, lam_eq=lam_eq, lam_in=lam_in,
                       lam_term=lam_term, prim_res=prim, dual_res=dual_res,
                       merit=merit, mu=mu, diverged=bad, alpha=alpha)
