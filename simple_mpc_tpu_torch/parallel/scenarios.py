"""Scenario batches of independent MPC solves on one device.

Port of `simple_mpc_tpu.parallel.scenarios` (`tile_problem`,
`BatchedSolver.run` and `run_donated`) without a mesh: the port's
`ProxDDPSolver` is batched over a leading scenario axis already, so
`BatchedSolver` is the front-end that keeps the JAX package's API and adds
the O(1) summary.  Several cards
(the JAX package's shard_map + pmax/pmean) are later work.
"""
from __future__ import annotations

import torch

from ..ocp.base import Problem, tree_map


def tile_problem(problem: Problem, batch: int) -> Problem:
    """Replicate a Problem to a leading (B, ...) scenario batch (views, no
    copies)."""
    def tile(x):
        return x[None].expand((batch,) + tuple(x.shape))

    return Problem(x0=tile(problem.x0),
                   stage_params=tree_map(tile, problem.stage_params),
                   term_params=tree_map(tile, problem.term_params))


class BatchedSolver:
    """Scenario-batch front-end over a ProxDDPSolver: `run(problems, xs_b,
    us_b)` solves B independent problems in one batched pass."""

    def __init__(self, solver):
        self.solver = solver

    def run(self, problems: Problem, xs_b, us_b, lams_b=None):
        return self.solver.run(problems, xs_b, us_b, lams_b)

    def run_donated(self, problems: Problem, xs_b, us_b, lams_b):
        """Warm-loop `run` that consumes its iterate: the results are
        written into the passed xs_b, us_b and lams_b = (lam_eq, lam_in,
        lam_term), and the returned Results hold those same tensors (the
        JAX package donates the buffers to the outputs)."""
        res = self.solver.run(problems, xs_b, us_b, lams_b)
        lam_eq, lam_in, lam_term = lams_b
        for dst, src in ((xs_b, res.xs), (us_b, res.us), (lam_eq, res.lam_eq),
                         (lam_in, res.lam_in), (lam_term, res.lam_term)):
            dst.copy_(src)
        return res._replace(xs=xs_b, us=us_b, lam_eq=lam_eq, lam_in=lam_in,
                            lam_term=lam_term)

    def summary(self, results) -> dict:
        """O(1) reduction over the batch's results."""
        return dict(
            max_prim=torch.amax(results.prim_res),
            max_dual=torch.amax(results.dual_res),
            mean_merit=torch.mean(results.merit),
            any_diverged=torch.amax(results.diverged.to(torch.int32)),
        )
