"""Fused receding-horizon tick: the whole `MPC.iterate` as device work.

Port of `simple_mpc_tpu.mpc.fused` (FusedMPC).  Everything the host engine
keeps as Python state is a carry of tensors on the problem's device:

  * the problem's stacked stage params and the cyclic and standing
    stage-parameter pools (array rolls);
  * the contact plan as an (L, nk) float array, rolled in lockstep;
  * the takeoff/land event queues as fixed-width int32 arrays with an EMPTY
    sentinel, kept sorted, with the host engine's exact integer semantics;
  * the swing-foot Bezier endpoints;
  * the warm start xs/us and the AL multipliers.

One `step(carry, x_measured)` = kernel K9 (`kernels.tick_refs`: measured
FK, walking, queue ticks, Raibert footsteps, swing references) + the rolls
and reference writes (torch copies) + the warm-start shift + one ProxDDP
iteration.  `step_batched` advances B independent engines, every carry
leaf with a leading scenario axis; `walking` is decided per scenario.
`step_donated` / `step_batched_donated` write the new carry into the
passed carry's tensors, so a loop keeps one set of buffers (the JAX
package's donated carry).  The tick makes no host synchronization, so a
CUDA graph can capture it.

As in the JAX tick, the AL penalty restarts at mu_init every tick and
there is no divergence recovery (the host `MPC` keeps its own).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels import EMPTY, queue_tick
from ..ocp.base import Problem, tree_map
from ..solver.proxddp import Results
from .mpc import MPC, STANDING, WALKING

QMAX = 8  # max pending events per foot (>= ceil((T+L)/cycle) in practice)


class MPCCarry(NamedTuple):
    """Device-resident receding-horizon state (everything MPC mutates per
    tick); `step_batched` takes every leaf with a leading scenario axis."""

    stage_params: Any  # problem stage params, leaves (T, ...)
    term_params: Any
    x0: torch.Tensor
    cycle_params: Any  # cyclic pool, leaves (L, ...)
    standing_params: Any  # standing pool, leaves (T, ...)
    plan: torch.Tensor  # (L, nk) contact plan, rolled with cycle_params
    takeoff: torch.Tensor  # (nk, QMAX) int32 event queues (EMPTY-padded)
    land: torch.Tensor  # (nk, QMAX)
    p_init: torch.Tensor  # (nk, 3) swing Bezier endpoints
    p_final: torch.Tensor  # (nk, 3)
    xs: torch.Tensor  # (T+1, nx) warm start
    us: torch.Tensor  # (T, nu)
    lam_eq: torch.Tensor
    lam_in: torch.Tensor
    lam_term: torch.Tensor
    x_reference: torch.Tensor  # (nx,)
    velocity_base: torch.Tensor  # (6,)
    com0_z: torch.Tensor  # ()
    now: torch.Tensor  # () int32 state machine (WALKING/STANDING/MOTION)


def _write_into(dst, src):
    """Copy every leaf of `src` into the tensor of `dst` (same tree) and
    return `dst`; a leaf that is already the destination is skipped."""
    def write(d, s):
        if s is not d:
            d.copy_(s)
        return d

    return tree_map(write, dst, src)


def _queue_from_list(times):
    out = np.full(QMAX, EMPTY, np.int32)
    out[: len(times)] = times
    return out


class FusedMPC:
    """Receding-horizon engine sharing all semantics with the host `MPC`
    (which remains the parity oracle)."""

    def __init__(self, mpc: MPC):
        if mpc.cycle_horizon is None:
            raise ValueError("call mpc.generate_cycle_horizon(...) first")
        self.ocp = mpc.ocp_handler
        self.solver = mpc.solver.solver
        self.settings = mpc.settings
        mh = mpc.model_handler
        self.model = mh.model
        self.nk = mh.n_feet
        self.T = self.ocp.problem.horizon
        # frames of the tick's kinematics, in kernels.tick_refs' order
        self.frame_ids = (list(mh.feet_frame_ids) + list(mh.feet_ref_frame_ids)
                          + [mh.base_frame_id])

    _queue_tick = staticmethod(queue_tick)

    # ------------------------------------------------------------------
    # Carry construction from the host engine
    # ------------------------------------------------------------------
    def make_carry(self, mpc: MPC) -> MPCCarry:
        oh = mpc.ocp_handler
        names = mpc.ee_names
        dev = oh.device

        def ints(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        plan = np.array([[float(s[n]) for n in names] for s in mpc.contact_states])
        takeoff = np.stack([_queue_from_list(mpc.foot_takeoff_times[n]) for n in names])
        land = np.stack([_queue_from_list(mpc.foot_land_times[n]) for n in names])
        lam_eq, lam_in, lam_term = mpc.lams
        # the carry owns its tensors: the host engine updates some in place
        return tree_map(torch.clone, MPCCarry(
            stage_params=oh.problem.stage_params, term_params=oh.problem.term_params,
            x0=oh.problem.x0, cycle_params=mpc.cycle_horizon,
            standing_params=mpc.standing_horizon,
            plan=oh._tensor(plan), takeoff=ints(takeoff), land=ints(land),
            p_init=oh._tensor(mpc.foot_trajectories.p_init),
            p_final=oh._tensor(mpc.foot_trajectories.p_final),
            xs=mpc.xs, us=mpc.us, lam_eq=lam_eq, lam_in=lam_in, lam_term=lam_term,
            x_reference=oh._tensor(mpc.x_reference),
            velocity_base=oh._tensor(mpc.velocity_base),
            com0_z=oh._tensor(mpc.com0[2]), now=ints(mpc.now)))

    @staticmethod
    def tile_carry(carry: MPCCarry, batch: int) -> MPCCarry:
        """Replicate a carry to a leading (B, ...) scenario batch for
        step_batched (independent engines; perturb x0/xs per scenario for
        distinct rollouts)."""
        return tree_map(lambda a: a[None].expand((batch,) + a.shape).contiguous(), carry)

    def switch_to_walk(self, carry: MPCCarry, velocity_base) -> MPCCarry:
        vb = torch.as_tensor(np.asarray(velocity_base, np.float64),
                             dtype=carry.velocity_base.dtype,
                             device=carry.velocity_base.device)
        return carry._replace(now=torch.full_like(carry.now, WALKING),
                              velocity_base=vb.expand(carry.velocity_base.shape).clone())

    def switch_to_stand(self, carry: MPCCarry) -> MPCCarry:
        return carry._replace(now=torch.full_like(carry.now, STANDING),
                              velocity_base=torch.zeros_like(carry.velocity_base))

    # ------------------------------------------------------------------
    # One fused tick, scenario axis leading every leaf
    # ------------------------------------------------------------------
    def _step(self, carry: MPCCarry, x_meas):
        ocp = self.ocp
        k = kernels.tick_refs(self, carry, x_meas)
        walking = k.walking

        def where(a, b):  # per-scenario select, walking broadcast over a
            return torch.where(walking.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        def roll(x):
            return torch.roll(x, -1, 1)

        # recedeWithCycle: the new last stage comes from the pool of the
        # scenario's branch, and only that pool rotates
        new_last = tree_map(lambda c, s: where(c[:, 0], s[:, 0]),
                            carry.cycle_params, carry.standing_params)
        sp = tree_map(lambda s, n: torch.cat([s[:, 1:], n[:, None]], dim=1),
                      carry.stage_params, new_last)
        cycle_params = tree_map(lambda x: where(roll(x), x), carry.cycle_params)
        standing_params = tree_map(lambda x: where(x, roll(x)), carry.standing_params)
        plan = where(roll(carry.plan), carry.plan)
        sp, tp = ocp.write_references(sp, carry.term_params, k.refs, carry.x_reference,
                                      carry.velocity_base, k.com_ref)

        # warm-start shift + one solver iteration (mu restarts at mu_init)
        x0 = ocp.x0_from_measurement(x_meas)
        xs = torch.cat([x0[:, None], carry.xs[:, 2:], carry.xs[:, -1:]], dim=1)
        us = torch.cat([carry.us[:, 1:], carry.us[:, -1:]], dim=1)
        lams = (torch.cat([carry.lam_eq[:, 1:], carry.lam_eq[:, -1:]], dim=1),
                torch.cat([carry.lam_in[:, 1:], carry.lam_in[:, -1:]], dim=1),
                carry.lam_term)
        res = self.solver.run(Problem(x0=x0, stage_params=sp, term_params=tp),
                              xs, us, lams, None)
        new_carry = carry._replace(
            stage_params=sp, term_params=tp, x0=x0, cycle_params=cycle_params,
            standing_params=standing_params, plan=plan, takeoff=k.takeoff,
            land=k.land, p_init=k.p_init, p_final=k.p_final, xs=res.xs, us=res.us,
            lam_eq=res.lam_eq, lam_in=res.lam_in, lam_term=res.lam_term)
        return new_carry, res

    def step_batched(self, carry: MPCCarry, x_meas):
        """B independent engines advanced by one tick: every carry leaf and
        x_meas (B, nx) lead with the scenario axis."""
        return self._step(carry, x_meas)

    def step(self, carry: MPCCarry, x_meas):
        """One tick of one engine (carry leaves without a scenario axis)."""
        c, res = self._step(tree_map(lambda a: a[None], carry), x_meas[None])
        return tree_map(lambda a: a[0], c), Results(*(f[0] for f in res))

    # Donated ticks: the carry is consumed.  The tick computes every new
    # leaf before it writes one, and the measurement is copied first, so
    # `step_donated(carry, carry.xs[1])` reads the carry it overwrites.
    def step_batched_donated(self, carry: MPCCarry, x_meas):
        """`step_batched` that writes the new carry into the passed
        carry's tensors and returns them."""
        new, res = self._step(carry, x_meas.clone())
        return _write_into(carry, new), res

    def step_donated(self, carry: MPCCarry, x_meas):
        """`step` that writes the new carry into the passed carry's
        tensors and returns them."""
        cb = tree_map(lambda a: a[None], carry)
        new, res = self._step(cb, x_meas[None].clone())
        _write_into(cb, new)
        return carry, Results(*(f[0] for f in res))

    # ------------------------------------------------------------------
    # Rollouts
    # ------------------------------------------------------------------
    def rollout(self, carry: MPCCarry, xs_meas):
        """`step` over an (N, nx) measurement stream; Results stacked over
        the ticks."""
        out = []
        for x in xs_meas:
            carry, res = self.step(carry, x)
            out.append(res)
        return carry, Results(*(torch.stack(f) for f in zip(*out)))

    def self_rollout(self, carry: MPCCarry, n_ticks: int):
        """Closed loop on the solver's own one-step prediction xs[1] as the
        next measurement, through `step_donated` on a copy of `carry` (which
        stays as it was).  Returns (carry after the last tick, (us[0],
        xs[1], prim_res) stacked over the ticks)."""
        carry = tree_map(torch.clone, carry)
        us0, xs1, prims = [], [], []
        for _ in range(n_ticks):
            carry, res = self.step_donated(carry, carry.xs[1])
            us0.append(res.us[0])
            xs1.append(res.xs[1])
            prims.append(res.prim_res)
        return carry, (torch.stack(us0), torch.stack(xs1), torch.stack(prims))
