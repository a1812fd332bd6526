"""Receding-horizon MPC engine.

Port of `simple_mpc_tpu.mpc.mpc` (reference src/mpc.cpp /
include/simple-mpc/mpc.hpp): cyclic contact plan, O(1) horizon shift,
swing-foot reference regeneration (Raibert heuristic + Bézier), warm
starting, 1 solver iteration per tick, Riccati feedback gains,
WALKING/STANDING state machine.

The problem, the iterate and the solve live on the OCP's device in its
dtype; the solver runs as a batch of one scenario (B=1).  The robot data
handler, the swing references and the takeoff/land event queues are host
bookkeeping: the queues stay Python ints, which pins the reference's exact
integer semantics (tests/mpc.cpp:78-94).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..models.handler import RobotDataHandler
from ..ocp.base import index_params, roll_params, stack_params, tree_map
from ..parallel.scenarios import BatchedSolver, tile_problem
from ..solver.proxddp import ProxDDPSolver, Results, SolverSettings
from . import foot_trajectory as ft

WALKING = 0
STANDING = 1
# MOTION exists for enum parity with LocomotionType (mpc.hpp:59-63); the
# reference never transitions to it (mpc.cpp:94,384,390)
MOTION = 2


@dataclasses.dataclass
class MPCSettings:
    """Field parity with MPCSettings (mpc.hpp:29-49)."""

    swing_apex: float = 0.15
    support_force: float = 1000.0
    TOL: float = 1e-4
    mu_init: float = 1e-8
    max_iters: int = 1
    num_threads: int = 2  # kept for API parity
    T_fly: int = 80
    T_contact: int = 20
    T: int = 100
    timestep: float = 0.01
    # iteration cap for the one full solve at construction (mpc.cpp:84-91
    # hardcodes 100; benchmarks shrink it to bound setup time)
    init_max_iters: int = 100

    @classmethod
    def from_dict(cls, d: dict) -> "MPCSettings":
        from ..utils.config import settings_from_dict

        return settings_from_dict(cls, d)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class MPC:
    """Receding-horizon engine bound to one OCP formulation
    (MPC, mpc.hpp:55-197)."""

    def __init__(self, settings, ocp_handler):
        if isinstance(settings, dict):
            settings = MPCSettings.from_dict(settings)
        self.settings = settings
        self.ocp_handler = ocp_handler
        mh = ocp_handler.model_handler
        self.model_handler = mh
        self.data_handler = RobotDataHandler(mh)
        self.data_handler.update(mh.reference_state)

        # starting foot poses + base-relative feet placements (mpc.cpp:27-35)
        starting_poses: Dict[str, np.ndarray] = {}
        self.relative_feet_poses: Dict[str, np.ndarray] = {}
        base_p = _np(self.data_handler.get_base_frame_pose()[1])
        for nb, name in enumerate(mh.feet_names):
            p = _np(self.data_handler.get_foot_pose(nb)[1])
            starting_poses[name] = p
            self.relative_feet_poses[name] = p - base_p
        self.ee_names = list(mh.feet_names)

        T = ocp_handler.problem.horizon
        self.foot_trajectories = ft.FootTrajectory(
            starting_poses, settings.swing_apex, settings.T_fly,
            settings.T_contact, T)

        self.x0 = ocp_handler.get_problem_state(self.data_handler)
        self.x_reference = _np(ocp_handler.get_reference_state(0))

        # solver: full solve once at construction, then clamp to
        # settings.max_iters for the receding loop (mpc.cpp:43-91)
        self._init_solver = BatchedSolver(ProxDDPSolver(
            ocp_handler, SolverSettings(tol=settings.TOL, mu_init=settings.mu_init,
                                        max_iters=settings.init_max_iters)))
        self.solver = BatchedSolver(ProxDDPSolver(
            ocp_handler, SolverSettings(tol=settings.TOL, mu_init=settings.mu_init,
                                        max_iters=settings.max_iters)))

        # standing horizon stage-parameter pool (mpc.cpp:72-81)
        self.standing_horizon = tree_map(torch.clone, ocp_handler.problem.stage_params)

        x0 = ocp_handler._tensor(self.x0)
        xs = x0[None].expand(T + 1, x0.shape[0]).clone()
        u0 = ocp_handler.get_reference_control(0)
        us = u0[None].expand(T, u0.shape[0]).clone()
        res = self._solve(self._init_solver, xs, us, None)
        self.xs, self.us, self.Ks = res.xs, res.us, res.Ks
        self.lams = (res.lam_eq, res.lam_in, res.lam_term)
        self._last_results = res

        self.com0 = _np(self.data_handler.data.com)
        self.diverged = bool(res.diverged)
        self.now = WALKING
        self.velocity_base = np.zeros(6)

        self.contact_states: List[Dict[str, bool]] = []
        self.cycle_horizon = None  # stacked stage params, length = cycle size
        self.foot_takeoff_times: Dict[str, List[int]] = {n: [] for n in self.ee_names}
        self.foot_land_times: Dict[str, List[int]] = {n: [] for n in self.ee_names}

    def _solve(self, batched: BatchedSolver, xs, us, lams) -> Results:
        """One scenario through the batched solver; results unbatched."""
        lams_b = None if lams is None else tuple(lam[None] for lam in lams)
        res = batched.run(tile_problem(self.ocp_handler.problem, 1), xs[None],
                          us[None], lams_b)
        return Results(*(f[0] for f in res))

    # ------------------------------------------------------------------
    # Cycle horizon (mpc.cpp:103-187)
    # ------------------------------------------------------------------
    def generate_cycle_horizon(self, contact_states: List[Dict[str, bool]]):
        oh = self.ocp_handler
        T = oh.problem.horizon
        self.contact_states = list(contact_states)
        m = T // len(contact_states)
        for _ in range(m):
            self.contact_states.extend(list(contact_states))

        # contact switch timings from plan edges (mpc.cpp:114-137)
        cs = self.contact_states
        for name in self.ee_names:
            for i in range(1, len(cs)):
                if not cs[i][name] and cs[i - 1][name]:
                    self.foot_takeoff_times[name].append(i + T)
                if cs[i][name] and not cs[i - 1][name]:
                    self.foot_land_times[name].append(i + T)
            if cs[-1][name] and not cs[0][name]:
                self.foot_takeoff_times[name].append(len(cs) - 1 + T)
            if not cs[-1][name] and cs[0][name]:
                self.foot_land_times[name].append(len(cs) - 1 + T)

        # stage-parameter pool: support force split over active contacts
        # (support_force / n_active, mpc.cpp:147-158); land flag on the
        # contact-making stage w.r.t. the previous cycle state
        fs = int(oh.get_reference_force(0, self.ee_names[0]).shape[0])
        nk = len(self.ee_names)
        poses_R = np.stack([_np(self.data_handler.get_foot_pose(k)[0]) for k in range(nk)])
        poses_p = np.stack([_np(self.data_handler.get_foot_pose(k)[1]) for k in range(nk)])
        prev = {n: True for n in self.ee_names}
        params = []
        for state in cs:
            n_active = max(1, sum(1 for n in self.ee_names if state[n]))
            force = np.zeros((nk, fs))
            for k, n in enumerate(self.ee_names):
                if state[n]:
                    force[k, 2] = self.settings.support_force / n_active
            active = np.array([float(state[n]) for n in self.ee_names])
            land = np.array([float(state[n] and not prev[n]) for n in self.ee_names])
            params.append(oh.make_stage_params(active, poses_R, poses_p, force, land))
            prev = state
        self.cycle_horizon = stack_params(params)

    # ------------------------------------------------------------------
    # Receding (mpc.cpp:220-276)
    # ------------------------------------------------------------------
    def recede_with_cycle(self):
        oh = self.ocp_handler
        T = oh.problem.horizon
        walking = (self.now == WALKING
                   or oh.get_contact_support(T - 1) < len(self.ee_names))
        if walking and self.cycle_horizon is not None:
            sp = roll_params(oh.problem.stage_params, index_params(self.cycle_horizon, 0))
            oh.problem = dataclasses.replace(oh.problem, stage_params=sp)
            # rotate the cycle pool and the contact-state list
            self.cycle_horizon = tree_map(lambda x: torch.roll(x, -1, 0),
                                          self.cycle_horizon)
            self.contact_states = self.contact_states[1:] + [self.contact_states[0]]
            cs = self.contact_states
            for name in self.ee_names:
                if not cs[-1][name] and cs[-2][name]:
                    self.foot_takeoff_times[name].append(len(cs) + T)
                if cs[-1][name] and not cs[-2][name]:
                    self.foot_land_times[name].append(len(cs) + T)
            self.update_cycle_timing(False)
        else:
            sp = roll_params(oh.problem.stage_params,
                             index_params(self.standing_horizon, 0))
            oh.problem = dataclasses.replace(oh.problem, stage_params=sp)
            self.standing_horizon = tree_map(lambda x: torch.roll(x, -1, 0),
                                             self.standing_horizon)
            self.update_cycle_timing(True)

    def update_cycle_timing(self, update_only_horizon: bool):
        """Decrement pending events; in standing mode only those already
        inside the horizon (mpc.cpp:256-276)."""
        T = self.ocp_handler.problem.horizon
        for name in self.ee_names:
            for times in (self.foot_land_times[name], self.foot_takeoff_times[name]):
                for i in range(len(times)):
                    if not update_only_horizon or times[i] < T:
                        times[i] -= 1
                if times and times[0] < 0:
                    times.pop(0)

    # ------------------------------------------------------------------
    # Swing references (mpc.cpp:278-324)
    # ------------------------------------------------------------------
    def update_step_tracker_references(self):
        s = self.settings
        oh = self.ocp_handler
        T = oh.problem.horizon
        dh = self.data_handler
        base_p = _np(dh.get_base_frame_pose()[1])
        refs = []
        for nb, name in enumerate(self.ee_names):
            land_time = self.foot_land_times[name][0] if self.foot_land_times[name] else -1
            update = land_time >= s.T_fly
            # Raibert heuristic: base-relative twist arm (mpc.cpp:291-299)
            ref_p = _np(dh.get_foot_ref_pose(nb)[1])
            foot_p = _np(dh.get_foot_pose(nb)[1])
            twist = np.array([-(ref_p[1] - base_p[1]), ref_p[0] - base_p[0]])
            next_pose = np.zeros(3)
            next_pose[:2] = ref_p[:2] + (
                self.velocity_base[:2] + self.velocity_base[5] * twist
            ) * (s.T_fly + s.T_contact) * s.timestep
            next_pose[2] = foot_p[2]
            refs.append(self.foot_trajectories.update_trajectory(
                update, land_time, foot_p, next_pose, name))
        # one batched (T, nk, 3) write instead of T x nk setters
        oh.set_all_foot_translations(torch.stack(refs, dim=1))

        oh.set_reference_state(T - 1, self.x_reference)
        oh.set_velocity_base(T - 1, self.velocity_base)

        com_ref = np.mean([self.foot_trajectories.get_reference(n)[-1]
                           for n in self.ee_names], axis=0)
        com_ref[2] += self.com0[2]
        oh.update_terminal_constraint(com_ref)

    # ------------------------------------------------------------------
    # The tick (mpc.cpp:189-218)
    # ------------------------------------------------------------------
    def iterate(self, x) -> Results:
        oh = self.ocp_handler
        self.data_handler.update(x)
        self.recede_with_cycle()
        self.update_step_tracker_references()

        self.x0 = oh.get_problem_state(self.data_handler)
        x0 = oh._tensor(self.x0)
        xs = torch.cat([x0[None], self.xs[2:], self.xs[-1:]], dim=0)
        us = torch.cat([self.us[1:], self.us[-1:]], dim=0)
        oh.set_init_state(self.x0)

        lam_eq, lam_in, lam_term = self.lams
        lams = (torch.cat([lam_eq[1:], lam_eq[-1:]], dim=0),
                torch.cat([lam_in[1:], lam_in[-1:]], dim=0), lam_term)
        res = self._solve(self.solver, xs, us, lams)
        self.diverged = bool(res.diverged)
        if self.diverged:
            # Failure recovery: discard the poisoned iterate and coast one
            # tick on the pre-solve shifted plan — xs/us are the previous
            # solution shifted (finite by construction), gains stay at the
            # last good Ks, and the AL multipliers reset to zero so the next
            # tick's solve starts from a clean dual state.
            warnings.warn(
                "MPC.iterate: solver produced a non-finite iterate "
                f"(prim={float(res.prim_res):.3e}); recovering by "
                "coasting on the shifted previous plan and resetting "
                "multipliers",
                RuntimeWarning, stacklevel=2)
            res = res._replace(xs=xs, us=us, ks=torch.zeros_like(res.ks),
                               Ks=self.Ks, lam_eq=torch.zeros_like(lams[0]),
                               lam_in=torch.zeros_like(lams[1]),
                               lam_term=torch.zeros_like(lams[2]))
        self.xs, self.us, self.Ks = res.xs, res.us, res.Ks
        self.lams = (res.lam_eq, res.lam_in, res.lam_term)
        self._last_results = res
        return res

    # ------------------------------------------------------------------
    # Accessors (mpc.hpp:120-197, mpc.cpp:346-392)
    # ------------------------------------------------------------------
    def get_foot_takeoff_cycle(self, ee_name: str) -> int:
        t = self.foot_takeoff_times[ee_name]
        return t[0] if t else -1

    def get_foot_land_cycle(self, ee_name: str) -> int:
        t = self.foot_land_times[ee_name]
        return t[0] if t else -1

    def get_cycling_contact_state(self, t: int, ee_name: str) -> bool:
        return self.contact_states[t][ee_name]

    def get_state_derivative(self, t: int):
        """Continuous xdot at stage t (mpc.cpp:346-352), recomputed from the
        OCP's ODE at the solution."""
        oh = self.ocp_handler
        p = index_params(oh.problem.stage_params, t)
        return oh.state_derivative(self.xs[t], self.us[t], p)

    def switch_to_walk(self, velocity_base):
        self.now = WALKING
        self.velocity_base = np.asarray(velocity_base, np.float64)

    def switch_to_stand(self):
        self.now = STANDING
        self.velocity_base = np.zeros(6)

    def set_reference_state(self, x_ref):
        self.x_reference = _np(x_ref)

    @property
    def get_trajopt_problem(self):
        return self.ocp_handler.problem
