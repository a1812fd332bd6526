"""Canonical robot + OCP configurations mirroring the reference examples.

Port of the Go2 kinodynamics and full-dynamics entries and the Talos
kinodynamics and centroidal entries of `simple_mpc_tpu.configs` (the settings dictionaries
of examples/go2_kinodynamics.py, examples/go2_fulldynamics.py and the
Talos parity fixture), the Talos full-dynamics settings of
examples/talos_fulldynamics.py, the fused-tick engines of the JAX package's
bench (`bench.py` `_make_fused`), and fused-tick engines of the Talos
kinodynamics and Go2 full-dynamics examples.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import robots
from .models.handler import RobotModelHandler

GO2_FEET = ["FL_foot", "FR_foot", "RL_foot", "RR_foot"]
TALOS_FEET = ["left_sole_link", "right_sole_link"]
TALOS_CONTACT_POINTS = np.array(
    [[0.1, 0.075, 0.0], [0.1, -0.075, 0.0], [-0.1, 0.075, 0.0], [-0.1, -0.075, 0.0]]
)


def go2_handler() -> RobotModelHandler:
    model = robots.load_go2()
    mh = RobotModelHandler(model, "standing", "base")
    for f in GO2_FEET:
        mh.add_point_foot(f, "base")
    return mh


def talos_handler() -> RobotModelHandler:
    model = robots.load_talos()
    mh = RobotModelHandler(model, "half_sitting", "base_link")
    for f in TALOS_FEET:
        mh.add_quad_foot(f, "base_link", TALOS_CONTACT_POINTS)
    return mh


def go2_kinodynamics_config(mh: RobotModelHandler) -> dict:
    """examples/go2_kinodynamics.py:40-86 settings."""
    nv = mh.model.nv
    w_x = np.array([0, 0, 100, 10, 10, 0] + [1, 1, 1] * 4
                   + [10, 10, 10, 10, 10, 10] + [0.1, 0.1, 0.1] * 4)
    w_u = np.concatenate([np.tile([0.01, 0.01, 0.01], 4), np.ones(nv - 6) * 1e-5])
    return dict(
        timestep=0.01, w_x=w_x, w_u=w_u,
        w_cent=np.concatenate([[0.0, 0.0, 1.0], [0.1, 0.1, 10.0]]),
        w_centder=np.concatenate([np.zeros(3), np.ones(3) * 0.1]),
        gravity=np.array([0, 0, -9.81]), force_size=3,
        w_frame=np.ones(3) * 2000.0,
        qmin=mh.model.lower_limit[7:], qmax=mh.model.upper_limit[7:],
        mu=0.8, Lfoot=0.01, Wfoot=0.01,
        kinematics_limits=True, force_cone=False, land_cstr=False,
    )


def make_go2_kinodynamics(T: int = 100, device="cuda", dtype=torch.float64):
    """Flagship configuration: Go2 kinodynamic MPC, horizon T, with its
    problem built on `device` in `dtype`."""
    from .ocp.kinodynamics import KinodynamicsOCP

    mh = go2_handler()
    ocp = KinodynamicsOCP(go2_kinodynamics_config(mh), mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 3, -9.81, False)
    return ocp, mh, x0


def talos_kinodynamics_config(mh: RobotModelHandler) -> dict:
    """examples/talos_kinodynamics.py:49-107 settings (6D quad feet) on the
    22-actuated-joint reduced Talos.  Per-group weights follow the
    reference's grouping and joint order exactly
    (talos_kinodynamics.py:49-66): [base, legs(2x6), torso(2), arms(2x4)]."""
    model = mh.model
    nv = model.nv
    w_basepos = [0, 0, 1000, 1000, 1000, 1000]
    w_legpos = [0.1] * 6
    w_torsopos = [1, 1000]
    w_armpos = [1, 1, 10, 10]
    w_basevel = [10.0] * 6
    w_legvel = [1.0] * 6
    w_torsovel = [0.1, 100]
    w_armvel = [10.0] * 4
    w_x = np.array(w_basepos + w_legpos * 2 + w_torsopos + w_armpos * 2
                   + w_basevel + w_legvel * 2 + w_torsovel + w_armvel * 2) * 10.0
    w_linforce = np.array([0.001, 0.001, 0.01])
    w_angforce = np.ones(3) * 0.1
    w_u = np.concatenate(
        [w_linforce, w_angforce, w_linforce, w_angforce,
         np.ones(nv - 6) * 1e-4])
    return dict(
        timestep=0.01,
        w_x=w_x, w_u=w_u,
        w_cent=np.concatenate([[0.0, 0.0, 1.0], [0.1, 0.1, 10.0]]),
        w_centder=np.concatenate([np.zeros(3), np.ones(3) * 0.1]),
        w_frame=np.ones(6) * 100000.0, gravity=np.array([0, 0, -9.81]),
        force_size=6, qmin=model.lower_limit[7:], qmax=model.upper_limit[7:],
        kinematics_limits=True, force_cone=False, land_cstr=False,
        mu=0.8, Lfoot=0.1, Wfoot=0.075,
    )


def make_talos_kinodynamics(T: int = 100, device="cuda", dtype=torch.float64,
                            force_cone=False):
    """Talos kinodynamics (23 joints, two 6D quad feet), horizon T, at
    half_sitting, with its problem built on `device` in `dtype`: the
    problem of the committed fixture `talos_kinodynamics_T100.npz`
    (tools/make_parity_fixtures.py `build_ocp("talos")`).  `force_cone`
    switches on the two 17-row wrench cones (off in the fixture)."""
    from .ocp.kinodynamics import KinodynamicsOCP

    mh = talos_handler()
    cfg = talos_kinodynamics_config(mh)
    cfg["force_cone"] = force_cone
    ocp = KinodynamicsOCP(cfg, mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 6, -9.81, False)
    return ocp, mh, x0


def go2_fulldynamics_config(mh: RobotModelHandler, force_cone=True) -> dict:
    """examples/go2_fulldynamics.py settings: 78 cost rows, 68 inequality
    rows (24 torque box, 24 joint box, 20 friction pyramid)."""
    model = mh.model
    nv = model.nv
    w_x = np.array([0, 0, 10, 10, 10, 0] + [1, 1, 1] * 4
                   + [10, 10, 10, 10, 10, 10] + [0.1, 0.1, 0.1] * 4)
    return dict(
        timestep=0.01, w_x=w_x, w_u=np.ones(nv - 6) * 1e-4,
        w_cent=np.concatenate([np.zeros(3), [0.1, 0.1, 0.1]]),
        w_forces=np.ones(3) * 1e-4, w_frame=np.ones(3) * 1000.0,
        gravity=np.array([0, 0, -9.81]), force_size=3,
        Kp_correction=np.zeros(3), Kd_correction=np.zeros(3),
        umin=-model.effort_limit[6:], umax=model.effort_limit[6:],
        qmin=model.lower_limit[7:], qmax=model.upper_limit[7:],
        mu=0.8, Lfoot=0.01, Wfoot=0.01,
        torque_limits=True, kinematics_limits=True,
        force_cone=force_cone, land_cstr=False,
    )


def make_go2_fulldynamics(T: int = 100, device="cuda", dtype=torch.float64,
                          force_cone=True):
    """Go2 full dynamics (joint torques, rigid point contacts), horizon T,
    with its problem built on `device` in `dtype`."""
    from .ocp.fulldynamics import FullDynamicsOCP

    mh = go2_handler()
    ocp = FullDynamicsOCP(go2_fulldynamics_config(mh, force_cone), mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 3, -9.81, False)
    return ocp, mh, x0


def talos_fulldynamics_config(mh: RobotModelHandler) -> dict:
    """examples/talos_fulldynamics.py:18-34 settings: joint torques on the
    22 actuated joints, two 6D quad feet, torque and joint limits on, the
    wrench cones and landing constraints off, no Baumgarte correction."""
    model = mh.model
    nv = model.nv
    w_x = np.array([0, 0, 100, 100, 100, 100] + [10.0] * (nv - 6)
                   + [10, 10, 10, 100, 100, 100] + [1.0] * (nv - 6))
    return dict(
        timestep=0.01, w_x=w_x, w_u=np.ones(nv - 6) * 1e-4,
        w_cent=np.concatenate([np.zeros(3), [0.1, 0.1, 1.0]]),
        w_forces=np.ones(6) * 1e-5, w_frame=np.ones(6) * 1000.0,
        gravity=np.array([0, 0, -9.81]), force_size=6,
        Kp_correction=np.zeros(6), Kd_correction=np.zeros(6),
        umin=-model.effort_limit[6:], umax=model.effort_limit[6:],
        qmin=model.lower_limit[7:], qmax=model.upper_limit[7:],
        mu=0.8, Lfoot=0.1, Wfoot=0.075,
        torque_limits=True, kinematics_limits=True,
        force_cone=False, land_cstr=False,
    )


def make_talos_fulldynamics(T: int = 100, device="cuda", dtype=torch.float64,
                            force_cone=False):
    """Talos full dynamics (23 joints, two 6D quad feet, nq=29, nv=28, 22
    joint torques), horizon T, at half_sitting, with its problem built on
    `device` in `dtype` as examples/talos_fulldynamics.py `main` builds it.
    `force_cone` switches on the two 17-row wrench cones (off in the
    example)."""
    from .ocp.fulldynamics import FullDynamicsOCP

    mh = talos_handler()
    cfg = talos_fulldynamics_config(mh)
    cfg["force_cone"] = force_cone
    ocp = FullDynamicsOCP(cfg, mh, device, dtype)
    x0 = np.asarray(mh.reference_state)
    ocp.create_problem(x0, T, 6, -9.81, False)
    return ocp, mh, x0


def talos_centroidal_config(mh: RobotModelHandler, force_size: int = 6) -> dict:
    """examples/talos_centroidal.py settings (JAX `configs.talos_centroidal_config`);
    `force_size` 3 gives each foot a point force (w_u sized to match)."""
    return dict(
        timestep=0.01, w_u=np.ones(mh.n_feet * force_size) * 1e-4, w_com=np.zeros(3),
        w_linear_mom=np.diag([0.01, 0.01, 100.0]),
        w_angular_mom=np.diag([0.1, 0.1, 1000.0]),
        w_linear_acc=0.01 * np.eye(3), w_angular_acc=0.01 * np.eye(3),
        gravity=np.array([0, 0, -9.81]),
        mu=0.8, Lfoot=0.1, Wfoot=0.075, force_size=force_size,
    )


def make_talos_centroidal(T: int = 100, device="cuda", dtype=torch.float64, force_size=6):
    """Talos centroidal (x = [com; h_lin; h_ang], two quad feet with 6D
    wrenches, or point forces with `force_size=3`), horizon T, standing at
    half_sitting, with its problem built on `device` in `dtype` as
    examples/talos_centroidal.py builds it.  Returns (ocp, mh, x0), x0 the
    9-dim centroidal state."""
    from .models.handler import RobotDataHandler
    from .ocp.centroidal import CentroidalOCP

    mh = talos_handler()
    ocp = CentroidalOCP(talos_centroidal_config(mh, force_size), mh, device, dtype)
    x0 = RobotDataHandler(mh).get_centroidal_state().numpy()
    ocp.create_problem(x0, T, force_size, -9.81, False)
    return ocp, mh, x0


def _walking(mpc, plan, walk, mu_init, parallel):
    """`mpc` with its tick solver one iteration with `mu_init`, serial
    Riccati (K3) or with `parallel` the associative scan (K6), the cyclic
    `plan`, walking at `walk`."""
    from .parallel import BatchedSolver
    from .solver.proxddp import ProxDDPSolver, SolverSettings

    mpc.solver = BatchedSolver(ProxDDPSolver(mpc.ocp_handler, SolverSettings(
        tol=mpc.settings.TOL, mu_init=mu_init, max_iters=1, parallel=parallel)))
    mpc.generate_cycle_horizon(plan)
    mpc.switch_to_walk(np.asarray(walk, np.float64))
    return mpc


def _fused(mpc):
    from .mpc import FusedMPC

    fused = FusedMPC(mpc)
    return fused, fused.make_carry(mpc)


def make_go2_fused(T: int = 100, device="cuda", dtype=torch.float32, parallel=False):
    """The fused-tick engine of the JAX package's bench (`bench.py:277-311`):
    Go2 kinodynamics, trot 10/30/10/30 at 0.2 m/s, apex 0.15 m, one
    iteration a tick with mu_init 1e-6, init_max_iters 2.  `parallel=False`
    is the throughput configuration (serial Riccati, K3); `parallel=True` the
    B=1 latency configuration (associative-scan Riccati, K6), at full
    precision (the bench's bfloat16 tangents are not ported).  Returns
    (fused, carry)."""
    from .mpc import MPC, MPCSettings

    ocp, mh, _ = make_go2_kinodynamics(T, device=device, dtype=dtype)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, max_iters=1, T_fly=30,
                          T_contact=10, swing_apex=0.15, init_max_iters=2), ocp)
    FL, FR, RL, RR = mh.feet_names
    allc = {n: True for n in mh.feet_names}
    plan = ([allc] * 10 + [{FL: True, FR: False, RL: False, RR: True}] * 30
            + [allc] * 10 + [{FL: False, FR: True, RL: True, RR: False}] * 30)
    return _fused(_walking(mpc, plan, [0.2, 0, 0, 0, 0, 0], 1e-6, parallel))


def talos_mpc(T: int = 100, device="cuda", dtype=torch.float32, parallel=False, gait=None,
              **mpc_settings):
    """The host MPC of `make_talos_fused`, walking: Talos kinodynamics (23
    joints, two 6D quad feet) with the weights, MPCSettings (T_fly 80,
    T_contact 20, apex 0.1 m, mu_init 1e-8), biped gait and 0.1 m/s walk of
    the port's examples/talos_kinodynamics.py, one iteration a tick, serial
    Riccati or with `parallel` K6.  `gait` (a list of {foot: in contact})
    replaces the biped gait and `mpc_settings` fields of MPCSettings (the
    first solve's `init_max_iters`, 100 by default)."""
    from .examples.talos_kinodynamics import (MPC_SETTINGS, WALK, biped,
                                              talos_kinodynamics_config)
    from .mpc import MPC, MPCSettings
    from .ocp.kinodynamics import KinodynamicsOCP

    mh = talos_handler()
    ocp = KinodynamicsOCP(talos_kinodynamics_config(mh), mh, device, dtype)
    ocp.create_problem(np.asarray(mh.reference_state), T, 6, -9.81, False)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81,
                          **{**MPC_SETTINGS, **mpc_settings}), ocp)
    return _walking(mpc, biped(mh.feet_names) if gait is None else gait, WALK,
                    mpc.settings.mu_init, parallel)


def make_talos_fused(T: int = 100, device="cuda", dtype=torch.float32, parallel=False,
                     gait=None, **mpc_settings):
    """Talos kinodynamics on the fused tick (`talos_mpc`'s engine;
    `parallel=True` the B=1 latency configuration).  Returns (fused,
    carry)."""
    return _fused(talos_mpc(T, device, dtype, parallel, gait, **mpc_settings))


def go2_fd_mpc(T: int = 50, device="cuda", dtype=torch.float32, parallel=False,
               force_cone=False, gait=None, **mpc_settings):
    """The host MPC of `make_go2_fd_fused`, walking: Go2 full dynamics with
    the MPCSettings of examples/go2_fulldynamics.py (T_fly 30, T_contact
    10, apex 0.05 m, mu_init 1e-8) and its trot 10/30/10/30 at 0.2 m/s, one
    iteration a tick, serial Riccati or with `parallel` K6.  The friction
    pyramids are off by default: at the standing posture no force inside
    them holds the robot at rest (tests/test_torch_fulldynamics.py
    `test_pyramids_exclude_rest_at_the_standing_posture`).  `gait` and
    `mpc_settings` as in `talos_mpc`."""
    from .mpc import MPC, MPCSettings

    ocp, mh, _ = make_go2_fulldynamics(T, device=device, dtype=dtype, force_cone=force_cone)
    settings = dict(TOL=1e-4, mu_init=1e-8, max_iters=1, swing_apex=0.05, T_fly=30,
                    T_contact=10, timestep=0.01)
    mpc = MPC(MPCSettings(support_force=mh.mass * 9.81, **{**settings, **mpc_settings}), ocp)
    feet = mh.feet_names
    ds = {f: True for f in feet}
    pair_a = {f: f in ("FL_foot", "RR_foot") for f in feet}
    pair_b = {f: f in ("FR_foot", "RL_foot") for f in feet}
    trot = [ds] * 10 + [pair_a] * 30 + [ds] * 10 + [pair_b] * 30
    return _walking(mpc, trot if gait is None else gait, [0.2, 0, 0, 0, 0, 0],
                    mpc.settings.mu_init, parallel)


def make_go2_fd_fused(T: int = 50, device="cuda", dtype=torch.float32, parallel=False,
                      force_cone=False, gait=None, **mpc_settings):
    """Go2 full dynamics on the fused tick (`go2_fd_mpc`'s engine;
    `parallel=True` the B=1 latency configuration).  Returns (fused,
    carry)."""
    return _fused(go2_fd_mpc(T, device, dtype, parallel, force_cone, gait, **mpc_settings))


def talos_fd_mpc(T: int = 100, device="cuda", dtype=torch.float32, gait=None,
                 **mpc_settings):
    """The host MPC of examples/talos_fulldynamics.py (its `setup`: Talos
    full dynamics with the example's MPCSettings, T_fly 80, T_contact 20,
    apex 0.1 m, mu_init 1e-8, TOL 1e-4), walking the biped gait
    20/80/20/80 at 0.1 m/s, one iteration a tick on serial Riccati.
    `gait` and `mpc_settings` as in `talos_mpc`."""
    from .examples.talos_fulldynamics import setup
    from .examples.talos_kinodynamics import WALK, biped

    mpc, mh = setup(T, device, dtype, **mpc_settings)
    return _walking(mpc, biped(mh.feet_names) if gait is None else gait, WALK,
                    mpc.settings.mu_init, False)


def talos_centroidal_mpc(T: int = 100, device="cuda", dtype=torch.float32, gait=None,
                         **mpc_settings):
    """The host MPC of examples/talos_centroidal.py: Talos centroidal with the
    example's MPCSettings (T_fly 80, T_contact 20, apex 0.1 m, mu_init 1e-8,
    TOL 1e-4), walking the biped gait 20/80/20/80 at 0.1 m/s, one iteration
    a tick on serial Riccati.  `gait` and `mpc_settings` as in
    `talos_mpc`."""
    from .examples.talos_centroidal import setup_mpc
    from .examples.talos_kinodynamics import WALK, biped

    mpc, mh = setup_mpc(T, device, dtype, **mpc_settings)
    return _walking(mpc, biped(mh.feet_names) if gait is None else gait, WALK,
                    mpc.settings.mu_init, False)
