"""Shared closed-loop runner for the port's examples.

Port of the JAX package's `examples/loop.py` (the reference examples'
control architecture, examples/go2_kinodynamics.py:206-295): the MPC tick at
100 Hz, the inner loop at 1 kHz with state/acceleration interpolation,
low-level torques from the inverse-dynamics QP (kinodynamics) or Riccati
feedback u = us[0] - K0 diff(x, xs[0]) (full dynamics), and the
in-framework rigid-contact simulator as the plant.

On the card the state, the torques and the ID's warm start stay on the
device between the ID and the simulator: an inner step launches the
ID's few torch ops around `id_assemble` and `qp_admm`, and `sim_step`,
with no host sync; the tick interpolates the targets of its inner steps in
one lane-batched call.  The host reads the state once per MPC tick
(for the log and the MPC's measurement), not at every inner step.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import soa
from ..sim.simulator import SimSettings, Simulator
from ..utils.interpolator import Interpolator


def foot_height(mh) -> float:
    """Mean height of the feet at the reference configuration."""
    q = torch.as_tensor(np.asarray(mh.reference_state[: mh.model.nq], np.float64))[:, None]
    oR, op = soa.fk_world(mh.model, q)
    _, fp = soa.frame_placements_world(mh.model, oR, op, np.asarray(mh.feet_frame_ids))
    return float(np.mean(fp[:, 2, 0].numpy()))


def run_closed_loop(mpc, mh, *, id_solver=None, friction=None, n_steps=50, n_simu=10,
                    walk_velocity=None, gait=None, log_every=10):
    """Run the MPC + inner loop + simulator closed loop on the MPC's device
    and dtype; returns the log (host numpy per tick: q, v, f, and on the
    host clock the MPC iteration `solve_time`, the tick's references and
    interpolated targets `refs_time`, and the inner steps' mean
    `inner_time`, up to the tick's one host copy).  The n_simu inner
    steps' targets are interpolated in one lane-batched call a tick.
    `id_solver=None` selects Riccati feedback (full dynamics)."""
    model = mh.model
    nq, nv = model.nq, model.nv
    interp = Interpolator(model)
    oh = mpc.ocp_handler
    device, dtype = mpc.xs.device, mpc.xs.dtype
    sim = Simulator(model, mh.feet_frame_ids,
                    SimSettings(dt=1e-3, ground_height=foot_height(mh)), device=device)
    if gait is not None:
        mpc.generate_cycle_horizon(gait)
    if walk_velocity is not None:
        mpc.switch_to_walk(np.asarray(walk_velocity))

    x = torch.as_tensor(np.asarray(mh.reference_state), dtype=dtype, device=device)
    q, v = x[:nq].clone(), x[nq:].clone()
    log = dict(q=[], v=[], f=[], solve_time=[], refs_time=[], inner_time=[])
    delays = [sub * 1e-3 for sub in range(n_simu)]

    for step in range(n_steps):
        t0 = time.perf_counter()
        mpc.iterate(torch.cat([q, v]))
        log["solve_time"].append(time.perf_counter() - t0)

        # the tick's references and the targets of all its inner steps
        t1 = time.perf_counter()
        xs = mpc.xs[:2]
        aa = torch.stack([mpc.get_state_derivative(0)[-nv:],
                          mpc.get_state_derivative(1)[-nv:]])
        contacts = oh.get_contact_state(0)
        if id_solver is not None:
            contacts_t = torch.as_tensor(np.asarray(contacts, np.float64), dtype=dtype,
                                         device=device)
            f_t = torch.stack([oh.get_reference_force(0, f) for f in mh.feet_names])
            x_i = interp.interpolate_state(delays, 0.01, xs)
            a_i = interp.interpolate_linear(delays, 0.01, aa)

        t2 = time.perf_counter()
        for sub in range(n_simu):
            if id_solver is not None:
                id_solver.set_target(x_i[sub, :nq], x_i[sub, nq:], a_i[sub], contacts_t, f_t)
                tau = id_solver.solve(step * 0.01 + delays[sub], q, v)
            else:
                dx = soa.state_difference(model, mpc.xs[0][:, None],
                                          torch.cat([q, v])[:, None])[:, 0]
                tau = mpc.us[0] - mpc.Ks[0] @ dx
            if friction is not None:
                tau = friction.compute_friction(v[6:], tau)
            q, v, fw = sim.step(q, v, tau)
        host = torch.cat([q, v, fw.reshape(-1)]).double().cpu().numpy()
        t3 = time.perf_counter()
        log["refs_time"].append(t2 - t1)
        log["inner_time"].append((t3 - t2) / n_simu)
        log["q"].append(host[:nq])
        log["v"].append(host[nq: nq + nv])
        log["f"].append(host[nq + nv:].reshape(-1, 3))
        if log_every and step % log_every == 0:
            print(f"step {step:4d}: base_z={log['q'][-1][2]:.4f} "
                  f"|v|={np.abs(log['v'][-1]).max():.3f} "
                  f"solve={log['solve_time'][-1]*1e3:.1f}ms "
                  f"inner={log['inner_time'][-1]*1e3:.2f}ms "
                  f"contacts={contacts}", flush=True)
    return log


def save_trajectory(log, path):
    """(examples/utils.py:34-85 capability) dump the rollout to .npz."""
    np.savez(path, q=np.stack(log["q"]), v=np.stack(log["v"]), f=np.stack(log["f"]),
             **{k: np.asarray(log[k]) for k in ("solve_time", "refs_time", "inner_time")})
