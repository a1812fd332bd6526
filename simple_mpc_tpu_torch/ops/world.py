"""Static topology tables for the world-frame rigid-body kernels.

Port of `simple_mpc_tpu.ops.world.WorldTables` / `tables()` (numpy, derived
once per RobotModel).  The kernels in `ops/soa.py` read these as constant
tensors; `device_tables` caches one tensor copy per (dtype, device) so a
kernel call on the card never re-uploads them.

Conventions: motion/force vectors ordered [lin; ang], quaternions xyzw,
free-flyer tangents local.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.model import FREE, PRISMATIC, RobotModel


class WorldTables(NamedTuple):
    """Static (numpy) topology tables derived once per RobotModel."""

    free_base: bool
    one_dof: np.ndarray  # (n1,) joint indices of the 1-dof joints, in order
    axes: np.ndarray  # (n1, 3) local joint axes
    is_prismatic: np.ndarray  # (n1,) float flags
    qidx: np.ndarray  # (n1,) position of each 1-dof joint's angle in q
    jR: np.ndarray  # (nj, 3, 3) fixed placement in parent joint frame
    jp: np.ndarray  # (nj, 3)
    doubling: tuple  # tuple of (nj,) int arrays: ancestor pointers, world->nj
    mask: np.ndarray  # (nj, nv) dof-ancestor mask (includes own dofs)
    dof_joint: np.ndarray  # (nv,) joint carrying each dof
    masses: np.ndarray  # (nj,)
    coms: np.ndarray  # (nj, 3) body CoM in joint frame
    I_loc: np.ndarray  # (nj, 6, 6) constant local spatial inertias
    fR: np.ndarray  # (nf, 3, 3) frame placements in parent joint frame
    fp: np.ndarray  # (nf, 3)
    fparent: np.ndarray  # (nf,)
    total_mass: float


_tables_cache: dict = {}
_device_cache: dict = {}
_index_cache: dict = {}


def _spatial_inertia_np(m, c, I):
    C = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0.0]])
    E = np.eye(3)
    top = np.concatenate([m * E, -m * C], axis=1)
    bot = np.concatenate([m * C, I - m * (C @ C)], axis=1)
    return np.concatenate([top, bot], axis=0)


def dof_ancestor_mask(model: RobotModel) -> np.ndarray:
    """(nj, nv) bool: mask[j, d] = dof d is on the path from world to joint j."""
    nj, nv = model.njoints, model.nv
    mask = np.zeros((nj, nv), dtype=bool)
    for j in range(nj):
        k = j
        while k >= 0:
            nd = 6 if model.joint_types[k] == FREE else 1
            mask[j, model.idx_v[k]: model.idx_v[k] + nd] = True
            k = model.parents[k]
    return mask


def tables(model: RobotModel) -> WorldTables:
    key = id(model)
    # frames can be registered dynamically (robot-handler.cpp:39-41) —
    # rebuild when the frame count changes
    cached = _tables_cache.get(key)
    if cached is not None and cached.fparent.shape[0] == len(model.frames):
        return cached
    nj, nv = model.njoints, model.nv
    free_base = model.joint_types[0] == FREE
    for t in model.joint_types[1:]:
        if t == FREE:
            raise NotImplementedError("only a single free-flyer root joint is supported")
    one_dof = np.array(
        [j for j, t in enumerate(model.joint_types) if t != FREE], dtype=np.int64)
    axes = (np.asarray(model.axes)[one_dof]
            if len(one_dof) else np.zeros((0, 3)))
    is_prismatic = np.array(
        [1.0 if model.joint_types[j] == PRISMATIC else 0.0 for j in one_dof])
    qidx = np.array([model.idx_q[j] for j in one_dof], dtype=np.int64)

    # pointer-doubling ancestor tables; index nj = world/identity pad
    anc = np.array([p if p >= 0 else nj for p in model.parents] + [nj],
                   dtype=np.int64)
    doubling = []
    cur = anc
    while np.any(cur[:nj] != nj):
        doubling.append(cur[:nj].copy())
        cur = cur[cur]

    mask = dof_ancestor_mask(model).astype(np.float64)
    dof_joint = np.zeros(nv, dtype=np.int64)
    for j in range(nj):
        nd = 6 if model.joint_types[j] == FREE else 1
        dof_joint[model.idx_v[j]: model.idx_v[j] + nd] = j

    I_loc = np.stack([
        _spatial_inertia_np(float(model.mass[j]), np.asarray(model.com[j]),
                            np.asarray(model.inertia[j]))
        for j in range(nj)])
    fR, fp, fparent = model.frames_arrays()
    tab = WorldTables(
        free_base=free_base, one_dof=one_dof, axes=axes,
        is_prismatic=is_prismatic, qidx=qidx,
        jR=np.asarray(model.jR), jp=np.asarray(model.jp),
        doubling=tuple(doubling), mask=mask, dof_joint=dof_joint,
        masses=np.asarray(model.mass), coms=np.asarray(model.com),
        I_loc=I_loc, fR=np.asarray(fR), fp=np.asarray(fp),
        fparent=np.asarray(fparent, dtype=np.int64),
        total_mass=model.total_mass(),
    )
    _tables_cache[key] = tab
    return tab


def device_tables(model: RobotModel, dtype: torch.dtype, device) -> dict:
    """The tables of `tables(model)` as tensors on `device`: float arrays in
    `dtype`, index arrays as int64.  Cached per (tables, dtype, device), so
    a rebuilt table (new frames) gets fresh tensors."""
    tab = tables(model)
    device = torch.device(device)
    key = (id(tab), dtype, device)
    hit = _device_cache.get(key)
    if hit is not None and hit[0] is tab:
        return hit[1]

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    out = dict(
        axes=f(tab.axes), is_prismatic=f(tab.is_prismatic), qidx=i(tab.qidx),
        one_dof=i(tab.one_dof), jR=f(tab.jR), jp=f(tab.jp),
        doubling=tuple(i(a) for a in tab.doubling), mask=f(tab.mask),
        dof_joint=i(tab.dof_joint), masses=f(tab.masses), coms=f(tab.coms),
        I_loc=f(tab.I_loc), fR=f(tab.fR), fp=f(tab.fp), fparent=i(tab.fparent),
    )
    _device_cache[key] = (tab, out)
    return out


def index_tensor(ids, device) -> torch.Tensor:
    """A static index list as a cached int64 tensor on `device`."""
    device = torch.device(device)
    key = (tuple(int(i) for i in np.asarray(ids).reshape(-1)), device)
    hit = _index_cache.get(key)
    if hit is None:
        hit = torch.as_tensor(np.asarray(key[0], np.int64), device=device)
        _index_cache[key] = hit
    return hit
