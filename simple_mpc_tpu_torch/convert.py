"""Carry problems, solver iterates, linearizations, fused-tick carries and
the inverse-dynamics state between numpy and the port.

The JAX package's `Problem` leaves, `Results`, `MPCCarry` and
`KinodynamicsID` targets and warm start, taken as numpy arrays, become the
port's tensors and back.  This is how the same
problem and the same warm start are fed to both packages (the port itself
never imports the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from .ocp.base import Problem


def _tensor(a, device, dtype):
    a = np.array(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def _field(src, f):
    return src[f] if isinstance(src, dict) else getattr(src, f)


def _params(cls, src, device, dtype):
    """A param NamedTuple `cls` from any object or dict with its fields."""
    return cls._make(_tensor(_field(src, f), device, dtype) for f in cls._fields)


def problem_from_numpy(ocp, stage_params, term_params, x0, device,
                       dtype=torch.float64) -> Problem:
    """The port's Problem for `ocp` from the JAX package's stage and
    terminal parameter NamedTuples (any objects with the same field names
    whose leaves convert with numpy.asarray) and x0: `KinoStageParams` /
    `KinoTermParams`, `FullStageParams` / `FullTermParams` or
    `CentroidalStageParams` / `CentroidalTermParams`, as the OCP's
    `stage_params_type` and `term_params_type` say.  Leading batch axes are
    kept as they are."""
    return Problem(x0=_tensor(x0, device, dtype),
                   stage_params=_params(ocp.stage_params_type, stage_params, device, dtype),
                   term_params=_params(ocp.term_params_type, term_params, device, dtype))


def lams_from_numpy(lam_eq, lam_in, lam_term, device, dtype=torch.float64):
    """(lam_eq, lam_in, lam_term) multiplier tensors for a warm start."""
    return tuple(_tensor(a, device, dtype) for a in (lam_eq, lam_in, lam_term))


def lin_from_numpy(lin, device, dtype=torch.float64) -> dict:
    """The port's LQ data (A, B, d, qx, qu, Qxx, Quu, Qux with leading
    (B, T)) from a linearization dict with those keys, such as the JAX
    solver's `_linearize_traj_soa`, as numpy arrays with leading (T,) (one
    scenario, given a batch axis of 1) or (B, T)."""
    one = np.ndim(lin["A"]) == 3
    return {k: _tensor(np.asarray(lin[k])[None] if one else lin[k], device, dtype)
            for k in ("A", "B", "d", "qx", "qu", "Qxx", "Quu", "Qux")}


def results_to_numpy(res) -> dict:
    """Every field of a port `Results` as a numpy array (host copy)."""
    return {k: np.asarray(v.detach().cpu().numpy()) if torch.is_tensor(v)
            else np.asarray(v) for k, v in res._asdict().items()}


def carry_from_numpy(ocp, carry, device, dtype=torch.float64):
    """The port's `MPCCarry` from a carry with the same field names (the JAX
    package's `MPCCarry`, or `carry_to_numpy`'s dict): floating leaves in
    `dtype`, the int32 queues and state machine kept as they are.  Leading
    batch axes are kept."""
    from .mpc.fused import MPCCarry

    leaves = {}
    for f in MPCCarry._fields:
        v = _field(carry, f)
        if f in ("stage_params", "cycle_params", "standing_params"):
            leaves[f] = _params(ocp.stage_params_type, v, device, dtype)
        elif f == "term_params":
            leaves[f] = _params(ocp.term_params_type, v, device, dtype)
        else:
            leaves[f] = _tensor(v, device, dtype)
    return MPCCarry(**leaves)


def carry_to_numpy(carry) -> dict:
    """Every leaf of a port `MPCCarry` as numpy (param tuples as dicts)."""
    def host(a):
        return np.asarray(a.detach().cpu().numpy())

    out = {}
    for f, v in carry._asdict().items():
        out[f] = ({k: host(a) for k, a in v._asdict().items()}
                  if hasattr(v, "_fields") else host(v))
    return out


ID_TARGETS = ("q_t", "v_t", "a_t", "contacts", "f_t")
# a CentroidalID's targets beyond the kinodynamics ones
CID_TARGETS = ("com_t", "com_v_t", "feet_p_t", "feet_R_t", "feet_v_t")


def id_state_from_numpy(idsolver, targets, warm=None):
    """Set a port `KinodynamicsID`'s (or `CentroidalID`'s) targets and QP
    warm start from the JAX package's `_targets` (a dict with the
    `ID_TARGETS` keys, and the `CID_TARGETS` ones for a CentroidalID, one
    robot) and `_qp_warm` (None, or (z, y) of one robot), as numpy arrays,
    in the port ID's device and dtype."""
    dev, dt = idsolver.device, idsolver.dtype
    keys = ID_TARGETS + (CID_TARGETS if "com_t" in idsolver._targets else ())
    idsolver._targets.update({k: _tensor(targets[k], dev, dt) for k in keys})
    idsolver._qp_warm = None if warm is None else tuple(_tensor(a, dev, dt)[None]
                                                        for a in warm)
