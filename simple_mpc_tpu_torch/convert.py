"""Carry problems and solver iterates between numpy and the port.

The JAX package's `Problem` leaves and `Results`, taken as numpy arrays,
become the port's tensors and back.  This is how the same problem and the
same warm start are fed to both packages (the port itself never imports
the JAX package).
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


def problem_from_numpy(ocp, stage_params, term_params, x0, device,
                       dtype=torch.float64) -> Problem:
    """The port's Problem for `ocp` from the JAX package's stage and
    terminal parameter NamedTuples (any objects with the same field names
    whose leaves convert with numpy.asarray) and x0.  Leading batch axes are
    kept as they are."""
    def conv(cls, src):
        return cls._make(_tensor(getattr(src, f), device, dtype)
                         for f in cls._fields)

    return Problem(x0=_tensor(x0, device, dtype),
                   stage_params=conv(ocp.stage_params_type, stage_params),
                   term_params=conv(ocp.term_params_type, term_params))


def lams_from_numpy(lam_eq, lam_in, lam_term, device, dtype=torch.float64):
    """(lam_eq, lam_in, lam_term) multiplier tensors for a warm start."""
    return tuple(_tensor(a, device, dtype) for a in (lam_eq, lam_in, lam_term))


def results_to_numpy(res) -> dict:
    """Every field of a port `Results` as a numpy array (host copy)."""
    return {k: np.asarray(v.detach().cpu().numpy()) if torch.is_tensor(v)
            else np.asarray(v) for k, v in res._asdict().items()}
