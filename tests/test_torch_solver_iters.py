"""PyTorch port vs JAX package: the batched ProxDDP solver after 5
iterations (tests/test_torch_solver.py's problem, warm start, tolerance and
accepted-step check; its 1-iteration cases stay there).  A file of its own
so that its JAX compile runs on another worker than that file's.
"""
import numpy as np
import pytest

from test_torch_solver import FIELDS, TOL, _err, solver_runs

ITERS = (5,)


@pytest.fixture(scope="module")
def runs():
    return solver_runs(ITERS)


@pytest.mark.parametrize("n", ITERS)
@pytest.mark.parametrize("field", FIELDS)
def test_batched_solver_matches_jax(runs, n, field):
    jres, tres, _ = runs
    assert _err(tres[n][field], getattr(jres[n], field)) < TOL


@pytest.mark.parametrize("n", ITERS)
def test_same_accepted_step_and_flags(runs, n):
    jres, tres, alpha_j = runs
    np.testing.assert_array_equal(tres[n]["alpha"], alpha_j[n])
    np.testing.assert_array_equal(tres[n]["diverged"], np.asarray(jres[n].diverged))
    assert not tres[n]["diverged"].any()
