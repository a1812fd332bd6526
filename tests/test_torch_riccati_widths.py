"""K3's plain twin against the JAX package's serial backward pass at the
five widths K3 serves, and K3's shared-memory plan.

Widths (nx, nu): Go2 kinodynamics 36/24, Go2 full dynamics 36/12, Talos
kinodynamics 56/34, Talos full dynamics 56/22, Talos centroidal 9/12.  The
JAX side is `ProxDDPSolver._backward` called unbound on a stand-in that
carries the two attributes it reads (`_u_scale=None`,
`settings=SolverSettings(scan_unroll=1)`), vmapped over the scenarios and
jitted once for the module (one XLA compile a width).  Inputs:
`testing.random_lq` (B=2, T=8, f64), and the same with the last four
controls unweighted as a swing foot's forces (zero rows and columns of
Quu, zero rows of Qux and qu, zero columns of B), where the Jacobi scale
falls to sqrt(eps).  Tolerance 1e-10 relative to the largest entry (the
24x24..34x34 solves amplify float64 roundoff by a few decades).

The tiled kernel's plan (`kernels.riccati_smem`, the mirror of
csrc/riccati.cu `riccati_plan`) must fit the H100's 232,448 B opt-in at
every width in both precisions; every width that the single-kernel K3's
plan fitted must still have a route (`kernels.riccati_route`: the tiled
kernel, else the staged one); and a width that does not fit is refused with
NotImplementedError before anything is built or launched.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from simple_mpc_tpu_torch.testing import random_lq

torch.set_num_threads(1)

WIDTHS = ((36, 24), (36, 12), (56, 34), (56, 22), (9, 12))
NB, T, REG, TOL = 2, 8, 1e-9, 1e-10
H100_OPTIN = 232_448


def _rel(a, b):
    a = np.asarray(a.detach().numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().numpy() if torch.is_tensor(b) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def jax_backward():
    import jax

    from simple_mpc_tpu.solver.proxddp import ProxDDPSolver, SolverSettings

    standin = SimpleNamespace(_u_scale=None, settings=SolverSettings(scan_unroll=1))
    return jax.jit(jax.vmap(
        lambda lin, vx, vxx: ProxDDPSolver._backward(standin, lin, vx, vxx, REG)))


def _unweighted(lin, nu):
    lin = {k: v.clone() for k, v in lin.items()}
    z = slice(nu - 4, nu)
    lin["Quu"][..., z, :] = 0
    lin["Quu"][..., :, z] = 0
    lin["Qux"][..., z, :] = 0
    lin["qu"][..., z] = 0
    lin["B"][..., :, z] = 0
    return lin


@pytest.mark.parametrize("unweighted", [False, True], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("nx,nu", WIDTHS)
def test_twin_matches_jax_backward(jax_backward, nx, nu, unweighted):
    from simple_mpc_tpu_torch import kernels

    lin, Vx, Vxx, _ = random_lq(NB, T, nx, nu, torch.float64, "cpu", seed=nx + nu)
    if unweighted:
        lin = _unweighted(lin, nu)
    ks, Ks, dual = jax_backward({k: v.numpy() for k, v in lin.items()}, Vx.numpy(),
                                Vxx.numpy())
    tks, tKs, tQus = kernels.riccati_backward_plain(lin, Vx, Vxx, REG)
    assert _rel(tks, ks) < TOL
    assert _rel(tKs, Ks) < TOL
    assert _rel(tQus.abs().amax(dim=(1, 2)), dual) < TOL
    if unweighted:
        # the unweighted controls have no gain
        assert float(tks[..., nu - 4:].abs().max()) == 0.0
        assert float(tKs[..., nu - 4:, :].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("nx,nu", WIDTHS)
def test_plan_fits_the_h100(nx, nu, dtype):
    """Every width takes the tiled kernel within the H100's opt-in shared
    memory in both precisions (Talos kinodynamics in f64: 216,544 B), on
    16-byte boundaries."""
    from simple_mpc_tpu_torch import kernels

    smem = kernels.riccati_smem(nx, nu, dtype)["tiled"]
    assert smem <= H100_OPTIN
    assert smem % 16 == 0
    assert kernels.riccati_route(nx, nu, dtype, H100_OPTIN) == "tiled"


def _single_kernel_plan(nx, nu):
    """Elements of shared memory a block of the single-kernel K3 took (one
    kernel at every width, every product staged in shared memory)."""
    nz, nr = nx + nu, nx + 1
    return (nx + nx * nx + max(2 * nx * nz, nr * (nu + 2 * nx)) + nz * nz + nz + nx + nu
            + nu * nu + nu * nr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_every_width_the_single_kernel_took_still_launches(dtype):
    """Over nx <= 128, nu <= 256: wherever the single-kernel plan fitted the
    H100's opt-in shared memory, K3 has a route (the tiled kernel for nu <=
    40 where its plan fits, else the staged one, whose plan is the single
    kernel's); wherever it did not, K3 refuses.  The tiled kernel takes
    every nu <= 40 up to nx = 54 in f64 and 88 in f32."""
    from simple_mpc_tpu_torch import kernels

    size = torch.finfo(dtype).bits // 8
    routes = {}
    for nx in range(1, 129):
        for nu in range(1, 257):
            route = kernels.riccati_route(nx, nu, dtype, H100_OPTIN)
            fits = _single_kernel_plan(nx, nu) * size <= H100_OPTIN
            assert (route is not None) == fits, (nx, nu, route)
            assert route != "tiled" or nu <= 40, (nx, nu)
            routes[nx, nu] = route
    top = 54 if dtype == torch.float64 else 88
    assert all(routes[nx, nu] == "tiled" for nx in range(1, top + 1) for nu in range(1, 41))


def test_a_width_that_does_not_fit_is_refused_before_launch(monkeypatch):
    from simple_mpc_tpu_torch import kernels

    nx, nu = 96, 48
    assert kernels.riccati_route(nx, nu, torch.float64, H100_OPTIN) is None
    assert kernels.riccati_route(nx, nu, torch.float32, H100_OPTIN) is None

    def no_build():
        raise AssertionError("the library was built for a width the plan refuses")

    monkeypatch.setattr(kernels, "smem_optin", lambda device: H100_OPTIN)
    monkeypatch.setattr(kernels, "_library", no_build)
    lin, Vx, Vxx, _ = random_lq(1, 2, nx, nu, torch.float64, "cpu")
    with pytest.raises(NotImplementedError, match="shared"):
        kernels._riccati_cuda(lin, Vx, Vxx, REG)
    # a width whose tiled plan takes exactly the opt-in maximum is taken
    lin, Vx, Vxx, _ = random_lq(1, 2, 56, 34, torch.float64, "cpu")
    monkeypatch.setattr(kernels, "smem_optin",
                        lambda device: kernels.riccati_smem(56, 34, torch.float64)["tiled"])
    with pytest.raises(AssertionError, match="built"):
        kernels._riccati_cuda(lin, Vx, Vxx, REG)
