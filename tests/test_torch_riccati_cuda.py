"""K3 (csrc/riccati.cu) against its plain twin on the card, at the five
widths it serves: Go2 kinodynamics (nx=36, nu=24), Go2 full dynamics
(36/12), Talos kinodynamics (56/34), Talos full dynamics (56/22) and Talos
centroidal (9/12), and at 36/28, 36/48 and 65/28, at B=128 and B=1, in f64
and f32.

Inputs: `testing.random_lq` made in f32, every odd scenario with its last
four controls unweighted as a swing foot's forces (zero rows and columns of
Quu, zero rows of Qux and qu, zero columns of B: the Jacobi scale falls to
sqrt(eps) there).  The f64 inputs are the exact upcast of the f32 ones, so
one f64 twin serves both gates: f64 within 1e-10 of the twin (max|a - b| /
max|b| on ks, Ks and Qus); f32 within ten times the f32 twin's own
distance from the f64 twin.

Needs no JAX: run it on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_riccati_cuda.py`.
"""
import pytest
import torch

from simple_mpc_tpu_torch.testing import random_lq

torch.set_num_threads(1)

# and one width for each kernel instance those leave out: the tiled kernel
# at nu=28 (its 32-wide factorization), the staged kernel at nu=48, and at
# nx=65, nu=28 the staged kernel in f64 (the tiled plan exceeds the H100's
# shared memory there) and the tiled one in f32
WIDTHS = ((36, 24), (36, 12), (56, 34), (56, 22), (9, 12), (36, 28), (36, 48), (65, 28))
NB = 128
T = 20
REG = 1e-9


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _case(nx, nu):
    lin, Vx, Vxx, _ = random_lq(NB, T, nx, nu, torch.float32, "cuda", seed=nx + nu)
    z, odd = slice(nu - 4, nu), slice(1, None, 2)
    lin["Quu"][odd, :, z, :] = 0
    lin["Quu"][odd, :, :, z] = 0
    lin["Qux"][odd, :, z, :] = 0
    lin["qu"][odd, :, z] = 0
    lin["B"][odd, :, :, z] = 0
    return {dt: ({k: v.to(dt) for k, v in lin.items()}, Vx.to(dt), Vxx.to(dt))
            for dt in (torch.float32, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("nx,nu", WIDTHS)
def test_kernel_matches_twin_at_the_widths_k3_serves(nx, nu):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from simple_mpc_tpu_torch import kernels

    data = _case(nx, nu)
    twin = {dt: kernels.riccati_backward_plain(*data[dt], REG) for dt in data}
    for dt in (torch.float64, torch.float32):
        lin, Vx, Vxx = data[dt]
        for rows in (slice(None), slice(0, 1), slice(1, 2)):
            args = ({k: v[rows].contiguous() for k, v in lin.items()},
                    Vx[rows].contiguous(), Vxx[rows].contiguous())
            n = kernels.riccati_backward.launches
            ks, Ks, dual = kernels.riccati_backward(*args, REG)
            assert kernels.riccati_backward.launches == n + 1
            got = kernels._riccati_cuda(*args, REG)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ks) and torch.equal(got[1], Ks)
            err = max(_rel(a, b[rows]) for a, b in zip(got, twin[torch.float64]))
            if dt == torch.float64:
                assert err <= 1e-10, (nx, nu, rows, err)
            else:
                d = max(_rel(a[rows], b[rows]) for a, b in zip(twin[dt], twin[torch.float64]))
                assert err <= 10 * d, (nx, nu, rows, err, d)
