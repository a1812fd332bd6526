"""Hand-written CUDA kernels of the solver's and the fused tick's path, with
their plain twins.

K1+K2 `stage_linearize` (csrc/linearize.cu) replaces
`simple_mpc_tpu/solver/proxddp.py` `ProxDDPSolver._linearize_traj_soa` with
`_stage_bundle_soa` and `ocp/kinodynamics.py` `stage_eval_soa`.
K1 `stage_eval` (csrc/linearize.cu) replaces the candidate evaluation of
`ProxDDPSolver._eval_traj`.
The full-dynamics stage has kernels of its own (csrc/fulldyn.cu, with K7,
the constrained dynamics of `simple_mpc_tpu/ops/soa_dyn.py`, in
csrc/fulldyn.cuh): `fd_stage_linearize` (K7 + K1 + K2), `fd_stage_eval`
(K7 + K1 on the candidates) and `fd_dynamics` (K7 alone, for
`FullDynamicsOCP.get_contact_forces` / `state_derivative`).
K3 `riccati_backward` (csrc/riccati.cu) replaces `ProxDDPSolver._backward`
(the serial `lax.scan` step with `ops/soa_dyn.py`
chol_unrolled/chol_solve_unrolled).
K6 `parallel_riccati_backward` (csrc/parallel_riccati.cu) replaces
`simple_mpc_tpu/solver/parallel_riccati.py` `parallel_backward`, the
associative-scan backward pass of `SolverSettings(parallel=True)`; its twin
is `solver/parallel_riccati.py`.
K4 `linear_rollout` (csrc/rollout.cu) replaces `ProxDDPSolver._candidate`'s
rollout scan; the rest of K4 is csrc/linesearch.cu: `candidate_integrate`
the Lie integrate of `_candidate`, `line_search_select` the terminal AL
cost, the merit, the argmin, the pick and the BCL update of `_run_impl`'s
iteration (`_term_al_cost`, `_merit_from`, `try_alpha`, prim and the
schedule), and `state_difference` the initial gap before the first
iteration; `wide_line_search_select` (csrc/linesearch_wide.cu) takes the
OCPs that `stage_route` sends to the wide stage kernels (the other two read
nq and nv alone and serve every model).
K5 `term_linearize` (csrc/linearize.cu) replaces
`ProxDDPSolver._linearize_term`.
The wide stage kernels `wide_stage_linearize`, `wide_stage_eval` and
`wide_term_linearize` (csrc/linearize_wide.cu over csrc/stage_wide.cuh) are
K1+K2, K1 and K5 for what csrc/linearize.cu refuses: 6D contacts, more
than 16 joints or more than 64 tangent directions (Talos kinodynamics);
`stage_route` decides, and `stage_linearize`, `stage_eval` and
`term_linearize` hand a wide OCP's CUDA tensors to them.
The wide full-dynamics kernels `wide_fd_stage_linearize`,
`wide_fd_stage_eval` and `wide_fd_dynamics` (csrc/fulldyn_wide.cu, K7 of
csrc/fulldyn_wide.cuh) are K7+K1+K2, K7+K1 and K7 for what csrc/fulldyn.cu
refuses: 6D LOCAL_WORLD_ALIGNED contacts, more than 16 joints or more than
64 tangent directions (Talos full dynamics); `stage_route` decides, and
`fd_stage_linearize`, `fd_stage_eval` and `fd_dynamics` hand such an OCP's
CUDA tensors to them; its terminal Jacobian and line-search select go to
`wide_term_linearize` and `wide_line_search_select`.
K9 `tick_refs` (csrc/tick.cu) replaces the bookkeeping of
`simple_mpc_tpu/mpc/fused.py` `FusedMPC._step` before the solve;
`wide_tick_refs` (csrc/tick_wide.cu, tick.cu compiled again over
csrc/stage_wide.cuh) takes the OCPs that `stage_route` sends to the wide
stage kernels (Talos), and `tick_refs` hands their CUDA tensors over.
K8 `qp_admm` (csrc/qp.cu) replaces `simple_mpc_tpu/id/qp.py` `solve_qp`,
the ADMM QP of the inverse-dynamics layer (twin `id/qp.py`), and
`id_assemble` (csrc/id.cu) its assembly
`simple_mpc_tpu/id/kinodynamics_id.py` `KinodynamicsID._assemble_core`.
K10 `sim_step` (csrc/sim.cu) replaces `simple_mpc_tpu/sim/simulator.py`
`Simulator.step` (twin `Simulator.step_plain`); it and `id_assemble`
include K7's device code (csrc/fulldyn.cuh).
K11 `state_derivative` (csrc/acc.cu) replaces
`simple_mpc_tpu/ocp/kinodynamics.py` `KinodynamicsOCP.state_derivative`
over `ode_acc` (twin `KinodynamicsOCP._acc_soa`).
`wide_id_assemble`, `wide_sim_step` and `wide_state_derivative`
(csrc/id_wide.cu, sim_wide.cu, acc_wide.cu: id.cu, sim.cu and acc.cu
compiled again over csrc/stage_wide.cuh) take what the Go2 units refuse:
6D contacts and up to WIDE_MAX_JOINTS joints (Talos); `body_route` and
`stage_route` decide, and `id_assemble`, `sim_step` and
`state_derivative` hand a wide model's CUDA tensors to them.
The centroidal formulation's kernels (csrc/centroidal.cu over
csrc/centroidal.cuh) replace the JAX solver's generic path over
`simple_mpc_tpu/ocp/centroidal.py`: `centroidal_stage_linearize`
(`ProxDDPSolver._linearize_stage` with `_stage_bundle`),
`centroidal_stage_eval` (`_eval_traj`'s generic branch),
`centroidal_term_linearize` (`_linearize_term`), `centroidal_state_derivative`
(`CentroidalOCP.state_derivative`), and K4's integrate and initial gap on a
vector space, `vector_candidate_integrate` and `vector_state_difference`;
`centroidal_line_search_select` (csrc/linesearch_centroidal.cu:
linesearch.cu's select over centroidal.cuh) its select.  `stage_route`
returns "centroidal" for such an OCP and the solver's wrappers hand it
over.  `centroidal_id_assemble` (csrc/id_centroidal.cu: id.cu over
csrc/stage_wide.cuh with CentroidalID's CoM and swing rows in id.cu's
hooks) replaces `simple_mpc_tpu/id/centroidal_id.py` `_extra_tasks` inside
`_assemble_core`; `id_assemble` hands a `CentroidalID` over.
Each source file states what bounds the kernel on the card and what its
design does about it; csrc/stage.cuh holds the rigid-body algebra the
K1/K2/K5/K9 kernels share.

Dispatch: a tensor on the CPU goes to the plain PyTorch twin; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its kernel launches in
a plain int attribute (`stage_linearize.launches`, ...).

The kernels are compiled at first use with `nvcc` for sm_90a, one process
per source, all started together, and linked into one shared library with
a plain C interface under `_build/`, bound with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from .models.model import FREE
from .ocp.base import tree_map
from .ocp.cones import FRICTION_EPS
from .ops import soa
from .ops import world as _world
from .ops import soa_dyn
from .ops.soa_dyn import chol_solve_unrolled, chol_unrolled
from .id.qp import QPSolution, solve_qp
from .solver.parallel_riccati import parallel_backward as parallel_riccati_backward_plain

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("riccati.cu", "parallel_riccati.cu", "rollout.cu", "linearize.cu", "fulldyn.cu",
           "tick.cu", "qp.cu", "id.cu", "sim.cu", "linearize_wide.cu", "acc.cu", "acc_wide.cu",
           "id_wide.cu", "sim_wide.cu", "linesearch.cu", "linesearch_wide.cu",
           "tick_wide.cu", "fulldyn_wide.cu", "centroidal.cu", "linesearch_centroidal.cu",
           "id_centroidal.cu")
HEADERS = ("stage.cuh", "fulldyn.cuh", "stage_wide.cuh", "fulldyn_wide.cuh", "centroidal.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# units built without FMA contraction, so that they round as the plain
# torch ops they replace did on the card: the line search picks the f32
# iterate, and the Talos f32 fixture re-solve follows every rounding
NO_FMA = ("linesearch.cu", "linesearch_wide.cu", "linesearch_centroidal.cu")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> dict:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into _build/libsmpc_kernels_<hash>.so unless that library exists.
    Returns {"path", "seconds", "log"} (log: nvcc's register/shared-memory
    report; empty when the library was cached)."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs + [CSRC / s for s in HEADERS]:
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS + NO_FMA).encode())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libsmpc_kernels_{tag}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}_{tag}.{os.getpid()}.o"
        objs.append(obj)
        fmad = ("-fmad=false",) if s.name in NO_FMA else ()
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *fmad, "-c", "-o", str(obj), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        log = p.communicate()[0]
        logs.append(log)
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "".join(logs) + r.stdout + r.stderr}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        signatures = dict(
            riccati_backward=[P] * 10 + [D, D, I, I, I, I] + [P] * 4,
            parallel_riccati_backward=[P] * 10 + [D, I, I, I, I] + [P] * 5,
            linear_rollout=[P] * 7 + [I] * 5 + [P] * 3,
            stage_linearize=[P] * 13 + [I] * 2 + [P] * 9,
            stage_eval=[P] * 12 + [I] * 3 + [P] * 5,
            fd_stage_linearize=[P] * 14 + [I] * 2 + [P] * 9,
            fd_stage_eval=[P] * 13 + [I] * 3 + [P] * 5,
            fd_dynamics=[P] * 6 + [I] + [P] * 3,
            term_linearize=[P] * 7 + [I] + [P] * 3,
            wide_stage_linearize=[P] * 14 + [I] * 2 + [P] * 9,
            wide_stage_eval=[P] * 13 + [I] * 3 + [P] * 5,
            wide_term_linearize=[P] * 7 + [I] + [P] * 3,
            wide_fd_stage_linearize=[P] * 15 + [I] * 2 + [P] * 9,
            wide_fd_stage_eval=[P] * 14 + [I] * 3 + [P] * 5,
            wide_fd_dynamics=[P] * 7 + [I] + [P] * 3,
            tick_refs=[P] * 12 + [I] * 6 + [D, D] + [P] * 8,
            wide_tick_refs=[P] * 12 + [I] * 6 + [D, D] + [P] * 8,
            qp_admm=[P] * 7 + [I] * 4 + [D] * 3 + [P] * 5,
            id_assemble=[P] * 10 + [I] * 4 + [P] * 9,
            wide_id_assemble=[P] * 10 + [I] * 4 + [P] * 9,
            sim_step=[P] * 5 + [I] + [D] * 3 + [P] * 5,
            wide_sim_step=[P] * 5 + [I] + [D] * 3 + [P] * 5,
            state_derivative=[P] * 5 + [I] + [P] * 2,
            wide_state_derivative=[P] * 5 + [I] + [P] * 2,
            candidate_integrate=[I] * 3 + [P] * 5 + [I] * 3 + [P] * 3,
            state_difference=[I] * 2 + [P] * 2 + [I] + [P] * 2,
            line_search_select=[P] * 4 + [I] * 3 + [P] * 2,
            wide_line_search_select=[P] * 4 + [I] * 3 + [P] * 2,
            centroidal_stage_linearize=[P] * 13 + [I] * 2 + [P] * 9,
            centroidal_stage_eval=[P] * 12 + [I] * 3 + [P] * 4,
            centroidal_term_linearize=[P] * 5 + [I] + [P] * 3,
            centroidal_ode=[P] * 6 + [I] + [P] * 2,
            vector_candidate_integrate=[I] * 2 + [P] * 5 + [I] * 3 + [P] * 3,
            vector_state_difference=[I] + [P] * 2 + [I] + [P] * 2,
            centroidal_line_search_select=[P] * 4 + [I] * 3 + [P] * 2,
            centroidal_id_assemble=[P] * 15 + [I] * 4 + [P] * 9,
        )
        for name, args in signatures.items():
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"smpc_{name}_{dt}")
                fn.argtypes = args
                fn.restype = I
        for fn, want in ((lib.smpc_dims_ints, _DIMS_INTS),
                         (lib.smpc_wide_dims_ints, _WIDE_DIMS_INTS),
                         (lib.smpc_centroidal_dims_ints, _CENT_DIMS_INTS)):
            fn.restype = I
            if fn() != want:
                raise RuntimeError(f"{fn.__name__}: Dims holds {fn()} ints, "
                                   f"kernels.py packs {want}")
        _lib = lib
    return _lib


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"CUDA kernels take float32 or float64, got {dtype}")


def _check(tensors: dict, shapes: dict, dtype, device, ints=()):
    """Contiguous copies of `tensors` after checking device, shape and dtype
    (`dtype`, or int32 for the names in `ints`)."""
    out = {}
    for k, t in tensors.items():
        want = torch.int32 if k in ints else dtype
        if t.device != device or t.dtype != want:
            raise ValueError(f"{k}: expected {want} on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: expected shape {shapes[k]}, got {tuple(t.shape)}")
        out[k] = t.contiguous()
    return out


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lanes(x):
    """(B, T, n...) -> (n..., B*T): scenarios and stages into the lanes."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])).movedim(0, -1)


def _unlanes(X, nb):
    """(n..., B*T) -> (B, T, n...)."""
    Y = X.movedim(-1, 0)
    return Y.reshape((nb, Y.shape[0] // nb) + tuple(Y.shape[1:]))


def _repeat(x, n):
    """(B, ...) -> (B*n, ...), each scenario repeated n times in a row."""
    return x.repeat_interleave(n, dim=0)


# ---------------------------------------------------------------------------
# K3: Riccati backward pass
# ---------------------------------------------------------------------------

LIN_KEYS = ("A", "B", "d", "qx", "qu", "Qxx", "Quu", "Qux")


def riccati_backward_plain(lin: dict, Vx_T, Vxx_T, reg: float):
    """Plain PyTorch twin of K3: `_backward.step` as a Python loop over T,
    batched over the leading scenario axis, with the unrolled Cholesky of
    ops/soa_dyn.py.  Returns ks (B,T,nu), Ks (B,T,nu,nx), Qus (B,T,nu)."""
    A = lin["A"]
    nb, T, nx = A.shape[:3]
    nu = lin["B"].shape[-1]
    dtype = A.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(nu, dtype=dtype, device=A.device)
    Vx, Vxx = Vx_T, Vxx_T
    ks, Ks, Qus = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        AB = torch.cat([A[:, t], lin["B"][:, t]], dim=2)  # (B, nx, nx+nu)
        Vx_g = Vx + (Vxx @ lin["d"][:, t, :, None])[..., 0]  # gap folding
        VAB = Vxx @ AB
        H = AB.mT @ VAB
        gq = (AB.mT @ Vx_g[..., None])[..., 0]
        Qx = lin["qx"][:, t] + gq[:, :nx]
        Qu = lin["qu"][:, t] + gq[:, nx:]
        Qxx = lin["Qxx"][:, t] + H[:, :nx, :nx]
        Quu = lin["Quu"][:, t] + H[:, nx:, nx:]
        Qux = lin["Qux"][:, t] + H[:, nx:, :nx]
        # Jacobi preconditioning: D^-1/2 Quu D^-1/2 has unit diagonal
        dscale = torch.sqrt(torch.abs(torch.diagonal(Quu, dim1=-2, dim2=-1)) + eps)
        Qs = Quu / (dscale[:, :, None] * dscale[:, None, :]) + reg * eye
        L = chol_unrolled(Qs.permute(1, 2, 0))  # lanes = scenarios
        rhs = torch.cat([(Qu / dscale)[..., None], Qux / dscale[..., None]], dim=2)
        sol = chol_solve_unrolled(L, rhs.permute(1, 2, 0)).permute(2, 0, 1)
        sol = sol / dscale[..., None]  # (B, nu, 1+nx)
        # explicit PSD value update (P = [-k -K]), proxddp.py:430-444
        QuuP = Quu @ sol
        PtQuuP = sol.mT @ QuuP
        QuxtP = Qux.mT @ sol
        KtQu = -(sol[..., 1:].mT @ Qu[..., None])[..., 0]
        Vx = Qx + KtQu - QuxtP[..., 0] + PtQuuP[:, 1:, 0]
        Vxx = Qxx - QuxtP[..., 1:] - QuxtP[..., 1:].mT + PtQuuP[:, 1:, 1:]
        Vxx = 0.5 * (Vxx + Vxx.mT)
        ks[t], Ks[t], Qus[t] = -sol[..., 0], -sol[..., 1:], Qu
    return torch.stack(ks, 1), torch.stack(Ks, 1), torch.stack(Qus, 1)


def _backward_args(lin: dict, Vx_T, Vxx_T):
    """(dims, checked contiguous inputs in kernel order, empty ks/Ks/Qus)
    of a backward-pass kernel."""
    A = lin["A"]
    dtype, device = A.dtype, A.device
    nb, T, nx = A.shape[:3]
    nu = lin["B"].shape[-1]
    shapes = dict(A=(nb, T, nx, nx), B=(nb, T, nx, nu), d=(nb, T, nx),
                  qx=(nb, T, nx), qu=(nb, T, nu), Qxx=(nb, T, nx, nx),
                  Quu=(nb, T, nu, nu), Qux=(nb, T, nu, nx),
                  Vx_T=(nb, nx), Vxx_T=(nb, nx, nx))
    t = _check({**{k: lin[k] for k in LIN_KEYS}, "Vx_T": Vx_T, "Vxx_T": Vxx_T},
               shapes, dtype, device)
    out = [torch.empty(s, dtype=dtype, device=device)
           for s in ((nb, T, nu), (nb, T, nu, nx), (nb, T, nu))]
    return (nb, T, nx, nu), [t[k].data_ptr() for k in shapes], out


def _r4(n: int) -> int:
    return (n + 3) & ~3


def riccati_smem(nx: int, nu: int, dtype) -> dict:
    """Bytes of dynamic shared memory a block of K3 takes on each of its two
    kernels (csrc/riccati.cu): "tiled", for nu <= 40 (`riccati_plan`, region
    by region, each rounded up to 4 elements; None for wider nu), and
    "staged", for wider nu or a tiled plan over the device's limit
    (`riccati_staged_elems`)."""
    size = torch.finfo(dtype).bits // 8
    nz, nr = nx + nu, nx + 1
    staged = (nx + nx * nx + max(2 * nx * nz, nr * (nu + 2 * nx)) + nz * nz + nz + nx + nu
              + nu * nu + nu * nr) * size
    nl = next((w for w in (16, 24, 32, 40) if nu <= w), 0)  # riccati.cu `riccati_nb`
    if not nl:
        return dict(tiled=None, staged=staged)

    def spread(n):  # riccati.cu `spread`
        ld = _r4(n)
        while (ld * size) % 128 != 16:
            ld += 16 // size
        return ld

    ox = _r4(nx)
    ldv, ldab, ldq = _r4(nx), _r4(ox + nu + 1), spread(ox + nu + 1)
    ldsol, ldp, ldl = _r4(nx + 1), _r4(nx + 2), spread(nl)
    sizes = [max(ox * ldv, nu * ldp, 2 * _r4(nl * ldl)), nx, nx * ldab,
             max(nx * ldab, ox * (ldsol + ldp)), (ox + _r4(nu)) * ldq, nu * ldsol, nl, nl, 1]
    return dict(tiled=sum(_r4(s) for s in sizes) * size, staged=staged)


def riccati_route(nx: int, nu: int, dtype, limit: int):
    """The K3 kernel a width takes under `limit` bytes of shared memory a
    block, as csrc/riccati.cu `launch_riccati` picks it: "tiled" where its
    plan fits, else "staged" where its plan fits, else None."""
    smem = riccati_smem(nx, nu, dtype)
    return next((k for k in ("tiled", "staged") if smem[k] is not None and smem[k] <= limit),
                None)


def _riccati_cuda(lin: dict, Vx_T, Vxx_T, reg: float):
    dtype, device = Vx_T.dtype, Vx_T.device
    nx, nu = lin["A"].shape[-1], lin["B"].shape[-1]
    limit = smem_optin(device)
    if riccati_route(nx, nu, dtype, limit) is None:
        raise NotImplementedError(
            f"riccati_backward at nx={nx}, nu={nu} in {dtype} needs "
            f"{riccati_smem(nx, nu, dtype)['staged']} bytes of shared memory a block; "
            f"the device allows {limit}")
    dims, inputs, out = _backward_args(lin, Vx_T, Vxx_T)
    fn = getattr(_library(), f"smpc_riccati_backward_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(*inputs, float(reg), float(torch.finfo(dtype).eps), *dims,
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, "riccati_backward")
    return tuple(out)


def riccati_backward(lin: dict, Vx_T, Vxx_T, reg: float, dual_scale=None):
    """K3.  lin: A (B,T,nx,nx), B (B,T,nx,nu), d, qx (B,T,nx), qu (B,T,nu),
    Qxx, Quu, Qux; Vx_T (B,nx), Vxx_T (B,nx,nx).  Returns ks (B,T,nu),
    Ks (B,T,nu,nx) and the dual residual max|Qu * dual_scale| per
    scenario (B,)."""
    dev = lin["A"].device
    if dev.type == "cpu":
        ks, Ks, Qus = riccati_backward_plain(lin, Vx_T, Vxx_T, reg)
    elif dev.type == "cuda":
        ks, Ks, Qus = _riccati_cuda(lin, Vx_T, Vxx_T, reg)
        riccati_backward.launches += 1
    else:
        raise RuntimeError(f"riccati_backward: no kernel for device {dev}")
    if dual_scale is not None:
        Qus = Qus * dual_scale
    return ks, Ks, torch.amax(torch.abs(Qus), dim=(1, 2))


riccati_backward.launches = 0


# ---------------------------------------------------------------------------
# K6: parallel-in-time Riccati backward pass
# ---------------------------------------------------------------------------


# the driver's attribute, of the same value as the runtime's
# cudaDevAttrMaxSharedMemoryPerBlockOptin
CU_DEVICE_ATTRIBUTE_MAX_SHARED_MEMORY_PER_BLOCK_OPTIN = 97
_smem_optin: dict = {}


def smem_optin(device) -> int:
    """The device's opt-in maximum of dynamic shared memory a block, in
    bytes (227 KB on Hopper), read once per device from the CUDA driver."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _smem_optin:
        cu = ctypes.CDLL("libcuda.so.1")
        dev, val = ctypes.c_int(), ctypes.c_int()
        for err, what in ((cu.cuInit(0), "cuInit"),
                          (cu.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet"),
                          (cu.cuDeviceGetAttribute(
                              ctypes.byref(val),
                              CU_DEVICE_ATTRIBUTE_MAX_SHARED_MEMORY_PER_BLOCK_OPTIN, dev),
                           "cuDeviceGetAttribute")):
            if err != 0:
                raise RuntimeError(f"{what}: CUDA driver error {err}")
        _smem_optin[index] = val.value
    return _smem_optin[index]


def parallel_riccati_smem(nx: int, nu: int, dtype) -> dict:
    """Bytes of dynamic shared memory a block of each of K6's three
    kernels takes (csrc/parallel_riccati.cu `eliminate_smem_elems`,
    `combine_smem_elems`, `gains_smem_elems`)."""
    size = torch.finfo(dtype).bits // 8
    return dict(eliminate=size * (nu * nu + nu * (2 * nx + 1) + 2 * nx * nu + nx * nx + nu),
                combine=size * (7 * nx * nx + 3 * nx),
                gains=size * (2 * nx * nx + 2 * nx * nu + nx + nu * nu + nu * (nx + 1)))


def _parallel_riccati_cuda(lin: dict, Vx_T, Vxx_T, reg: float):
    dtype, device = Vx_T.dtype, Vx_T.device
    (nb, T, nx, nu), inputs, out = _backward_args(lin, Vx_T, Vxx_T)
    limit = smem_optin(device)
    smem = parallel_riccati_smem(nx, nu, dtype)
    if max(smem.values()) > limit:
        raise NotImplementedError(
            f"parallel_riccati_backward at nx={nx}, nu={nu} in {dtype} needs {smem} bytes "
            f"of shared memory a block; the device allows {limit}")
    # the two element buffers (B, T+1, 3 nx^2 + 2 nx) the scan levels
    # alternate between; freed to the caching allocator on return, its next
    # user runs after these launches on the same stream
    work = torch.empty((2, nb, T + 1, 3 * nx * nx + 2 * nx), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_parallel_riccati_backward_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(*inputs, float(reg), nb, T, nx, nu, work.data_ptr(),
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, "parallel_riccati_backward")
    return tuple(out)


def parallel_riccati_backward(lin: dict, Vx_T, Vxx_T, reg: float, dual_scale=None):
    """K6, the contract of `riccati_backward` with the semantics of the
    JAX package's `parallel_backward` (Quu + reg I without Jacobi scaling,
    NaN where a Cholesky fails).  One call launches the elimination,
    ceil(log2(T+1)) scan levels and the gain recovery.  On the card a width
    whose shared memory a block (`parallel_riccati_smem`) exceeds the
    device's opt-in maximum (`smem_optin`) raises NotImplementedError
    before any launch."""
    dev = lin["A"].device
    if dev.type == "cpu":
        ks, Ks, Qus = parallel_riccati_backward_plain(lin, Vx_T, Vxx_T, reg)
    elif dev.type == "cuda":
        ks, Ks, Qus = _parallel_riccati_cuda(lin, Vx_T, Vxx_T, reg)
        parallel_riccati_backward.launches += 1
    else:
        raise RuntimeError(f"parallel_riccati_backward: no kernel for device {dev}")
    if dual_scale is not None:
        Qus = Qus * dual_scale
    return ks, Ks, torch.amax(torch.abs(Qus), dim=(1, 2))


parallel_riccati_backward.launches = 0


# ---------------------------------------------------------------------------
# K4: linear rollout
# ---------------------------------------------------------------------------


def linear_rollout_plain(A, B, d, ks, Ks, dx0, alphas):
    """Plain PyTorch twin of K4: the `_candidate` scan as a Python loop over
    T, batched over scenarios and step sizes.  Returns dxs (B,nA,T+1,nx) and
    dus (B,nA,T,nu)."""
    T = A.shape[1]
    al = alphas[None, :, None]
    dx = dx0[:, None, :].expand(dx0.shape[0], alphas.shape[0], dx0.shape[1])
    dxs, dus = [], []
    for t in range(T):
        du = al * ks[:, t, None, :] + (Ks[:, t, None] @ dx[..., None])[..., 0]
        dx_next = ((A[:, t, None] @ dx[..., None])[..., 0]
                   + (B[:, t, None] @ du[..., None])[..., 0] + al * d[:, t, None, :])
        dxs.append(dx)
        dus.append(du)
        dx = dx_next
    dxs.append(dx)
    return torch.stack(dxs, dim=2), torch.stack(dus, dim=2)


def _rollout_cuda(A, B, d, ks, Ks, dx0, alphas):
    dtype, device = A.dtype, A.device
    nb, T, nx = A.shape[:3]
    nu = B.shape[-1]
    na = alphas.shape[0]
    shapes = dict(A=(nb, T, nx, nx), B=(nb, T, nx, nu), d=(nb, T, nx),
                  ks=(nb, T, nu), Ks=(nb, T, nu, nx), dx0=(nb, nx),
                  alphas=(na,))
    t = _check(dict(A=A, B=B, d=d, ks=ks, Ks=Ks, dx0=dx0, alphas=alphas),
               shapes, dtype, device)
    dxs = torch.empty((nb, na, T + 1, nx), dtype=dtype, device=device)
    dus = torch.empty((nb, na, T, nu), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_linear_rollout_{_suffix(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t[k].data_ptr() for k in shapes], nb, na, T, nx, nu,
                 dxs.data_ptr(), dus.data_ptr(), stream)
    _raise_on(err, "linear_rollout")
    return dxs, dus


def linear_rollout(A, B, d, ks, Ks, dx0, alphas):
    """K4.  du = alpha k + K dx, dx' = A dx + B du + alpha d for every alpha.
    A (B,T,nx,nx), B (B,T,nx,nu), d (B,T,nx), ks (B,T,nu), Ks (B,T,nu,nx),
    dx0 (B,nx), alphas (nA,).  Returns dxs (B,nA,T+1,nx), dus (B,nA,T,nu)."""
    dev = A.device
    if dev.type == "cpu":
        return linear_rollout_plain(A, B, d, ks, Ks, dx0, alphas)
    if dev.type == "cuda":
        out = _rollout_cuda(A, B, d, ks, Ks, dx0, alphas)
        linear_rollout.launches += 1
        return out
    raise RuntimeError(f"linear_rollout: no kernel for device {dev}")


linear_rollout.launches = 0


# ---------------------------------------------------------------------------
# Model and OCP constants of the stage kernels (csrc/stage.cuh `Dims`)
# ---------------------------------------------------------------------------

MAX_JOINTS = 16  # stage.cuh kMaxJ
MAX_FEET = 8  # stage.cuh kMaxK
LIN_THREADS = 64  # linearize.cu kLinThreads: one thread a tangent direction
WIDE_MAX_JOINTS = 32  # stage_wide.cuh SMPC_MAX_JOINTS
WIDE_THREADS = 128  # linearize_wide.cu kWideThreads: one thread a tangent direction
FD_WIDE_ROWS = 24  # fulldyn_wide.cuh kFdWideRows: contact rows (fs * nk) of the wide K7


def _dims_fields(max_joints):
    """stage.cuh `Dims` at `max_joints`: (name, ints) in its order."""
    return (
        ("nj", 1), ("nq", 1), ("nv", 1), ("nu", 1), ("nk", 1), ("fs", 1),
        ("n_cost", 1), ("n_eq", 1), ("n_in", 1), ("n_term_cost", 1), ("n_term_eq", 1),
        ("kin_limits", 1), ("force_cone", 1), ("land_cstr", 1),
        ("parent", max_joints), ("qidx", max_joints), ("vidx", max_joints),
        ("frame_parent", 2 * MAX_FEET + 1),
        ("o_jR", 1), ("o_jp", 1), ("o_axis", 1), ("o_prism", 1), ("o_mass", 1),
        ("o_com", 1), ("o_Iloc", 1), ("o_fR", 1), ("o_fp", 1), ("o_w", 1),
        ("o_wterm", 1), ("o_g", 1), ("o_qmin", 1), ("o_qmax", 1), ("o_cone", 1),
        ("o_scalars", 1),
        ("torque_limits", 1), ("kp_on", 1), ("o_umin", 1), ("o_umax", 1), ("o_kp", 1),
        ("o_kd", 1), ("o_Icom", 1), ("o_grav", 1), ("o_prox", 1),
    )


_DIMS_FIELDS = _dims_fields(MAX_JOINTS)
_DIMS_INTS = sum(n for _, n in _DIMS_FIELDS)
_WIDE_DIMS_FIELDS = _dims_fields(WIDE_MAX_JOINTS)  # smpc_wide::Dims
_WIDE_DIMS_INTS = sum(n for _, n in _WIDE_DIMS_FIELDS)
# centroidal.cuh `smpc_cent::Dims`: nq = 9 and nv = 0 make the line search's
# nx = nq + nv and its tangent (SMPC_LS_NDX) the vector space's 9
_CENT_DIMS_FIELDS = tuple((f, 1) for f in (
    "nq", "nv", "nu", "nk", "fs", "n_cone", "n_cost", "n_eq", "n_in", "n_term_cost",
    "n_term_eq", "o_w", "o_wterm", "o_g", "o_cone", "o_scalars"))
_CENT_DIMS_INTS = len(_CENT_DIMS_FIELDS)
CENT_MAX_FEET = 8  # centroidal.cuh kMaxK
CENT_MAX_U = 24  # centroidal.cuh kMaxU: nu = force size x feet
CENT_MAX_IN = 68  # centroidal.cuh kMaxIn: cone rows
_consts_cache: dict = {}


def _np64(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def _require_body_layout(m, nk: int, what: str = "the stage kernels",
                         max_joints: int = MAX_JOINTS):
    """The kernels' model: a free-flyer root, 1-dof joints in tree order
    with q/v indices in joint order, at most `max_joints` joints and
    MAX_FEET feet."""
    nj = m.njoints
    ok = (m.joint_types[0] == FREE and all(t != FREE for t in m.joint_types[1:])
          and all(m.parents[j] < j for j in range(1, nj))
          and all(m.idx_q[j] == 6 + j and m.idx_v[j] == 5 + j for j in range(1, nj)))
    if not ok:
        raise NotImplementedError(f"{what} take a free-flyer root followed by "
                                  "1-dof joints in tree order")
    if nj > max_joints or nk > MAX_FEET:
        raise NotImplementedError(f"{what} take at most {max_joints} joints "
                                  f"and {MAX_FEET} feet")


def _is_centroidal(ocp) -> bool:
    return getattr(ocp, "centroidal", False)


def _require_centroidal(ocp):
    """csrc/centroidal.cu's limits: force size 3 or 6, CENT_MAX_FEET feet,
    CENT_MAX_U controls and CENT_MAX_IN cone rows."""
    if ocp.fs not in (3, 6):
        raise NotImplementedError(f"the centroidal kernels take force size 3 or 6, got {ocp.fs}")
    if ocp.nk > CENT_MAX_FEET or ocp.nu > CENT_MAX_U or ocp.n_in > CENT_MAX_IN:
        raise NotImplementedError(
            f"the centroidal kernels take at most {CENT_MAX_FEET} feet, {CENT_MAX_U} "
            f"controls and {CENT_MAX_IN} cone rows, got {ocp.nk}, {ocp.nu} and {ocp.n_in}")


def _require_stage_layout(ocp):
    """The stage kernels' model (`_require_body_layout`) with point feet."""
    _require_body_layout(ocp.model, ocp.nk)
    if ocp.fs != 3:
        raise NotImplementedError("the stage kernels take point feet (force_size 3); "
                                  "6D contacts are not ported")
    if 2 * ocp.nv + ocp.nu > LIN_THREADS:
        raise NotImplementedError(f"stage_linearize takes at most {LIN_THREADS} tangent "
                                  f"directions (ndx + nu), got {2 * ocp.nv + ocp.nu}")


def stage_route(ocp) -> str:
    """Which kernels take the stage of `ocp` on the card: "narrow"
    (csrc/linearize.cu, or csrc/fulldyn.cu for a full-dynamics OCP) for
    what `_require_stage_layout` accepts, "wide" (csrc/linearize_wide.cu,
    or csrc/fulldyn_wide.cu) for force size 3 or 6, at most
    WIDE_MAX_JOINTS joints, MAX_FEET feet, WIDE_THREADS tangent directions
    (ndx + nu) and, on full dynamics, FD_WIDE_ROWS contact rows (8 point
    feet, or 4 feet with 6D contacts).  A centroidal OCP goes to
    "centroidal" (csrc/centroidal.cu, `_require_centroidal`).  Raises
    NotImplementedError beyond those."""
    if _is_centroidal(ocp):
        _require_centroidal(ocp)
        return "centroidal"
    _require_body_layout(ocp.model, ocp.nk, max_joints=WIDE_MAX_JOINTS)
    ndir = 2 * ocp.nv + ocp.nu
    if ocp.fs == 3 and ocp.model.njoints <= MAX_JOINTS and ndir <= LIN_THREADS:
        return "narrow"
    if ocp.fs not in (3, 6):
        raise NotImplementedError(f"the stage kernels take force size 3 or 6, got {ocp.fs}")
    if ndir > WIDE_THREADS:
        raise NotImplementedError(f"the wide stage kernels take at most {WIDE_THREADS} "
                                  f"tangent directions (ndx + nu), got {ndir}")
    if getattr(ocp, "full_dynamics", False) and ocp.fs * ocp.nk > FD_WIDE_ROWS:
        raise NotImplementedError(
            f"the wide full-dynamics kernels take at most {FD_WIDE_ROWS} contact rows "
            f"(force size x feet), got {ocp.fs} x {ocp.nk}")
    return "wide"


def _stage_consts(ocp, dtype, device, wide=False):
    """(packed constants on `device` in `dtype`, Dims as a ctypes int array)
    of the Go2 units' `Dims`, or with `wide` of `smpc_wide::Dims`, built once
    per (OCP, topology tables, terminal rows, dtype, device, width)."""
    tab = _world.tables(ocp.model)
    key = (id(ocp), id(tab), ocp.n_term_eq, dtype, device, wide)
    hit = _consts_cache.get(key)
    if hit is not None and hit[0] is ocp and hit[1] is tab:
        return hit[2], hit[3]
    if wide:
        stage_route(ocp)
    else:
        _require_stage_layout(ocp)
    m, mh, s = ocp.model, ocp.model_handler, ocp.settings
    nj, nk, nv = m.njoints, ocp.nk, ocp.nv
    c = ocp._const(torch.empty(0, dtype=torch.float64))
    axes = np.zeros((nj, 3))
    prism = np.zeros(nj)
    axes[tab.one_dof] = tab.axes
    prism[tab.one_dof] = tab.is_prismatic
    sel = list(ocp.feet_fids) + list(mh.feet_ref_frame_ids) + [mh.base_frame_id]

    def opt(name, flag):
        return _np64(c[name]).reshape(-1) if flag else np.zeros(0)

    fd = ocp.full_dynamics
    torque_limits = fd and s.torque_limits
    kp = opt("kp_rows", fd)
    blocks = dict(
        o_jR=tab.jR, o_jp=tab.jp, o_axis=axes, o_prism=prism, o_mass=tab.masses,
        o_com=tab.coms, o_Iloc=tab.I_loc, o_fR=tab.fR[sel], o_fp=tab.fp[sel],
        o_w=_np64(c["w"]), o_wterm=_np64(c["w_term"]), o_g=_np64(c["g"]),
        o_qmin=opt("qmin", s.kinematics_limits), o_qmax=opt("qmax", s.kinematics_limits),
        o_cone=opt("cone", s.force_cone),
        o_scalars=np.array([tab.total_mass, ocp.mass, s.timestep, FRICTION_EPS]),
        o_umin=opt("umin", torque_limits), o_umax=opt("umax", torque_limits), o_kp=kp,
        o_kd=opt("kd_rows", fd), o_Icom=soa_dyn._static_body_params(m)[2],
        o_grav=np.asarray(m.gravity, np.float64),
        # the Delassus diagonal's proximal term in this dtype
        # (constrained_fwd_dynamics_soa)
        o_prox=np.array([max(ocp.prox_mu, 50.0 * torch.finfo(dtype).eps) if fd else 0.0]))
    dims = dict(
        nj=nj, nq=ocp.nq, nv=nv, nu=ocp.nu, nk=nk, fs=ocp.fs,
        n_cost=blocks["o_w"].shape[0], n_eq=ocp.n_eq, n_in=ocp.n_in,
        n_term_cost=blocks["o_wterm"].shape[0], n_term_eq=ocp.n_term_eq,
        kin_limits=int(s.kinematics_limits), force_cone=int(s.force_cone),
        land_cstr=int(s.land_cstr), torque_limits=int(torque_limits),
        kp_on=int(bool(np.any(kp))),
        parent=list(m.parents), qidx=list(m.idx_q), vidx=list(m.idx_v),
        frame_parent=[int(tab.fparent[f]) for f in sel])
    buf, dims_c = _pack_consts(dims, blocks, dtype, device,
                               _WIDE_DIMS_FIELDS if wide else _DIMS_FIELDS)
    _consts_cache[key] = (ocp, tab, buf, dims_c)
    return buf, dims_c


def _pack_consts(dims: dict, blocks: dict, dtype, device, fields=_DIMS_FIELDS):
    """(the blocks concatenated on `device` in `dtype`, Dims of `fields` as
    a ctypes int array): each block's offset goes to `dims` under its name;
    Dims fields that `dims` lacks are 0."""
    flat, off = [], 0
    for name, arr in blocks.items():
        a = np.asarray(arr, np.float64).reshape(-1)
        dims[name] = off
        flat.append(a)
        off += a.shape[0]
    ints = []
    for name, n in fields:
        v = np.atleast_1d(np.asarray(dims.get(name, 0), np.int64))
        ints.extend(v.tolist() + [0] * (n - v.shape[0]))
    dims_c = (ctypes.c_int * len(ints))(*ints)
    buf = torch.as_tensor(np.concatenate(flat), dtype=dtype, device=device)
    return buf, dims_c


def _stage_kernel(ocp, fd: bool, name: str, wide: bool = False) -> str:
    """The C name of a stage kernel, refusing an OCP of the other
    formulation (the two stages read different constants)."""
    if ocp.full_dynamics != fd:
        raise ValueError(f"{'wide_' if wide else ''}{'fd_' if fd else ''}{name} takes a "
                         f"{'full-dynamics' if fd else 'kinodynamics'} OCP, "
                         f"got {type(ocp).__name__}")
    return f"{'wide_' if wide else ''}{'fd_' if fd else ''}{name}"


def _stage_params(sp, nb, T, nk, nx, nu, dtype, device, fd=False, wide=False, fs=3):
    """Pointers to the stage parameters the kernels read, checked and
    contiguous; the full-dynamics stage also reads f_ref (nk, fs), the wide
    stage foot_ref_R."""
    shapes = dict(contact_active=(nb, T, nk))
    if wide:
        shapes["foot_ref_R"] = (nb, T, nk, 3, 3)
    shapes.update(foot_ref_p=(nb, T, nk, 3), x_ref=(nb, T, nx), u_ref=(nb, T, nu))
    if fd:
        shapes["f_ref"] = (nb, T, nk, fs)
    shapes["land"] = (nb, T, nk)
    t = _check({k: getattr(sp, k) for k in shapes}, shapes, dtype, device)
    return [t[k].data_ptr() for k in shapes]


# ---------------------------------------------------------------------------
# K1 + K2: stage linearization
# ---------------------------------------------------------------------------


def _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu):
    """Plain PyTorch twin of K1+K2: the stage bundle on N = B*T lanes and
    its forward-mode tangents along the 18 dq, 18 dv and 24 du basis
    directions (`torch.func.jvp` under `torch.func.vmap`; on a vector space,
    the centroidal one, along its ndx state directions and nu), then the
    Gauss-Newton products.  sp: stage params with leading (B, T).  Returns
    the LQ data A, B, d, qx, qu, Qxx, Quu, Qux with leading (B, T)."""
    space, ocp = solver.space, solver.ocp
    ndx, nu = space.ndx, ocp.nu
    split = space.tangent_split
    nb, T = us.shape[:2]
    N = nb * T
    dtype, device = xs.dtype, xs.device
    P = tree_map(_lanes, sp)
    X, U, Xn = _lanes(xs[:, :-1]), _lanes(us), _lanes(xs[:, 1:])
    LE, LI = _lanes(lam_eq), _lanes(lam_in)
    mu_l = mu.repeat_interleave(T)
    su = solver._su(xs)
    su = None if su is None else su[:, None]

    def run(Xp, du):
        r_all, w_all, _, _, xnext = solver._stage_bundle_soa(
            Xp, U + (du if su is None else su * du), P, LE, LI, mu_l)
        return r_all, space.difference_soa(Xn, xnext), w_all

    zu = torch.zeros((nu, N), dtype=dtype, device=device)

    def tangents(fn, z):
        n = z.shape[0]
        basis = torch.eye(n, dtype=dtype, device=device)[..., None].expand(n, n, N)
        return vmap(lambda t: jvp(fn, (z,), (t,))[1])(basis)

    if split is None:  # a vector space (centroidal): one block of state tangents
        zx = torch.zeros((ndx, N), dtype=dtype, device=device)
        r0, d0, w0 = run(X, zu)
        Jr_x, Jd_x = tangents(lambda a: run(space.integrate_soa(X, a), zu)[:2], zx)
    else:
        zq = torch.zeros((split, N), dtype=dtype, device=device)
        zv = torch.zeros((ndx - split, N), dtype=dtype, device=device)
        r0, d0, w0 = run(space.integrate_parts_soa(X, zq, zv), zu)
        Jr_q, Jd_q = tangents(
            lambda a: run(space.integrate_parts_soa(X, a, zv), zu)[:2], zq)
        Jr_v, Jd_v = tangents(
            lambda a: run(space.integrate_parts_soa(X, zq, a), zu)[:2], zv)
        Jr_x, Jd_x = torch.cat([Jr_q, Jr_v], dim=0), torch.cat([Jd_q, Jd_v], dim=0)
        X = space.integrate_parts_soa(X, zq, zv)
    Jr_u, Jd_u = tangents(lambda a: run(X, a)[:2], zu)
    Jr = torch.cat([Jr_x, Jr_u], dim=0)  # (ndx+nu, nr, N)
    Jd = torch.cat([Jd_x, Jd_u], dim=0)  # (ndx+nu, ndx, N)

    # one sqrt(w)-scaled copy of Jr feeds both Gauss-Newton products
    ws = torch.sqrt(w0)
    Jw = Jr * ws[None]
    wr = ws * r0
    grad = torch.einsum("ent,nt->te", Jw, wr)  # (N, ndx+nu)
    H = torch.einsum("ant,bnt->tab", Jw, Jw)  # (N, 60, 60)
    A = Jd[:ndx].permute(2, 1, 0)  # (N, ndx, ndx)
    B = Jd[ndx:].permute(2, 1, 0)  # (N, ndx, nu)

    def bt(a):
        return a.reshape((nb, T) + tuple(a.shape[1:])).contiguous()

    return dict(A=bt(A), B=bt(B), d=bt(d0.T),
                qx=bt(grad[:, :ndx]), qu=bt(grad[:, ndx:]),
                Qxx=bt(H[:, :ndx, :ndx]), Quu=bt(H[:, ndx:, ndx:]),
                Qux=bt(H[:, ndx:, :ndx]))


def _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=False, wide=False):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    name = _stage_kernel(ocp, fd, "stage_linearize", wide)
    C, dims = _stage_consts(ocp, dtype, device, wide)
    nb, T = us.shape[:2]
    nx, nu, ndx = solver.space.nx, ocp.nu, solver.space.ndx
    shapes = dict(xs=(nb, T + 1, nx), us=(nb, T, nu), lam_eq=(nb, T, ocp.n_eq),
                  lam_in=(nb, T, ocp.n_in), mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_eq=lam_eq, lam_in=lam_in, mu=mu), shapes,
               dtype, device)
    params = _stage_params(sp, nb, T, ocp.nk, nx, nu, dtype, device, fd, wide, ocp.fs)
    if wide and fd:
        _require_fd_smem(ocp, dtype, device)
    su = solver._su(xs)
    out = dict(A=(nb, T, ndx, ndx), B=(nb, T, ndx, nu), d=(nb, T, ndx),
               qx=(nb, T, ndx), qu=(nb, T, nu), Qxx=(nb, T, ndx, ndx),
               Quu=(nb, T, nu, nu), Qux=(nb, T, nu, ndx))
    out = {k: torch.empty(v, dtype=dtype, device=device) for k, v in out.items()}
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), t["xs"].data_ptr(),
                 t["us"].data_ptr(), *params, t["lam_eq"].data_ptr(),
                 t["lam_in"].data_ptr(), t["mu"].data_ptr(),
                 None if su is None else su.data_ptr(), nb, T,
                 *[v.data_ptr() for v in out.values()], _stream(device))
    _raise_on(err, name)
    return out


def stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K1+K2.  sp: stage params with leading (B, T); xs (B,T+1,nx),
    us (B,T,nu), lam_eq (B,T,n_eq), lam_in (B,T,n_in), mu (B,).  Returns the
    LQ data A (B,T,ndx,ndx), B (B,T,ndx,nu), d, qx (B,T,ndx), qu (B,T,nu),
    Qxx, Quu, Qux of the AL Gauss-Newton model."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        route = stage_route(solver.ocp)
        if route == "centroidal":
            return centroidal_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
        if route == "wide":
            return wide_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        stage_linearize.launches += 1
        return out
    raise RuntimeError(f"stage_linearize: no kernel for device {dev}")


stage_linearize.launches = 0


def wide_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K1+K2 at wide shapes (csrc/linearize_wide.cu): `stage_linearize`'s
    contract, for 6D contacts and up to WIDE_MAX_JOINTS joints and
    WIDE_THREADS tangent directions; the stage params' foot_ref_R is read."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, wide=True)
        wide_stage_linearize.launches += 1
        return out
    raise RuntimeError(f"wide_stage_linearize: no kernel for device {dev}")


wide_stage_linearize.launches = 0


# ---------------------------------------------------------------------------
# K1 on the line-search candidates
# ---------------------------------------------------------------------------


def _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu):
    """Plain PyTorch twin of K1 in primal mode: stage bundles over the
    horizon of every (scenario, step size).  xs (B,nA,T+1,nx),
    us (B,nA,T,nu); sp, lam_eq, lam_in and mu per scenario.  Returns the AL
    stage costs (B*nA, T), raw constraints g, h and the multiple-shooting
    gaps (B*nA, T, ...)."""
    nb, na, T = us.shape[:3]
    P = tree_map(lambda a: _lanes(_repeat(a, na)), sp)
    xs_f = xs.reshape((nb * na,) + xs.shape[2:])
    us_f = us.reshape((nb * na,) + us.shape[2:])
    X, U, Xn = _lanes(xs_f[:, :-1]), _lanes(us_f), _lanes(xs_f[:, 1:])
    mu_l = _repeat(mu, na).repeat_interleave(T)
    r_all, w_all, g, h, xnext = solver._stage_bundle_soa(
        X, U, P, _lanes(_repeat(lam_eq, na)), _lanes(_repeat(lam_in, na)), mu_l)
    gap = solver.space.difference_soa(Xn, xnext)
    costs = 0.5 * torch.sum(w_all * r_all * r_all, dim=0)
    n = nb * na
    return (costs.reshape(n, T), _unlanes(g, n), _unlanes(h, n), _unlanes(gap, n))


def _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=False, wide=False):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    name = _stage_kernel(ocp, fd, "stage_eval", wide)
    C, dims = _stage_consts(ocp, dtype, device, wide)
    nb, na, T = us.shape[:3]
    nx, nu, ndx = solver.space.nx, ocp.nu, solver.space.ndx
    shapes = dict(xs=(nb, na, T + 1, nx), us=(nb, na, T, nu),
                  lam_eq=(nb, T, ocp.n_eq), lam_in=(nb, T, ocp.n_in), mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_eq=lam_eq, lam_in=lam_in, mu=mu), shapes,
               dtype, device)
    params = _stage_params(sp, nb, T, ocp.nk, nx, nu, dtype, device, fd, wide, ocp.fs)
    n = nb * na
    out = [torch.empty(s, dtype=dtype, device=device)
           for s in ((n, T), (n, T, ocp.n_eq), (n, T, ocp.n_in), (n, T, ndx))]
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), t["xs"].data_ptr(),
                 t["us"].data_ptr(), *params, t["lam_eq"].data_ptr(),
                 t["lam_in"].data_ptr(), t["mu"].data_ptr(), nb, na, T,
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, name)
    return tuple(out)


def stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K1 in primal mode on the candidates.  xs (B,nA,T+1,nx),
    us (B,nA,T,nu); sp (leading (B, T)), lam_eq, lam_in, mu per scenario.
    Returns costs (B*nA,T), g (B*nA,T,n_eq), h (B*nA,T,n_in),
    gap (B*nA,T,ndx)."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        route = stage_route(solver.ocp)
        if route == "centroidal":
            return centroidal_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu)
        if route == "wide":
            return wide_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu)
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        stage_eval.launches += 1
        return out
    raise RuntimeError(f"stage_eval: no kernel for device {dev}")


stage_eval.launches = 0


def wide_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K1 on the candidates at wide shapes (csrc/linearize_wide.cu):
    `stage_eval`'s contract."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, wide=True)
        wide_stage_eval.launches += 1
        return out
    raise RuntimeError(f"wide_stage_eval: no kernel for device {dev}")


wide_stage_eval.launches = 0


# ---------------------------------------------------------------------------
# The full-dynamics stage: K7 inside K1 + K2, K1, and alone
# ---------------------------------------------------------------------------


def fd_smem(ocp, dtype) -> int:
    """Bytes of dynamic shared memory a block of `wide_fd_stage_linearize`
    takes: the columns of ws*Jr and Jgap and the primal rows,
    ((nr + ndx) ndir + nr + ndx) scalars (csrc/fulldyn_wide.cu)."""
    ndx = 2 * ocp.nv
    nr = int(ocp._const(torch.empty(0, dtype=torch.float64))["w"].shape[0]) + ocp.n_eq + ocp.n_in
    return ((nr + ndx) * (ndx + ocp.nu) + nr + ndx) * (torch.finfo(dtype).bits // 8)


def _require_fd_smem(ocp, dtype, device):
    """Refuse, before the launch, a wide full-dynamics linearization whose
    shared memory a block exceeds the device's opt-in maximum."""
    need, limit = fd_smem(ocp, dtype), smem_optin(device)
    if need > limit:
        raise NotImplementedError(
            f"wide_fd_stage_linearize needs {need} bytes of shared memory a block in "
            f"{dtype}; the device allows {limit}")


def fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 + K2: `stage_linearize`'s contract on a FullDynamicsOCP
    (stage params with f_ref).  The twin is the same `torch.func` sweep
    over `FullDynamicsOCP.stage_eval_soa`.  An OCP that `stage_route` sends to
    the wide unit goes to `wide_fd_stage_linearize` on the card."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        if stage_route(solver.ocp) == "wide":
            return wide_fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu)
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True)
        fd_stage_linearize.launches += 1
        return out
    raise RuntimeError(f"fd_stage_linearize: no kernel for device {dev}")


fd_stage_linearize.launches = 0


def wide_fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 + K2 at wide shapes (csrc/fulldyn_wide.cu):
    `fd_stage_linearize`'s contract for 6D contacts, up to WIDE_MAX_JOINTS
    joints, WIDE_THREADS tangent directions and FD_WIDE_ROWS contact rows;
    the stage params' foot_ref_R is read.  On the card a problem whose
    shared memory a block (`fd_smem`) exceeds the device's opt-in maximum
    raises NotImplementedError before the launch."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True, wide=True)
        wide_fd_stage_linearize.launches += 1
        return out
    raise RuntimeError(f"wide_fd_stage_linearize: no kernel for device {dev}")


wide_fd_stage_linearize.launches = 0


def fd_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 in primal mode on the candidates: `stage_eval`'s contract on
    a FullDynamicsOCP; `wide_fd_stage_eval` for what `stage_route` sends to
    the wide unit."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        if stage_route(solver.ocp) == "wide":
            return wide_fd_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu)
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True)
        fd_stage_eval.launches += 1
        return out
    raise RuntimeError(f"fd_stage_eval: no kernel for device {dev}")


fd_stage_eval.launches = 0


def wide_fd_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 on the candidates at wide shapes (csrc/fulldyn_wide.cu):
    `fd_stage_eval`'s contract."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True, wide=True)
        wide_fd_stage_eval.launches += 1
        return out
    raise RuntimeError(f"wide_fd_stage_eval: no kernel for device {dev}")


wide_fd_stage_eval.launches = 0


def fd_dynamics_plain(ocp, x, u, p):
    """Plain PyTorch twin of K7: `FullDynamicsOCP._constrained_acc_soa` on
    N lanes.  x (N,nx), u (N,nu), p stage params with leading N.  Returns
    ddq (N,nv), forces (N,nk,fs)."""
    P = tree_map(lambda a: a.movedim(0, -1), p)
    ddq, f = ocp._constrained_acc_soa(x.T, u.T, P)
    return ddq.T, f.permute(2, 0, 1)


def _fd_dynamics_cuda(ocp, x, u, p, wide=False):
    dtype, device = x.dtype, x.device
    name = _stage_kernel(ocp, True, "dynamics", wide)
    C, dims = _stage_consts(ocp, dtype, device, wide)
    n = x.shape[0]
    shapes = dict(x=(n, ocp.nq + ocp.nv), u=(n, ocp.nu), active=(n, ocp.nk))
    tensors = dict(x=x, u=u, active=p.contact_active)
    if wide:
        shapes["foot_ref_R"] = (n, ocp.nk, 3, 3)
        tensors["foot_ref_R"] = p.foot_ref_R
    shapes["foot_ref_p"] = (n, ocp.nk, 3)
    tensors["foot_ref_p"] = p.foot_ref_p
    t = _check(tensors, shapes, dtype, device)
    ddq = torch.empty((n, ocp.nv), dtype=dtype, device=device)
    f = torch.empty((n, ocp.nk, ocp.fs if wide else 3), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes],
                 n, ddq.data_ptr(), f.data_ptr(), _stream(device))
    _raise_on(err, name)
    return ddq, f


def fd_dynamics(ocp, x, u, p):
    """K7: the constrained dynamics of a FullDynamicsOCP on N lanes.
    x (N,nx), u (N,nu), p stage params with leading N.  Returns ddq (N,nv)
    and the contact forces (N,nk,fs); `wide_fd_dynamics` for what
    `stage_route` sends to the wide unit."""
    dev = x.device
    if dev.type == "cpu":
        return fd_dynamics_plain(ocp, x, u, p)
    if dev.type == "cuda":
        if stage_route(ocp) == "wide":
            return wide_fd_dynamics(ocp, x, u, p)
        out = _fd_dynamics_cuda(ocp, x, u, p)
        fd_dynamics.launches += 1
        return out
    raise RuntimeError(f"fd_dynamics: no kernel for device {dev}")


fd_dynamics.launches = 0


def wide_fd_dynamics(ocp, x, u, p):
    """K7 at wide shapes (csrc/fulldyn_wide.cu): `fd_dynamics`' contract;
    the params' foot_ref_R is read (the 6D Baumgarte anchors)."""
    dev = x.device
    if dev.type == "cpu":
        return fd_dynamics_plain(ocp, x, u, p)
    if dev.type == "cuda":
        out = _fd_dynamics_cuda(ocp, x, u, p, wide=True)
        wide_fd_dynamics.launches += 1
        return out
    raise RuntimeError(f"wide_fd_dynamics: no kernel for device {dev}")


wide_fd_dynamics.launches = 0


# ---------------------------------------------------------------------------
# K11: the kinodynamics state derivative
# ---------------------------------------------------------------------------


def state_derivative_plain(ocp, x, u, p):
    """Plain PyTorch twin of K11: [v; a] from `KinodynamicsOCP._acc_soa`
    on N lanes.  x (N,nx), u (N,nu), p stage params with leading N.
    Returns (N, 2 nv)."""
    P = tree_map(lambda a: a.movedim(0, -1), p)
    a, _ = ocp._acc_soa(x[:, : ocp.nq].T, x[:, ocp.nq:].T, u.T, P)
    return torch.cat([x[:, ocp.nq:], a.T], dim=1)


def _state_derivative_cuda(ocp, x, u, p, wide):
    if ocp.full_dynamics:
        raise ValueError("state_derivative takes a kinodynamics OCP")
    dtype, device = x.dtype, x.device
    C, dims = _stage_consts(ocp, dtype, device, wide)
    n = x.shape[0]
    shapes = dict(x=(n, ocp.nq + ocp.nv), u=(n, ocp.nu), active=(n, ocp.nk))
    t = _check(dict(x=x, u=u, active=p.contact_active), shapes, dtype, device)
    out = torch.empty((n, 2 * ocp.nv), dtype=dtype, device=device)
    name = f"{'wide_' if wide else ''}state_derivative"
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes],
                 n, out.data_ptr(), _stream(device))
    _raise_on(err, name)
    return out


def state_derivative(ocp, x, u, p):
    """K11: the continuous state derivative [v; a] of a KinodynamicsOCP on
    N lanes (csrc/acc.cu).  x (N,nx), u (N,nu), p stage params with leading
    N (the kernel reads contact_active).  Returns (N, 2 nv).  A centroidal
    OCP goes to `centroidal_state_derivative` (its 9-dim ODE)."""
    dev = x.device
    if _is_centroidal(ocp):
        return centroidal_state_derivative(ocp, x, u, p)
    if dev.type == "cpu":
        return state_derivative_plain(ocp, x, u, p)
    if dev.type == "cuda":
        if stage_route(ocp) == "wide":
            return wide_state_derivative(ocp, x, u, p)
        out = _state_derivative_cuda(ocp, x, u, p, wide=False)
        state_derivative.launches += 1
        return out
    raise RuntimeError(f"state_derivative: no kernel for device {dev}")


state_derivative.launches = 0


def wide_state_derivative(ocp, x, u, p):
    """K11 at wide shapes (csrc/acc_wide.cu): `state_derivative`'s
    contract for 6D contacts and up to WIDE_MAX_JOINTS joints."""
    dev = x.device
    if dev.type == "cpu":
        return state_derivative_plain(ocp, x, u, p)
    if dev.type == "cuda":
        out = _state_derivative_cuda(ocp, x, u, p, wide=True)
        wide_state_derivative.launches += 1
        return out
    raise RuntimeError(f"wide_state_derivative: no kernel for device {dev}")


wide_state_derivative.launches = 0


# ---------------------------------------------------------------------------
# K5: terminal Jacobian
# ---------------------------------------------------------------------------


def _linearize_term_plain(solver, x, tp, lam_term, mu):
    """Plain PyTorch twin of K5: the terminal Gauss-Newton expansion per
    scenario with `torch.func.jacfwd`.  x (B,nx); tp leaves (B, ...).
    Returns Vx (B,ndx), Vxx (B,ndx,ndx)."""
    space, ocp = solver.space, solver.ocp

    def resid(dx, xx, pp, lam, m):
        xi = space.integrate(xx, dx)
        r, _ = ocp.term_residuals(xi, pp)
        g = ocp.term_eq_constraints(xi, pp)
        return torch.cat([r, g + m * lam])

    z = torch.zeros((x.shape[0], space.ndx), dtype=x.dtype, device=x.device)
    r0 = vmap(resid)(z, x, tp, lam_term, mu)
    J = vmap(jacfwd(resid))(z, x, tp, lam_term, mu)  # (B, nr, ndx)
    _, w = ocp.term_residuals(x, tp)
    w0 = torch.cat([w.expand(x.shape[0], w.shape[0]),
                    (1.0 / mu)[:, None].expand(x.shape[0], lam_term.shape[1])],
                   dim=1)
    Vx = torch.einsum("bri,br->bi", J, w0 * r0)
    Vxx = torch.einsum("bri,brj->bij", J, w0[..., None] * J)
    return Vx, Vxx


def _term_cuda(solver, x, tp, lam_term, mu, wide=False):
    ocp = solver.ocp
    dtype, device = x.dtype, x.device
    C, dims = _stage_consts(ocp, dtype, device, wide)
    nb = x.shape[0]
    nx, ndx = solver.space.nx, solver.space.ndx
    shapes = dict(x=(nb, nx), x_ref=(nb, nx), dcm_ref=(nb, 3),
                  lam=(nb, ocp.n_term_eq), mu=(nb,))
    t = _check(dict(x=x, x_ref=tp.x_ref, dcm_ref=tp.dcm_ref, lam=lam_term, mu=mu),
               shapes, dtype, device)
    Vx = torch.empty((nb, ndx), dtype=dtype, device=device)
    Vxx = torch.empty((nb, ndx, ndx), dtype=dtype, device=device)
    name = "wide_term_linearize" if wide else "term_linearize"
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb, Vx.data_ptr(),
                 Vxx.data_ptr(), _stream(device))
    _raise_on(err, name)
    return Vx, Vxx


def term_linearize(solver, x, tp, lam_term, mu):
    """K5.  x (B,nx) terminal states, tp terminal params (leaves (B, ...)),
    lam_term (B,n_term_eq), mu (B,).  Returns Vx (B,ndx), Vxx (B,ndx,ndx)."""
    dev = x.device
    if dev.type == "cpu":
        return _linearize_term_plain(solver, x, tp, lam_term, mu)
    if dev.type == "cuda":
        route = stage_route(solver.ocp)
        if route == "centroidal":
            return centroidal_term_linearize(solver, x, tp, lam_term, mu)
        if route == "wide":
            return wide_term_linearize(solver, x, tp, lam_term, mu)
        out = _term_cuda(solver, x, tp, lam_term, mu)
        term_linearize.launches += 1
        return out
    raise RuntimeError(f"term_linearize: no kernel for device {dev}")


term_linearize.launches = 0


def wide_term_linearize(solver, x, tp, lam_term, mu):
    """K5 at wide shapes (csrc/linearize_wide.cu): `term_linearize`'s
    contract."""
    dev = x.device
    if dev.type == "cpu":
        return _linearize_term_plain(solver, x, tp, lam_term, mu)
    if dev.type == "cuda":
        out = _term_cuda(solver, x, tp, lam_term, mu, wide=True)
        wide_term_linearize.launches += 1
        return out
    raise RuntimeError(f"wide_term_linearize: no kernel for device {dev}")


wide_term_linearize.launches = 0


# ---------------------------------------------------------------------------
# K4 after the rollout: the candidates' Lie integrate, the line search and
# the BCL update
# ---------------------------------------------------------------------------

LS_MAX_ALPHAS = 8  # linesearch.cu kMaxAlpha: one warp a step size
LS_MAX_TERM_EQ = 3  # linesearch.cu kMaxTermEq


class LineSearch(NamedTuple):
    """What one ProxDDP iteration keeps of its line search, per scenario."""

    xs: torch.Tensor  # (B, T+1, nx) the chosen candidate
    us: torch.Tensor  # (B, T, nu)
    alpha: torch.Tensor  # (B,) its step size
    merit: torch.Tensor  # (B,) its merit (+inf where every candidate was NaN)
    prim: torch.Tensor  # (B,) its primal residual
    lam_eq: torch.Tensor  # (B, T, n_eq) multipliers after the BCL update
    lam_in: torch.Tensor  # (B, T, n_in)
    lam_term: torch.Tensor  # (B, n_term_eq)
    mu: torch.Tensor  # (B,) the BCL schedule after the update
    eta: torch.Tensor  # (B,)
    omega: torch.Tensor  # (B,)
    dx0: torch.Tensor  # (B, ndx) difference(xs[:, 0], x0), the next initial gap


_ls_route = stage_route  # the select's unit is the stage kernels'


def candidate_integrate_plain(solver, xs, us, dxs, dus):
    """Plain PyTorch twin of K4's Lie integrate: xs (B,T+1,nx), us (B,T,nu)
    moved by the rollout's dxs (B,nA,T+1,ndx) and dus (B,nA,T,nu) (in
    u_hat units under the solver's u_scale, chained back here).  Returns
    xs_c (B,nA,T+1,nx), us_c (B,nA,T,nu)."""
    xs_c = solver.space.integrate(xs[:, None].expand(dxs.shape[:3] + xs.shape[-1:]), dxs)
    su = solver._su(us)
    if su is not None:  # dus is in u_hat units; chain back
        dus = dus * su
    return xs_c, us[:, None] + dus


def _integrate_cuda(solver, xs, us, dxs, dus):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    nb, na, T1, ndx = dxs.shape
    T, nx, nu = T1 - 1, solver.space.nx, ocp.nu
    shapes = dict(xs=(nb, T1, nx), us=(nb, T, nu), dxs=(nb, na, T1, ndx), dus=(nb, na, T, nu))
    # the Lie integrate of a free-flyer root and 1-dof joints, at any width
    _require_body_layout(ocp.model, 0, "candidate_integrate", ocp.model.njoints)
    t = _check(dict(xs=xs, us=us, dxs=dxs, dus=dus), shapes, dtype, device)
    su = solver._su(xs)
    xs_c = torch.empty((nb, na, T1, nx), dtype=dtype, device=device)
    us_c = torch.empty((nb, na, T, nu), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_candidate_integrate_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ocp.nq, ocp.nv, nu, *[t[k].data_ptr() for k in shapes],
                 None if su is None else su.data_ptr(), nb, na, T, xs_c.data_ptr(),
                 us_c.data_ptr(), _stream(device))
    _raise_on(err, "candidate_integrate")
    return xs_c, us_c


def candidate_integrate(solver, xs, us, dxs, dus):
    """K4's Lie integrate of the rollout's steps: `candidate_integrate_plain`'s
    contract (csrc/linesearch.cu), for every multibody model: it reads nq
    and nv alone.  A centroidal OCP goes to `vector_candidate_integrate`."""
    dev = xs.device
    if dev.type == "cpu":
        return candidate_integrate_plain(solver, xs, us, dxs, dus)
    if _is_centroidal(solver.ocp) and dev.type == "cuda":
        return vector_candidate_integrate(solver, xs, us, dxs, dus)
    if dev.type == "cuda":
        out = _integrate_cuda(solver, xs, us, dxs, dus)
        candidate_integrate.launches += 1
        return out
    raise RuntimeError(f"candidate_integrate: no kernel for device {dev}")


candidate_integrate.launches = 0


def _difference_cuda(solver, x1, x2):
    ocp = solver.ocp
    dtype, device = x1.dtype, x1.device
    n, nx = x1.shape[0], solver.space.nx
    _require_body_layout(ocp.model, 0, "state_difference", ocp.model.njoints)
    t = _check(dict(x1=x1, x2=x2), dict(x1=(n, nx), x2=(n, nx)), dtype, device)
    out = torch.empty((n, solver.space.ndx), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_state_difference_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ocp.nq, ocp.nv, t["x1"].data_ptr(), t["x2"].data_ptr(), n, out.data_ptr(),
                 _stream(device))
    _raise_on(err, "state_difference")
    return out


def state_difference_plain(solver, x1, x2):
    """Plain twin of `state_difference`: the state space's difference."""
    return solver.space.difference(x1, x2)


def state_difference(solver, x1, x2):
    """difference(x1, x2) of the solver's state space on N lanes: x1, x2
    (N,nx) -> (N,ndx) (csrc/linesearch.cu, every multibody model;
    `vector_state_difference` for a centroidal OCP).  The solver's initial
    gap before its first iteration."""
    dev = x1.device
    if dev.type == "cpu":
        return state_difference_plain(solver, x1, x2)
    if _is_centroidal(solver.ocp) and dev.type == "cuda":
        return vector_state_difference(solver, x1, x2)
    if dev.type == "cuda":
        out = _difference_cuda(solver, x1, x2)
        state_difference.launches += 1
        return out
    raise RuntimeError(f"state_difference: no kernel for device {dev}")


state_difference.launches = 0


def _term_al_cost(ocp, x, p, lam_term, mu):
    """The terminal AL cost 0.5 sum w r^2 + 0.5/mu |g + mu lam|^2 per lane."""
    r, w = ocp.term_residuals(x, p)
    g = ocp.term_eq_constraints(x, p)
    rg = g + mu[:, None] * lam_term
    return (0.5 * torch.sum(w * r * r, dim=-1)
            + 0.5 / mu * torch.sum(rg * rg, dim=-1))


def _merit_from(costs, gaps, x0_gap, term_cost, mu):
    """The AL merit: stage costs, terminal cost, gap and x0-gap penalties."""
    gap_pen = 0.5 / mu * torch.sum(gaps * gaps, dim=(1, 2))
    return (torch.sum(costs, dim=1) + term_cost + gap_pen
            + 0.5 / mu * torch.sum(x0_gap * x0_gap, dim=-1))


def _candidate_merits(solver, xs_c, costs, gap, tp, x0, lam_term, mu):
    """The twin's merit of every candidate, NaN -> +inf (B, nA), and their
    x0 gaps (B*nA, ndx)."""
    nb, na = xs_c.shape[:2]
    xs_f = xs_c.reshape((nb * na,) + xs_c.shape[2:])
    mu_c = _repeat(mu, na)
    term = _term_al_cost(solver.ocp, xs_f[:, -1], tree_map(lambda a: _repeat(a, na), tp),
                         _repeat(lam_term, na), mu_c)
    x0_gap = solver.space.difference(xs_f[:, 0], _repeat(x0, na))
    m = _merit_from(costs, gap, x0_gap, term, mu_c).reshape(nb, na)
    # NaN-poisoned candidates lose to every finite merit
    return torch.where(torch.isnan(m), math.inf, m), x0_gap


def line_search_select_plain(solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in,
                             lam_term, mu, eta, omega, dual_res, alphas) -> LineSearch:
    """Plain PyTorch twin of the line search and the BCL update: the merit
    of every candidate (its stage costs, g, h and gaps from K1, its
    terminal AL cost and x0 gap here), NaN -> +inf, the argmin per
    scenario, the pick, prim, the BCL schedule of the solver's settings and
    the gated multiplier updates (JAX proxddp.py 527-600).  xs_c
    (B,nA,T+1,nx), us_c (B,nA,T,nu); costs (B*nA,T), g, h, gap
    (B*nA,T,...); tp terminal params and x0 (B,nx) per scenario; lam_eq,
    lam_in, lam_term, mu, eta, omega and dual_res (B,...); alphas (nA,)."""
    ocp, st = solver.ocp, solver.settings
    nb, na = xs_c.shape[:2]
    device = xs_c.device
    tol = float(st.tol)
    mu_floor = math.sqrt(torch.finfo(xs_c.dtype).eps)
    m, x0_gap = _candidate_merits(solver, xs_c, costs, gap, tp, x0, lam_term, mu)
    best = torch.argmin(m, dim=1)
    rows = torch.arange(nb, device=device)

    def pick(a):
        return a.reshape((nb, na) + a.shape[1:])[rows, best]

    xs, us = xs_c[rows, best], us_c[rows, best]
    g_all, h_all, gaps = pick(g), pick(h), pick(gap)
    g_term = ocp.term_eq_constraints(xs[:, -1], tp)
    prim = torch.amax(torch.abs(gaps), dim=(1, 2))
    if ocp.n_eq:
        prim = torch.maximum(prim, torch.amax(torch.abs(g_all), dim=(1, 2)))
    if ocp.n_in:
        prim = torch.maximum(prim, torch.amax(torch.clamp(h_all, min=0.0), dim=(1, 2)))
    if ocp.n_term_eq:
        prim = torch.maximum(prim, torch.amax(torch.abs(g_term), dim=1))

    # BCL outer loop (LANCELOT schedule), per scenario
    if st.bcl:
        omega = torch.where(omega < 0, torch.clamp(
            dual_res * st.bcl_omega_init, min=tol), omega)
        dual_ok = dual_res <= omega
        ok = dual_ok & (prim <= eta)
        fail = dual_ok & (prim > eta)
        mu_n = torch.where(fail, torch.clamp(mu * st.bcl_mu_factor, min=mu_floor), mu)
        eta_n = torch.where(
            ok, torch.clamp(eta * st.bcl_eta_shrink, min=tol),
            torch.where(fail, torch.clamp(mu_n ** st.bcl_alpha, min=tol), eta))
        omega_n = torch.where(
            ok, torch.clamp(omega * st.bcl_omega_shrink, min=tol),
            torch.where(fail, omega / st.bcl_mu_factor, omega))
    else:
        ok = torch.ones(nb, dtype=torch.bool, device=device)
        mu_n, eta_n, omega_n = mu, eta, omega
    okc = ok[:, None, None]
    lam_eq = torch.where(okc, lam_eq + g_all / mu[:, None, None], lam_eq)
    # projection keeps the inequality multipliers in the dual cone
    lam_in = torch.where(okc, torch.clamp(lam_in + h_all / mu[:, None, None], min=0.0), lam_in)
    lam_term = torch.where(ok[:, None], lam_term + g_term / mu[:, None], lam_term)
    return LineSearch(xs=xs, us=us, alpha=alphas[best], merit=m[rows, best], prim=prim,
                      lam_eq=lam_eq, lam_in=lam_in, lam_term=lam_term, mu=mu_n, eta=eta_n,
                      omega=omega_n, dx0=pick(x0_gap))


def _bcl_consts(solver, dtype):
    """linesearch.cu `Bcl`: the schedule's constants as host doubles."""
    st = solver.settings
    vals = (st.tol, math.sqrt(torch.finfo(dtype).eps), st.bcl_alpha, st.bcl_mu_factor,
            st.bcl_eta_shrink, st.bcl_omega_init, st.bcl_omega_shrink, float(st.bcl))
    return (ctypes.c_double * len(vals))(*map(float, vals))


def _select_cuda(solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in, lam_term, mu,
                 eta, omega, dual_res, alphas, wide, centroidal=False):
    ocp = solver.ocp
    dtype, device = xs_c.dtype, xs_c.device
    nb, na, T1, nx = xs_c.shape
    T, nu, ndx = T1 - 1, ocp.nu, solver.space.ndx
    n_eq, n_in, n_te = ocp.n_eq, ocp.n_in, ocp.n_term_eq
    if na > LS_MAX_ALPHAS or n_te > LS_MAX_TERM_EQ:
        raise NotImplementedError(
            f"line_search_select takes at most {LS_MAX_ALPHAS} step sizes and "
            f"{LS_MAX_TERM_EQ} terminal equalities, got {na} and {n_te}")
    if centroidal:
        C, dims = _centroidal_consts(ocp, dtype, device)
        x_ref, dcm_ref = _centroidal_term_refs(tp), tp.com_ref
    else:
        C, dims = _stage_consts(ocp, dtype, device, wide)
        x_ref, dcm_ref = tp.x_ref, tp.dcm_ref
    n = nb * na
    shapes = dict(xs_c=(nb, na, T1, nx), us_c=(nb, na, T, nu), costs=(n, T),
                  g=(n, T, n_eq), h=(n, T, n_in), gap=(n, T, ndx), x_ref=(nb, nx),
                  dcm_ref=(nb, 3), x0=(nb, nx), lam_eq=(nb, T, n_eq), lam_in=(nb, T, n_in),
                  lam_term=(nb, n_te), mu=(nb,), eta=(nb,), omega=(nb,), dual=(nb,),
                  alphas=(na,))
    t = _check(dict(xs_c=xs_c, us_c=us_c, costs=costs, g=g, h=h, gap=gap, x_ref=x_ref,
                    dcm_ref=dcm_ref, x0=x0, lam_eq=lam_eq, lam_in=lam_in,
                    lam_term=lam_term, mu=mu, eta=eta, omega=omega, dual=dual_res,
                    alphas=alphas), shapes, dtype, device)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    out = LineSearch(xs=empty(nb, T1, nx), us=empty(nb, T, nu), alpha=empty(nb),
                     merit=empty(nb), prim=empty(nb), lam_eq=empty(nb, T, n_eq),
                     lam_in=empty(nb, T, n_in), lam_term=empty(nb, n_te), mu=empty(nb),
                     eta=empty(nb), omega=empty(nb), dx0=empty(nb, ndx))
    ins = (ctypes.c_void_p * len(shapes))(*[t[k].data_ptr() for k in shapes])
    outs = (ctypes.c_void_p * len(out))(*[o.data_ptr() for o in out])
    name = ("centroidal_line_search_select" if centroidal
            else f"{'wide_' if wide else ''}line_search_select")
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), _bcl_consts(solver, dtype), ins, nb,
                 na, T, outs, _stream(device))
    _raise_on(err, name)
    return out


def line_search_select(solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in,
                       lam_term, mu, eta, omega, dual_res, alphas) -> LineSearch:
    """K4's line search and the BCL update: `line_search_select_plain`'s
    contract (csrc/linesearch.cu), new tensors throughout.  At most
    LS_MAX_ALPHAS step sizes on the card.  An OCP that `stage_route` sends
    to the wide stage kernels goes to `wide_line_search_select`, a
    centroidal one to `centroidal_line_search_select`."""
    args = (solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in, lam_term, mu,
            eta, omega, dual_res, alphas)
    dev = xs_c.device
    if dev.type == "cpu":
        return line_search_select_plain(*args)
    if dev.type == "cuda":
        route = stage_route(solver.ocp)
        if route == "centroidal":
            return centroidal_line_search_select(*args)
        if route == "wide":
            return wide_line_search_select(*args)
        out = _select_cuda(*args, wide=False)
        line_search_select.launches += 1
        return out
    raise RuntimeError(f"line_search_select: no kernel for device {dev}")


line_search_select.launches = 0


def wide_line_search_select(solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in,
                            lam_term, mu, eta, omega, dual_res, alphas) -> LineSearch:
    """K4's line search and the BCL update at wide shapes
    (csrc/linesearch_wide.cu): `line_search_select`'s contract."""
    args = (solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in, lam_term, mu,
            eta, omega, dual_res, alphas)
    dev = xs_c.device
    if dev.type == "cpu":
        return line_search_select_plain(*args)
    if dev.type == "cuda":
        out = _select_cuda(*args, wide=True)
        wide_line_search_select.launches += 1
        return out
    raise RuntimeError(f"wide_line_search_select: no kernel for device {dev}")


wide_line_search_select.launches = 0


# ---------------------------------------------------------------------------
# The centroidal formulation: its stage, terminal and ODE kernels, the
# vector-space integrate and gap, and its line-search select
# ---------------------------------------------------------------------------

_cent_cache: dict = {}


def _centroidal_consts(ocp, dtype, device):
    """(packed constants, Dims) of csrc/centroidal.cu (`smpc_cent::Dims`):
    the cost and terminal weights, gravity, the cone matrix and [mass,
    timestep, pyramid epsilon], built once per (OCP, dtype, device)."""
    key = (id(ocp), dtype, device)
    hit = _cent_cache.get(key)
    if hit is not None and hit[0] is ocp:
        return hit[1], hit[2]
    _require_centroidal(ocp)
    c = ocp._const(torch.empty(0, dtype=torch.float64))
    blocks = dict(o_w=_np64(c["w"]), o_wterm=_np64(c["w_term"]), o_g=_np64(c["g"]),
                  o_cone=_np64(c["cone"]),
                  o_scalars=np.array([ocp.mass, ocp.settings.timestep, FRICTION_EPS]))
    dims = dict(nq=9, nv=0, nu=ocp.nu, nk=ocp.nk, fs=ocp.fs, n_cone=c["cone"].shape[0],
                n_cost=blocks["o_w"].shape[0], n_eq=ocp.n_eq, n_in=ocp.n_in,
                n_term_cost=blocks["o_wterm"].shape[0], n_term_eq=ocp.n_term_eq)
    buf, dims_c = _pack_consts(dims, blocks, dtype, device, _CENT_DIMS_FIELDS)
    _cent_cache[key] = (ocp, buf, dims_c)
    return buf, dims_c


def _centroidal_params(ocp, sp, nb, T, dtype, device):
    """Pointers to the centroidal stage params (leading (B, T)), checked and
    contiguous, in the kernels' order."""
    nk = ocp.nk
    shapes = dict(contact_active=(nb, T, nk), contact_pose=(nb, T, nk, 3),
                  com_ref=(nb, T, 3), u_ref=(nb, T, ocp.nu), linmom_ref=(nb, T, 3),
                  angmom_ref=(nb, T, 3))
    t = _check({k: getattr(sp, k) for k in shapes}, shapes, dtype, device)
    return [t[k].data_ptr() for k in shapes]


def _centroidal_term_refs(tp):
    """The terminal params as the select's x_ref [com_ref; linmom_ref;
    angmom_ref] (B, 9)."""
    return torch.cat([tp.com_ref, tp.linmom_ref, tp.angmom_ref], dim=-1)


def _centroidal_linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    C, dims = _centroidal_consts(ocp, dtype, device)
    nb, T = us.shape[:2]
    nu = ocp.nu
    shapes = dict(xs=(nb, T + 1, 9), us=(nb, T, nu), lam_in=(nb, T, ocp.n_in), mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_in=lam_in, mu=mu), shapes, dtype, device)
    params = _centroidal_params(ocp, sp, nb, T, dtype, device)
    su = solver._su(xs)
    out = dict(A=(nb, T, 9, 9), B=(nb, T, 9, nu), d=(nb, T, 9), qx=(nb, T, 9),
               qu=(nb, T, nu), Qxx=(nb, T, 9, 9), Quu=(nb, T, nu, nu), Qux=(nb, T, nu, 9))
    out = {k: torch.empty(v, dtype=dtype, device=device) for k, v in out.items()}
    fn = getattr(_library(), f"smpc_centroidal_stage_linearize_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), t["xs"].data_ptr(), t["us"].data_ptr(),
                 *params, t["lam_in"].data_ptr(), t["mu"].data_ptr(),
                 None if su is None else su.data_ptr(), nb, T,
                 *[v.data_ptr() for v in out.values()], _stream(device))
    _raise_on(err, "centroidal_stage_linearize")
    return out


def centroidal_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """The centroidal stage's K1+K2 (csrc/centroidal.cu): `stage_linearize`'s
    contract on a CentroidalOCP (nx = ndx = 9, no equality rows).  The twin
    is the `torch.func` sweep over `CentroidalOCP.stage_eval_soa`."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _centroidal_linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        centroidal_stage_linearize.launches += 1
        return out
    raise RuntimeError(f"centroidal_stage_linearize: no kernel for device {dev}")


centroidal_stage_linearize.launches = 0


def _centroidal_eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    C, dims = _centroidal_consts(ocp, dtype, device)
    nb, na, T = us.shape[:3]
    shapes = dict(xs=(nb, na, T + 1, 9), us=(nb, na, T, ocp.nu), lam_in=(nb, T, ocp.n_in),
                  mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_in=lam_in, mu=mu), shapes, dtype, device)
    params = _centroidal_params(ocp, sp, nb, T, dtype, device)
    n = nb * na
    costs, h, gap = (torch.empty(s, dtype=dtype, device=device)
                     for s in ((n, T), (n, T, ocp.n_in), (n, T, 9)))
    fn = getattr(_library(), f"smpc_centroidal_stage_eval_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), t["xs"].data_ptr(), t["us"].data_ptr(),
                 *params, t["lam_in"].data_ptr(), t["mu"].data_ptr(), nb, na, T,
                 costs.data_ptr(), h.data_ptr(), gap.data_ptr(), _stream(device))
    _raise_on(err, "centroidal_stage_eval")
    return costs, torch.empty((n, T, 0), dtype=dtype, device=device), h, gap


def centroidal_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """The centroidal stage's K1 on the candidates (csrc/centroidal.cu):
    `stage_eval`'s contract on a CentroidalOCP."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _centroidal_eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        centroidal_stage_eval.launches += 1
        return out
    raise RuntimeError(f"centroidal_stage_eval: no kernel for device {dev}")


centroidal_stage_eval.launches = 0


def _centroidal_term_cuda(solver, x, tp, lam_term, mu):
    ocp = solver.ocp
    dtype, device = x.dtype, x.device
    C, dims = _centroidal_consts(ocp, dtype, device)
    nb = x.shape[0]
    shapes = dict(x=(nb, 9), linmom_ref=(nb, 3), angmom_ref=(nb, 3))
    t = _check(dict(x=x, linmom_ref=tp.linmom_ref, angmom_ref=tp.angmom_ref), shapes,
               dtype, device)
    Vx = torch.empty((nb, 9), dtype=dtype, device=device)
    Vxx = torch.empty((nb, 9, 9), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_centroidal_term_linearize_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes], nb,
                 Vx.data_ptr(), Vxx.data_ptr(), _stream(device))
    _raise_on(err, "centroidal_term_linearize")
    return Vx, Vxx


def centroidal_term_linearize(solver, x, tp, lam_term, mu):
    """The centroidal terminal K5 (csrc/centroidal.cu): `term_linearize`'s
    contract on a CentroidalOCP (the 6 momentum rows, no equality)."""
    dev = x.device
    if dev.type == "cpu":
        return _linearize_term_plain(solver, x, tp, lam_term, mu)
    if dev.type == "cuda":
        out = _centroidal_term_cuda(solver, x, tp, lam_term, mu)
        centroidal_term_linearize.launches += 1
        return out
    raise RuntimeError(f"centroidal_term_linearize: no kernel for device {dev}")


centroidal_term_linearize.launches = 0


def centroidal_state_derivative_plain(ocp, x, u, p):
    """Plain twin of `centroidal_state_derivative`: `CentroidalOCP._ode_soa`
    on N lanes."""
    P = tree_map(lambda a: a.movedim(0, -1), p)
    return ocp._ode_soa(x.T, u.T, P).T


def _centroidal_ode_cuda(ocp, x, u, p):
    dtype, device = x.dtype, x.device
    C, dims = _centroidal_consts(ocp, dtype, device)
    n = x.shape[0]
    shapes = dict(x=(n, 9), u=(n, ocp.nu), active=(n, ocp.nk), pose=(n, ocp.nk, 3))
    t = _check(dict(x=x, u=u, active=p.contact_active, pose=p.contact_pose), shapes, dtype,
               device)
    out = torch.empty((n, 9), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_centroidal_ode_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes], n,
                 out.data_ptr(), _stream(device))
    _raise_on(err, "centroidal_state_derivative")
    return out


def centroidal_state_derivative(ocp, x, u, p):
    """The centroidal ODE [h/m; sum f + m g; tau] on N lanes
    (csrc/centroidal.cu, `MPC.get_state_derivative`).  x (N,9), u (N,nu), p
    stage params with leading N (the kernel reads contact_active and
    contact_pose).  Returns (N, 9)."""
    dev = x.device
    if dev.type == "cpu":
        return centroidal_state_derivative_plain(ocp, x, u, p)
    if dev.type == "cuda":
        out = _centroidal_ode_cuda(ocp, x, u, p)
        centroidal_state_derivative.launches += 1
        return out
    raise RuntimeError(f"centroidal_state_derivative: no kernel for device {dev}")


centroidal_state_derivative.launches = 0


def _vector_integrate_cuda(solver, xs, us, dxs, dus):
    dtype, device = xs.dtype, xs.device
    nb, na, T1, nx = dxs.shape
    T, nu = T1 - 1, solver.ocp.nu
    shapes = dict(xs=(nb, T1, nx), us=(nb, T, nu), dxs=(nb, na, T1, nx), dus=(nb, na, T, nu))
    t = _check(dict(xs=xs, us=us, dxs=dxs, dus=dus), shapes, dtype, device)
    su = solver._su(xs)
    xs_c = torch.empty((nb, na, T1, nx), dtype=dtype, device=device)
    us_c = torch.empty((nb, na, T, nu), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_vector_candidate_integrate_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(nx, nu, *[t[k].data_ptr() for k in shapes],
                 None if su is None else su.data_ptr(), nb, na, T, xs_c.data_ptr(),
                 us_c.data_ptr(), _stream(device))
    _raise_on(err, "vector_candidate_integrate")
    return xs_c, us_c


def vector_candidate_integrate(solver, xs, us, dxs, dus):
    """K4's integrate of the rollout's steps on a vector space
    (csrc/centroidal.cu): xs + dxs, us + su dus;
    `candidate_integrate_plain`'s contract."""
    dev = xs.device
    if dev.type == "cpu":
        return candidate_integrate_plain(solver, xs, us, dxs, dus)
    if dev.type == "cuda":
        out = _vector_integrate_cuda(solver, xs, us, dxs, dus)
        vector_candidate_integrate.launches += 1
        return out
    raise RuntimeError(f"vector_candidate_integrate: no kernel for device {dev}")


vector_candidate_integrate.launches = 0


def vector_state_difference(solver, x1, x2):
    """x2 - x1 on a vector space on N lanes (csrc/centroidal.cu): x1, x2
    (N,nx) -> (N,nx); `state_difference`'s contract."""
    dev = x1.device
    if dev.type == "cpu":
        return state_difference_plain(solver, x1, x2)
    if dev.type == "cuda":
        n, nx = x1.shape
        t = _check(dict(x1=x1, x2=x2), dict(x1=(n, nx), x2=(n, nx)), x1.dtype, dev)
        out = torch.empty((n, nx), dtype=x1.dtype, device=dev)
        fn = getattr(_library(), f"smpc_vector_state_difference_{_suffix(x1.dtype)}")
        with torch.cuda.device(dev):
            err = fn(nx, t["x1"].data_ptr(), t["x2"].data_ptr(), n, out.data_ptr(),
                     _stream(dev))
        _raise_on(err, "vector_state_difference")
        vector_state_difference.launches += 1
        return out
    raise RuntimeError(f"vector_state_difference: no kernel for device {dev}")


vector_state_difference.launches = 0


def centroidal_line_search_select(solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq,
                                  lam_in, lam_term, mu, eta, omega, dual_res,
                                  alphas) -> LineSearch:
    """K4's line search and the BCL update on a CentroidalOCP
    (csrc/linesearch_centroidal.cu): `line_search_select`'s contract, with
    the terminal AL cost of the 6 momentum rows."""
    args = (solver, xs_c, us_c, costs, g, h, gap, tp, x0, lam_eq, lam_in, lam_term, mu,
            eta, omega, dual_res, alphas)
    dev = xs_c.device
    if dev.type == "cpu":
        return line_search_select_plain(*args)
    if dev.type == "cuda":
        out = _select_cuda(*args, wide=False, centroidal=True)
        centroidal_line_search_select.launches += 1
        return out
    raise RuntimeError(f"centroidal_line_search_select: no kernel for device {dev}")


centroidal_line_search_select.launches = 0


# ---------------------------------------------------------------------------
# K9: the fused tick's bookkeeping
# ---------------------------------------------------------------------------

EMPTY = 2**30  # sentinel of an empty event-queue slot (int32)
TICK_MAX_QUEUE = 16  # tick.cu kMaxQueue: slots of a foot's event queue
WALKING = 0  # mpc.WALKING


class TickRefs(NamedTuple):
    walking: torch.Tensor  # (B,) bool
    takeoff: torch.Tensor  # (B, nk, QMAX) int32
    land: torch.Tensor  # (B, nk, QMAX) int32
    p_init: torch.Tensor  # (B, nk, 3) swing Bezier endpoints
    p_final: torch.Tensor  # (B, nk, 3)
    refs: torch.Tensor  # (B, T, nk, 3) foot references of every stage
    com_ref: torch.Tensor  # (B, 3) terminal-constraint CoM target


def queue_tick(q, dec_mask, append_flag, append_val):
    """Append (pre-decrement, as in recedeWithCycle) -> decrement -> pop the
    head if negative, on int32 queues (..., QMAX) sorted ascending with
    EMPTY padding (simple_mpc_tpu/mpc/fused.py `_queue_tick`)."""
    valid = q < EMPTY // 2
    n_valid = torch.sum(valid, dim=-1)
    slot = torch.arange(q.shape[-1], device=q.device)
    q = torch.where((slot == n_valid[..., None]) & append_flag[..., None],
                    append_val, q)
    valid = q < EMPTY // 2
    q = torch.where(valid & dec_mask, q - 1, q)
    pop = q[..., 0] < 0
    shifted = torch.cat([q[..., 1:], torch.full_like(q[..., :1], EMPTY)], dim=-1)
    return torch.where(pop[..., None], shifted, q)


def tick_refs_plain(fused, carry, x_meas):
    """Plain PyTorch twin of K9 with the scenario axis leading every carry
    leaf: measured-state kinematics, walking, the queue ticks, the Raibert
    footsteps and the swing references (simple_mpc_tpu/mpc/fused.py
    183-246)."""
    # imported here: the mpc package imports the solver, which imports this
    # module
    from .mpc.foot_trajectory import sample_swing_batched

    m, s, nk, T = fused.model, fused.settings, fused.nk, fused.T
    L = carry.plan.shape[1]
    oR, op = soa.fk_world(m, x_meas[:, : m.nq].T)
    _, fp = soa.frame_placements_world(m, oR, op, fused.frame_ids)
    fp = fp.permute(2, 0, 1)  # (B, feet + refs + base, 3)
    foot_p, ref_p, base_p = fp[:, :nk], fp[:, nk: 2 * nk], fp[:, 2 * nk]

    support_last = torch.sum(carry.stage_params.contact_active[:, T - 1], dim=-1)
    walking = (carry.now == WALKING) | (support_last < nk)
    w = walking[:, None]
    plan = torch.where(walking[:, None, None], torch.roll(carry.plan, -1, 1), carry.plan)
    tail, prev = plan[:, L - 1] > 0.5, plan[:, L - 2] > 0.5
    takeoff = queue_tick(carry.takeoff, w[..., None] | (carry.takeoff < T),
                         w & ~tail & prev, L + T)
    land = queue_tick(carry.land, w[..., None] | (carry.land < T),
                      w & tail & ~prev, L + T)

    land_head = torch.where(land[..., 0] < EMPTY // 2, land[..., 0], -1)
    update = (land_head >= s.T_fly)[..., None]
    twist = torch.stack([-(ref_p[..., 1] - base_p[:, None, 1]),
                         ref_p[..., 0] - base_p[:, None, 0]], dim=-1)
    vb = carry.velocity_base[:, None]
    horiz = (vb[..., :2] + vb[..., 5:6] * twist) * ((s.T_fly + s.T_contact) * s.timestep)
    next_pose = torch.cat([ref_p[..., :2] + horiz, foot_p[..., 2:3]], dim=-1)
    p_init = torch.where(update, foot_p, carry.p_init)
    p_final = torch.where(update, next_pose, carry.p_final)
    refs = sample_swing_batched(p_init, p_final, s.swing_apex, land_head, s.T_fly,
                                T).transpose(1, 2)
    com_ref = torch.mean(refs[:, T - 1], dim=1)
    com_ref = torch.cat([com_ref[:, :2], com_ref[:, 2:] + carry.com0_z[:, None]], dim=1)
    return TickRefs(walking, takeoff, land, p_init, p_final, refs, com_ref)


def _tick_cuda(fused, carry, x_meas, wide=False):
    ocp, s = fused.ocp, fused.settings
    dtype, device = x_meas.dtype, x_meas.device
    nb, L, nk = carry.plan.shape
    T, qmax = fused.T, carry.takeoff.shape[-1]
    if qmax > TICK_MAX_QUEUE:
        raise NotImplementedError(f"tick_refs takes at most {TICK_MAX_QUEUE} events a foot "
                                  f"queue, got {qmax}")
    if wide and ocp.full_dynamics:
        raise NotImplementedError("the wide fused tick takes a kinodynamics OCP; "
                                  "its full-dynamics instance is not ported")
    C, dims = _stage_consts(ocp, dtype, device, wide)
    shapes = dict(x=(nb, ocp.nq + ocp.nv), active_last=(nb, nk), now=(nb,),
                  plan=(nb, L, nk), takeoff=(nb, nk, qmax), land=(nb, nk, qmax),
                  p_init=(nb, nk, 3), p_final=(nb, nk, 3), vbase=(nb, 6), com0_z=(nb,))
    t = _check(dict(x=x_meas, active_last=carry.stage_params.contact_active[:, T - 1],
                    now=carry.now, plan=carry.plan, takeoff=carry.takeoff,
                    land=carry.land, p_init=carry.p_init, p_final=carry.p_final,
                    vbase=carry.velocity_base, com0_z=carry.com0_z),
               shapes, dtype, device, ints=("now", "takeoff", "land"))

    def empty(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    out = TickRefs(empty((nb,), torch.int32), empty((nb, nk, qmax), torch.int32),
                   empty((nb, nk, qmax), torch.int32), empty((nb, nk, 3)),
                   empty((nb, nk, 3)), empty((nb, T, nk, 3)), empty((nb, 3)))
    name = f"{'wide_' if wide else ''}tick_refs"
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb, T, L, qmax, EMPTY,
                 s.T_fly, float((s.T_fly + s.T_contact) * s.timestep),
                 float(s.swing_apex), *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, name)
    return out._replace(walking=out.walking != 0)


def tick_refs(fused, carry, x_meas):
    """K9.  carry: an `MPCCarry` with the scenario axis leading every leaf;
    x_meas (B,nx).  Returns `TickRefs`.  An OCP that `stage_route` sends
    to the wide stage kernels goes to `wide_tick_refs` on the card."""
    dev = x_meas.device
    if dev.type == "cpu":
        return tick_refs_plain(fused, carry, x_meas)
    if dev.type == "cuda":
        if stage_route(fused.ocp) == "wide":
            return wide_tick_refs(fused, carry, x_meas)
        out = _tick_cuda(fused, carry, x_meas)
        tick_refs.launches += 1
        return out
    raise RuntimeError(f"tick_refs: no kernel for device {dev}")


tick_refs.launches = 0


def wide_tick_refs(fused, carry, x_meas):
    """K9 at wide shapes (csrc/tick_wide.cu): `tick_refs`' contract for
    6D contacts and up to WIDE_MAX_JOINTS joints (a kinodynamics OCP that
    `stage_route` accepts), MAX_FEET feet and TICK_MAX_QUEUE events a foot
    queue."""
    dev = x_meas.device
    if dev.type == "cpu":
        return tick_refs_plain(fused, carry, x_meas)
    if dev.type == "cuda":
        out = _tick_cuda(fused, carry, x_meas, wide=True)
        wide_tick_refs.launches += 1
        return out
    raise RuntimeError(f"wide_tick_refs: no kernel for device {dev}")


wide_tick_refs.launches = 0


# ---------------------------------------------------------------------------
# The closed loop's kernels: K8 (qp_admm, id_assemble) and K10 (sim_step)
# ---------------------------------------------------------------------------

QP_MAX_N = 64  # qp.cu kMaxN: variables (Go2 30, Talos 40)
QP_MAX_M = 256  # qp.cu kMaxM: constraint rows (Go2 66, Talos 98; 78 and 110 with motion equalities)
_body_cache: dict = {}


def body_route(model, nk: int, fs: int = 3, what: str = "the rigid-body kernels") -> str:
    """Which unit takes the rigid-body kernels (`id_assemble`, `sim_step`)
    of a model with nk contacts of force size fs: "narrow" (csrc/id.cu,
    csrc/sim.cu) for point feet and at most MAX_JOINTS joints, "wide"
    (csrc/id_wide.cu, csrc/sim_wide.cu) for force size 3 or 6 and at most
    WIDE_MAX_JOINTS joints.  Raises NotImplementedError beyond those."""
    _require_body_layout(model, nk, what, max_joints=WIDE_MAX_JOINTS)
    if fs == 3 and model.njoints <= MAX_JOINTS:
        return "narrow"
    if fs not in (3, 6):
        raise NotImplementedError(f"{what} take force size 3 or 6, got {fs}")
    return "wide"


def _body_consts(model, frame_ids, nk, dtype, device, kp=0.0, kd=0.0, prox=1e-9, fs=3,
                 wide=False):
    """(packed constants, Dims) of the rigid-body kernels csrc/id.cu and
    csrc/sim.cu, or with `wide` of csrc/id_wide.cu and csrc/sim_wide.cu
    (`smpc_wide::Dims`): the model's joint tree and inertias, the selected
    frames `frame_ids` (the nk feet first, then any other frame), the
    contacts' force size fs, the Baumgarte gains kp, kd on every one of
    their fs nk rows and the Delassus diagonal's proximal term
    max(prox, 50 eps(dtype)), as `constrained_fwd_dynamics_soa` takes it."""
    tab = _world.tables(model)
    key = (id(model), id(tab), tuple(frame_ids), nk, kp, kd, prox, fs, wide, dtype, device)
    hit = _body_cache.get(key)
    if hit is not None and hit[0] is tab:
        return hit[1], hit[2]
    nj = model.njoints
    axes = np.zeros((nj, 3))
    prism = np.zeros(nj)
    axes[tab.one_dof] = tab.axes
    prism[tab.one_dof] = tab.is_prismatic
    sel = np.asarray(frame_ids)
    blocks = dict(
        o_jR=tab.jR, o_jp=tab.jp, o_axis=axes, o_prism=prism, o_mass=tab.masses,
        o_com=tab.coms, o_Iloc=tab.I_loc, o_fR=tab.fR[sel], o_fp=tab.fp[sel],
        o_scalars=np.array([tab.total_mass, 0.0, 0.0, 0.0]),
        o_kp=np.full(fs * nk, float(kp)), o_kd=np.full(fs * nk, float(kd)),
        o_Icom=soa_dyn._static_body_params(model)[2],
        o_grav=np.asarray(model.gravity, np.float64),
        o_prox=np.array([max(prox, 50.0 * torch.finfo(dtype).eps)]))
    dims = dict(nj=nj, nq=model.nq, nv=model.nv, nu=model.nv - 6, nk=nk, fs=fs,
                kp_on=int(kp != 0.0), parent=list(model.parents), qidx=list(model.idx_q),
                vidx=list(model.idx_v), frame_parent=[int(tab.fparent[f]) for f in sel])
    buf, dims_c = _pack_consts(dims, blocks, dtype, device,
                               _WIDE_DIMS_FIELDS if wide else _DIMS_FIELDS)
    _body_cache[key] = (tab, buf, dims_c)
    return buf, dims_c


def _qp_cuda(H, g, A, l, u, iters, rho, sigma, alpha, z0, y0):
    dtype, device = H.dtype, H.device
    nb, m, n = A.shape
    if n > QP_MAX_N or m > QP_MAX_M:
        raise NotImplementedError(f"qp_admm takes at most {QP_MAX_N} variables and "
                                  f"{QP_MAX_M} rows, got {n} and {m}")
    shapes = dict(H=(nb, n, n), g=(nb, n), A=(nb, m, n), l=(nb, m), u=(nb, m))
    warm = dict(z0=(z0, (nb, n)), y0=(y0, (nb, m)))
    shapes.update({k: s for k, (x, s) in warm.items() if x is not None})
    t = _check(dict(H=H, g=g, A=A, l=l, u=u,
                    **{k: x for k, (x, _) in warm.items() if x is not None}),
               shapes, dtype, device)
    out = QPSolution(*(torch.empty(s, dtype=dtype, device=device)
                       for s in ((nb, n), (nb, m), (nb,), (nb,))))
    fn = getattr(_library(), f"smpc_qp_admm_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(*[t[k].data_ptr() for k in ("H", "g", "A", "l", "u")],
                 *[t[k].data_ptr() if k in t else None for k in ("z0", "y0")],
                 nb, n, m, int(iters), float(rho), float(sigma), float(alpha),
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, "qp_admm")
    return out


def qp_admm(H, g, A, l, u, iters: int = 100, rho: float = 0.1, sigma: float = 1e-6,
            alpha: float = 1.6, z0=None, y0=None) -> QPSolution:
    """K8's QP: `iters` steps of over-relaxed ADMM on B problems.  H (B,n,n),
    g (B,n), A (B,m,n), l, u (B,m), optional warm start z0 (B,n), y0 (B,m).
    Returns `QPSolution` z (B,n), y (B,m), prim_res, dual_res (B,)."""
    dev = H.device
    if dev.type == "cpu":
        return solve_qp(H, g, A, l, u, iters, rho, sigma, alpha, z0, y0)
    if dev.type == "cuda":
        out = _qp_cuda(H, g, A, l, u, iters, rho, sigma, alpha, z0, y0)
        qp_admm.launches += 1
        return out
    raise RuntimeError(f"qp_admm: no kernel for device {dev}")


qp_admm.launches = 0

ID_OUT = ("H", "g", "A", "l", "u", "M", "h", "JcT")
_id_cache: dict = {}


def _is_centroidal_id(idsolver) -> bool:
    from .id.centroidal_id import CentroidalID

    return isinstance(idsolver, CentroidalID)


def _id_rows(idsolver) -> int:
    """Constraint rows of the ID's QP: the 6 base dynamics rows, the contact
    motion equalities (with `contact_motion_equality`), the inactive-force
    rows, the cones, the normal-force bounds, the joint and torque boxes."""
    nk, fd, nu = idsolver.nk, idsolver.fdim, idsolver.nu
    eq = nk * fd if idsolver.settings.contact_motion_equality else 0
    return 6 + eq + nk * fd + nk * idsolver.n_cone + nk + 2 * nu


def _id_params(idsolver, dtype, device):
    """The ID kernel's task constants (csrc/id.cu `IdParams` order) on
    `device`, made once per (ID, dtype, device)."""
    key = (id(idsolver), dtype, device)
    hit = _id_cache.get(key)
    if hit is not None and hit[0] is idsolver:
        return hit[1]
    s, m = idsolver.settings, idsolver.model
    kd = [2.0 * np.sqrt(k) for k in (s.kp_base, s.kp_posture)]
    kd.append(2.0 * np.sqrt(s.kp_contact) if s.kp_contact > 0 else 0.0)
    blocks = [
        [s.kp_base, s.kp_posture, s.kp_contact, *kd, s.w_base, s.w_posture,
         s.w_contact_motion, s.w_contact_force, idsolver.min_f, idsolver.max_f,
         idsolver.dt, idsolver.dt ** 2],
        np.asarray(idsolver._cone_mat).reshape(-1),
        m.velocity_limit[6:], m.lower_limit[7:], m.upper_limit[7:], m.effort_limit[6:]]
    if _is_centroidal_id(idsolver):  # csrc/id_centroidal.cu `CidParams`
        blocks.append([s.kp_com, 2.0 * np.sqrt(s.kp_com), s.w_com, s.kp_feet_tracking,
                       2.0 * np.sqrt(s.kp_feet_tracking), s.w_feet_tracking])
    flat = np.concatenate(blocks)
    buf = torch.as_tensor(flat, dtype=dtype, device=device)
    _id_cache[key] = (idsolver, buf)
    return buf


def _id_cuda(idsolver, q, v, targets, wide, centroidal=False):
    from .id.kinodynamics_id import KinodynamicsID

    if not centroidal and (type(idsolver)._extra_tasks is not KinodynamicsID._extra_tasks
                           or np.any(idsolver._base_mask != 1.0)):
        raise NotImplementedError("id_assemble takes the KinodynamicsID task set")
    m = idsolver.model
    dtype, device = q.dtype, q.device
    nb, nv, nk, fd, nz = q.shape[0], idsolver.nv, idsolver.nk, idsolver.fdim, idsolver.nz
    C, dims = _body_consts(m, idsolver.feet_fids + [idsolver.mh.base_frame_id], nk, dtype,
                           device, fs=fd, wide=wide)
    P = _id_params(idsolver, dtype, device)
    rows = _id_rows(idsolver)
    shapes = dict(q=(nb, m.nq), v=(nb, nv), q_t=(nb, m.nq), v_t=(nb, nv), a_t=(nb, nv),
                  contacts=(nb, nk), f_t=(nb, nk, fd))
    if centroidal:
        shapes.update(com_t=(nb, 3), com_v_t=(nb, 3), feet_p_t=(nb, nk, 3),
                      feet_R_t=(nb, nk, 3, 3), feet_v_t=(nb, nk, 6))
    t = _check(dict(q=q, v=v, **{k: targets[k] for k in shapes if k not in ("q", "v")}),
               shapes, dtype, device)
    out = {k: torch.empty(s, dtype=dtype, device=device) for k, s in (
        ("H", (nb, nz, nz)), ("g", (nb, nz)), ("A", (nb, rows, nz)), ("l", (nb, rows)),
        ("u", (nb, rows)), ("M", (nb, nv, nv)), ("h", (nb, nv)), ("JcT", (nb, nv, fd * nk)))}
    name = ("centroidal_id_assemble" if centroidal
            else f"{'wide_' if wide else ''}id_assemble")
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), P.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb,
                 int(idsolver.settings.contact_motion_equality), idsolver.n_cone, rows,
                 *[out[k].data_ptr() for k in ID_OUT], _stream(device))
    _raise_on(err, name)
    return tuple(out[k] for k in ID_OUT)


def id_assemble(idsolver, q, v, targets):
    """K8's assembly: the inverse-dynamics QP of B robots (H, g, A, l, u)
    with M, h and Jc' for the torques.  q (B,nq), v (B,nv), targets
    q_t (B,nq), v_t, a_t (B,nv), contacts (B,nk), f_t (B,nk,fdim).  A
    model that `body_route` sends to the wide unit goes to
    `wide_id_assemble` on the card, a `CentroidalID` (its CoM and swing
    tasks, targets com_t, com_v_t, feet_p_t, feet_R_t, feet_v_t) to
    `centroidal_id_assemble`."""
    dev = q.device
    if dev.type == "cpu":
        return idsolver._assemble_core(q, v, targets)
    if dev.type == "cuda":
        if _is_centroidal_id(idsolver):
            return centroidal_id_assemble(idsolver, q, v, targets)
        if body_route(idsolver.model, idsolver.nk, idsolver.fdim, "id_assemble") == "wide":
            return wide_id_assemble(idsolver, q, v, targets)
        out = _id_cuda(idsolver, q, v, targets, wide=False)
        id_assemble.launches += 1
        return out
    raise RuntimeError(f"id_assemble: no kernel for device {dev}")


id_assemble.launches = 0


def wide_id_assemble(idsolver, q, v, targets):
    """K8's assembly at wide shapes (csrc/id_wide.cu): `id_assemble`'s
    contract for 6D contacts (the wrench-cone rows) and up to
    WIDE_MAX_JOINTS joints."""
    dev = q.device
    if dev.type == "cpu":
        return idsolver._assemble_core(q, v, targets)
    if dev.type == "cuda":
        body_route(idsolver.model, idsolver.nk, idsolver.fdim, "wide_id_assemble")
        out = _id_cuda(idsolver, q, v, targets, wide=True)
        wide_id_assemble.launches += 1
        return out
    raise RuntimeError(f"wide_id_assemble: no kernel for device {dev}")


wide_id_assemble.launches = 0


def centroidal_id_assemble(idsolver, q, v, targets):
    """K8's assembly for a `CentroidalID` (csrc/id_centroidal.cu, id.cu over
    stage_wide.cuh with the CoM and swing-foot rows and the orientation-only
    base task): `id_assemble`'s contract, point feet or 6D contacts, up to
    WIDE_MAX_JOINTS joints."""
    dev = q.device
    if dev.type == "cpu":
        return idsolver._assemble_core(q, v, targets)
    if dev.type == "cuda":
        body_route(idsolver.model, idsolver.nk, idsolver.fdim, "centroidal_id_assemble")
        out = _id_cuda(idsolver, q, v, targets, wide=True, centroidal=True)
        centroidal_id_assemble.launches += 1
        return out
    raise RuntimeError(f"centroidal_id_assemble: no kernel for device {dev}")


centroidal_id_assemble.launches = 0


def _sim_cuda(sim, q, v, tau, wide):
    from .sim.simulator import SimStep

    s, m = sim.settings, sim.model
    dtype, device = q.dtype, q.device
    nb, nk = q.shape[0], sim.nk
    C, dims = _body_consts(m, sim.feet_fids, nk, dtype, device, s.baumgarte_kp,
                           s.baumgarte_kd, wide=wide)
    shapes = dict(q=(nb, m.nq), v=(nb, m.nv), tau=(nb, m.nv - 6))
    t = _check(dict(q=q, v=v, tau=tau), shapes, dtype, device)
    out = SimStep(*(torch.empty(sh, dtype=dtype, device=device) for sh in (
        (nb, m.nq), (nb, m.nv), (nb, nk, 3), (nb, 2, nk))))
    name = f"{'wide_' if wide else ''}sim_step"
    fn = getattr(_library(), f"smpc_{name}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes],
                 nb, float(s.dt), float(s.ground_height), float(s.contact_margin),
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, name)
    return out


def sim_step(sim, q, v, tau):
    """K10: one step of the rigid-contact simulator for B robots.  q (B,nq),
    v (B,nv), tau (B,nu).  Returns `SimStep` q, v, the world contact forces
    f_w (B,nk,3) and the contact masks of the two solves (B,2,nk).  A model
    with more than MAX_JOINTS joints goes to `wide_sim_step` on the card
    (the contacts stay 3D points)."""
    dev = q.device
    if dev.type == "cpu":
        return sim.step_plain(q, v, tau)
    if dev.type == "cuda":
        if body_route(sim.model, sim.nk, 3, "sim_step") == "wide":
            return wide_sim_step(sim, q, v, tau)
        out = _sim_cuda(sim, q, v, tau, wide=False)
        sim_step.launches += 1
        return out
    raise RuntimeError(f"sim_step: no kernel for device {dev}")


sim_step.launches = 0


def wide_sim_step(sim, q, v, tau):
    """K10 at wide shapes (csrc/sim_wide.cu): `sim_step`'s contract for up
    to WIDE_MAX_JOINTS joints."""
    dev = q.device
    if dev.type == "cpu":
        return sim.step_plain(q, v, tau)
    if dev.type == "cuda":
        body_route(sim.model, sim.nk, 3, "wide_sim_step")
        out = _sim_cuda(sim, q, v, tau, wide=True)
        wide_sim_step.launches += 1
        return out
    raise RuntimeError(f"wide_sim_step: no kernel for device {dev}")


wide_sim_step.launches = 0


KERNELS = (stage_linearize, stage_eval, riccati_backward, parallel_riccati_backward,
           linear_rollout, term_linearize, tick_refs, fd_stage_linearize, fd_stage_eval,
           fd_dynamics, qp_admm, id_assemble, sim_step, wide_stage_linearize,
           wide_stage_eval, wide_term_linearize, state_derivative, wide_state_derivative,
           wide_id_assemble, wide_sim_step, candidate_integrate, state_difference,
           line_search_select, wide_line_search_select, wide_tick_refs,
           wide_fd_stage_linearize, wide_fd_stage_eval, wide_fd_dynamics,
           centroidal_stage_linearize, centroidal_stage_eval, centroidal_term_linearize,
           centroidal_state_derivative, vector_candidate_integrate, vector_state_difference,
           centroidal_line_search_select, centroidal_id_assemble)


def reset_launches():
    """Zero every kernel's launch counter."""
    for k in KERNELS:
        k.launches = 0
