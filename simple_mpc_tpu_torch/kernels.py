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
rollout scan.
K5 `term_linearize` (csrc/linearize.cu) replaces
`ProxDDPSolver._linearize_term`.
K9 `tick_refs` (csrc/tick.cu) replaces the bookkeeping of
`simple_mpc_tpu/mpc/fused.py` `FusedMPC._step` before the solve.
K8 `qp_admm` (csrc/qp.cu) replaces `simple_mpc_tpu/id/qp.py` `solve_qp`,
the ADMM QP of the inverse-dynamics layer (twin `id/qp.py`), and
`id_assemble` (csrc/id.cu) its assembly
`simple_mpc_tpu/id/kinodynamics_id.py` `KinodynamicsID._assemble_core`.
K10 `sim_step` (csrc/sim.cu) replaces `simple_mpc_tpu/sim/simulator.py`
`Simulator.step` (twin `Simulator.step_plain`); it and `id_assemble`
include K7's device code (csrc/fulldyn.cuh).
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
           "tick.cu", "qp.cu", "id.cu", "sim.cu")
HEADERS = ("stage.cuh", "fulldyn.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    h.update(" ".join(NVCC_FLAGS).encode())
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
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(s)],
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
            tick_refs=[P] * 12 + [I] * 6 + [D, D] + [P] * 8,
            qp_admm=[P] * 7 + [I] * 4 + [D] * 3 + [P] * 5,
            id_assemble=[P] * 10 + [I] * 4 + [P] * 9,
            sim_step=[P] * 5 + [I] + [D] * 3 + [P] * 5,
        )
        for name, args in signatures.items():
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"smpc_{name}_{dt}")
                fn.argtypes = args
                fn.restype = I
        lib.smpc_dims_ints.restype = I
        if lib.smpc_dims_ints() != _DIMS_INTS:
            raise RuntimeError(f"stage.cuh Dims holds {lib.smpc_dims_ints()} ints, "
                               f"kernels.py packs {_DIMS_INTS}")
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


def _riccati_cuda(lin: dict, Vx_T, Vxx_T, reg: float):
    dtype, device = Vx_T.dtype, Vx_T.device
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


def _parallel_riccati_cuda(lin: dict, Vx_T, Vxx_T, reg: float):
    dtype, device = Vx_T.dtype, Vx_T.device
    (nb, T, nx, nu), inputs, out = _backward_args(lin, Vx_T, Vxx_T)
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
    ceil(log2(T+1)) scan levels and the gain recovery."""
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
_DIMS_FIELDS = (
    ("nj", 1), ("nq", 1), ("nv", 1), ("nu", 1), ("nk", 1), ("fs", 1),
    ("n_cost", 1), ("n_eq", 1), ("n_in", 1), ("n_term_cost", 1), ("n_term_eq", 1),
    ("kin_limits", 1), ("force_cone", 1), ("land_cstr", 1),
    ("parent", MAX_JOINTS), ("qidx", MAX_JOINTS), ("vidx", MAX_JOINTS),
    ("frame_parent", 2 * MAX_FEET + 1),
    ("o_jR", 1), ("o_jp", 1), ("o_axis", 1), ("o_prism", 1), ("o_mass", 1),
    ("o_com", 1), ("o_Iloc", 1), ("o_fR", 1), ("o_fp", 1), ("o_w", 1),
    ("o_wterm", 1), ("o_g", 1), ("o_qmin", 1), ("o_qmax", 1), ("o_cone", 1),
    ("o_scalars", 1),
    ("torque_limits", 1), ("kp_on", 1), ("o_umin", 1), ("o_umax", 1), ("o_kp", 1),
    ("o_kd", 1), ("o_Icom", 1), ("o_grav", 1), ("o_prox", 1),
)
_DIMS_INTS = sum(n for _, n in _DIMS_FIELDS)
_consts_cache: dict = {}


def _np64(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def _require_body_layout(m, nk: int, what: str = "the stage kernels"):
    """The kernels' model: a free-flyer root, 1-dof joints in tree order
    with q/v indices in joint order, at most MAX_JOINTS joints and MAX_FEET
    feet."""
    nj = m.njoints
    ok = (m.joint_types[0] == FREE and all(t != FREE for t in m.joint_types[1:])
          and all(m.parents[j] < j for j in range(1, nj))
          and all(m.idx_q[j] == 6 + j and m.idx_v[j] == 5 + j for j in range(1, nj)))
    if not ok:
        raise NotImplementedError(f"{what} take a free-flyer root followed by "
                                  "1-dof joints in tree order")
    if nj > MAX_JOINTS or nk > MAX_FEET:
        raise NotImplementedError(f"{what} take at most {MAX_JOINTS} joints "
                                  f"and {MAX_FEET} feet")


def _require_stage_layout(ocp):
    """The stage kernels' model (`_require_body_layout`) with point feet."""
    _require_body_layout(ocp.model, ocp.nk)
    if ocp.fs != 3:
        raise NotImplementedError("the stage kernels take point feet (force_size 3); "
                                  "6D contacts are not ported")
    if 2 * ocp.nv + ocp.nu > LIN_THREADS:
        raise NotImplementedError(f"stage_linearize takes at most {LIN_THREADS} tangent "
                                  f"directions (ndx + nu), got {2 * ocp.nv + ocp.nu}")


def _stage_consts(ocp, dtype, device):
    """(packed constants on `device` in `dtype`, Dims as a ctypes int array),
    built once per (OCP, topology tables, terminal rows, dtype, device)."""
    tab = _world.tables(ocp.model)
    key = (id(ocp), id(tab), ocp.n_term_eq, dtype, device)
    hit = _consts_cache.get(key)
    if hit is not None and hit[0] is ocp and hit[1] is tab:
        return hit[2], hit[3]
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
    buf, dims_c = _pack_consts(dims, blocks, dtype, device)
    _consts_cache[key] = (ocp, tab, buf, dims_c)
    return buf, dims_c


def _pack_consts(dims: dict, blocks: dict, dtype, device):
    """(the blocks concatenated on `device` in `dtype`, Dims as a ctypes int
    array): each block's offset goes to `dims` under its name; Dims fields
    that `dims` lacks are 0."""
    flat, off = [], 0
    for name, arr in blocks.items():
        a = np.asarray(arr, np.float64).reshape(-1)
        dims[name] = off
        flat.append(a)
        off += a.shape[0]
    ints = []
    for name, n in _DIMS_FIELDS:
        v = np.atleast_1d(np.asarray(dims.get(name, 0), np.int64))
        ints.extend(v.tolist() + [0] * (n - v.shape[0]))
    dims_c = (ctypes.c_int * _DIMS_INTS)(*ints)
    buf = torch.as_tensor(np.concatenate(flat), dtype=dtype, device=device)
    return buf, dims_c


def _stage_kernel(ocp, fd: bool, name: str) -> str:
    """The C name of a stage kernel, refusing an OCP of the other
    formulation (the two stages read different constants)."""
    if ocp.full_dynamics != fd:
        raise ValueError(f"{'fd_' if fd else ''}{name} takes a "
                         f"{'full-dynamics' if fd else 'kinodynamics'} OCP, "
                         f"got {type(ocp).__name__}")
    return f"fd_{name}" if fd else name


def _stage_params(sp, nb, T, nk, nx, nu, dtype, device, fd=False):
    """Pointers to the stage parameters the kernels read, checked and
    contiguous; the full-dynamics stage also reads f_ref."""
    shapes = dict(contact_active=(nb, T, nk), foot_ref_p=(nb, T, nk, 3),
                  x_ref=(nb, T, nx), u_ref=(nb, T, nu))
    if fd:
        shapes["f_ref"] = (nb, T, nk, 3)
    shapes["land"] = (nb, T, nk)
    t = _check({k: getattr(sp, k) for k in shapes}, shapes, dtype, device)
    return [t[k].data_ptr() for k in shapes]


# ---------------------------------------------------------------------------
# K1 + K2: stage linearization
# ---------------------------------------------------------------------------


def _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu):
    """Plain PyTorch twin of K1+K2: the stage bundle on N = B*T lanes and
    its forward-mode tangents along the 18 dq, 18 dv and 24 du basis
    directions (`torch.func.jvp` under `torch.func.vmap`), then the
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

    def bundle(dq, dv, du):
        Xp = space.integrate_parts_soa(X, dq, dv)
        r_all, w_all, _, _, xnext = solver._stage_bundle_soa(
            Xp, U + (du if su is None else su * du), P, LE, LI, mu_l)
        return r_all, space.difference_soa(Xn, xnext), w_all

    zq = torch.zeros((split, N), dtype=dtype, device=device)
    zv = torch.zeros((ndx - split, N), dtype=dtype, device=device)
    zu = torch.zeros((nu, N), dtype=dtype, device=device)

    def tangents(fn, z):
        n = z.shape[0]
        basis = torch.eye(n, dtype=dtype, device=device)[..., None].expand(n, n, N)
        return vmap(lambda t: jvp(fn, (z,), (t,))[1])(basis)

    r0, d0, w0 = bundle(zq, zv, zu)
    Jr_q, Jd_q = tangents(lambda a: bundle(a, zv, zu)[:2], zq)
    Jr_v, Jd_v = tangents(lambda a: bundle(zq, a, zu)[:2], zv)
    Jr_u, Jd_u = tangents(lambda a: bundle(zq, zv, a)[:2], zu)
    Jr = torch.cat([Jr_q, Jr_v, Jr_u], dim=0)  # (ndx+nu, nr, N)
    Jd = torch.cat([Jd_q, Jd_v, Jd_u], dim=0)  # (ndx+nu, ndx, N)

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


def _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=False):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    C, dims = _stage_consts(ocp, dtype, device)
    nb, T = us.shape[:2]
    nx, nu, ndx = solver.space.nx, ocp.nu, solver.space.ndx
    shapes = dict(xs=(nb, T + 1, nx), us=(nb, T, nu), lam_eq=(nb, T, ocp.n_eq),
                  lam_in=(nb, T, ocp.n_in), mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_eq=lam_eq, lam_in=lam_in, mu=mu), shapes,
               dtype, device)
    params = _stage_params(sp, nb, T, ocp.nk, nx, nu, dtype, device, fd)
    su = solver._su(xs)
    out = dict(A=(nb, T, ndx, ndx), B=(nb, T, ndx, nu), d=(nb, T, ndx),
               qx=(nb, T, ndx), qu=(nb, T, nu), Qxx=(nb, T, ndx, ndx),
               Quu=(nb, T, nu, nu), Qux=(nb, T, nu, ndx))
    out = {k: torch.empty(v, dtype=dtype, device=device) for k, v in out.items()}
    name = _stage_kernel(ocp, fd, "stage_linearize")
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
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        stage_linearize.launches += 1
        return out
    raise RuntimeError(f"stage_linearize: no kernel for device {dev}")


stage_linearize.launches = 0


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


def _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=False):
    ocp = solver.ocp
    dtype, device = xs.dtype, xs.device
    C, dims = _stage_consts(ocp, dtype, device)
    nb, na, T = us.shape[:3]
    nx, nu, ndx = solver.space.nx, ocp.nu, solver.space.ndx
    shapes = dict(xs=(nb, na, T + 1, nx), us=(nb, na, T, nu),
                  lam_eq=(nb, T, ocp.n_eq), lam_in=(nb, T, ocp.n_in), mu=(nb,))
    t = _check(dict(xs=xs, us=us, lam_eq=lam_eq, lam_in=lam_in, mu=mu), shapes,
               dtype, device)
    params = _stage_params(sp, nb, T, ocp.nk, nx, nu, dtype, device, fd)
    n = nb * na
    out = [torch.empty(s, dtype=dtype, device=device)
           for s in ((n, T), (n, T, ocp.n_eq), (n, T, ocp.n_in), (n, T, ndx))]
    name = _stage_kernel(ocp, fd, "stage_eval")
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
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu)
        stage_eval.launches += 1
        return out
    raise RuntimeError(f"stage_eval: no kernel for device {dev}")


stage_eval.launches = 0


# ---------------------------------------------------------------------------
# The full-dynamics stage: K7 inside K1 + K2, K1, and alone
# ---------------------------------------------------------------------------


def fd_stage_linearize(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 + K2: `stage_linearize`'s contract on a FullDynamicsOCP
    (stage params with f_ref).  The twin is the same `torch.func` sweep
    over `FullDynamicsOCP.stage_eval_soa`."""
    dev = xs.device
    if dev.type == "cpu":
        return _linearize_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _linearize_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True)
        fd_stage_linearize.launches += 1
        return out
    raise RuntimeError(f"fd_stage_linearize: no kernel for device {dev}")


fd_stage_linearize.launches = 0


def fd_stage_eval(solver, sp, xs, us, lam_eq, lam_in, mu):
    """K7 + K1 in primal mode on the candidates: `stage_eval`'s contract on
    a FullDynamicsOCP."""
    dev = xs.device
    if dev.type == "cpu":
        return _eval_traj_plain(solver, sp, xs, us, lam_eq, lam_in, mu)
    if dev.type == "cuda":
        out = _eval_cuda(solver, sp, xs, us, lam_eq, lam_in, mu, fd=True)
        fd_stage_eval.launches += 1
        return out
    raise RuntimeError(f"fd_stage_eval: no kernel for device {dev}")


fd_stage_eval.launches = 0


def fd_dynamics_plain(ocp, x, u, p):
    """Plain PyTorch twin of K7: `FullDynamicsOCP._constrained_acc_soa` on
    N lanes.  x (N,nx), u (N,nu), p stage params with leading N.  Returns
    ddq (N,nv), forces (N,nk,fs)."""
    P = tree_map(lambda a: a.movedim(0, -1), p)
    ddq, f = ocp._constrained_acc_soa(x.T, u.T, P)
    return ddq.T, f.permute(2, 0, 1)


def _fd_dynamics_cuda(ocp, x, u, p):
    dtype, device = x.dtype, x.device
    C, dims = _stage_consts(ocp, dtype, device)
    n = x.shape[0]
    shapes = dict(x=(n, ocp.nq + ocp.nv), u=(n, ocp.nu), active=(n, ocp.nk),
                  foot_ref_p=(n, ocp.nk, 3))
    t = _check(dict(x=x, u=u, active=p.contact_active, foot_ref_p=p.foot_ref_p), shapes,
               dtype, device)
    ddq = torch.empty((n, ocp.nv), dtype=dtype, device=device)
    f = torch.empty((n, ocp.nk, 3), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_{_stage_kernel(ocp, True, 'dynamics')}_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes],
                 n, ddq.data_ptr(), f.data_ptr(), _stream(device))
    _raise_on(err, "fd_dynamics")
    return ddq, f


def fd_dynamics(ocp, x, u, p):
    """K7: the constrained dynamics of a FullDynamicsOCP on N lanes.
    x (N,nx), u (N,nu), p stage params with leading N.  Returns ddq (N,nv)
    and the contact forces (N,nk,3)."""
    dev = x.device
    if dev.type == "cpu":
        return fd_dynamics_plain(ocp, x, u, p)
    if dev.type == "cuda":
        out = _fd_dynamics_cuda(ocp, x, u, p)
        fd_dynamics.launches += 1
        return out
    raise RuntimeError(f"fd_dynamics: no kernel for device {dev}")


fd_dynamics.launches = 0


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


def _term_cuda(solver, x, tp, lam_term, mu):
    ocp = solver.ocp
    dtype, device = x.dtype, x.device
    C, dims = _stage_consts(ocp, dtype, device)
    nb = x.shape[0]
    nx, ndx = solver.space.nx, solver.space.ndx
    shapes = dict(x=(nb, nx), x_ref=(nb, nx), dcm_ref=(nb, 3),
                  lam=(nb, ocp.n_term_eq), mu=(nb,))
    t = _check(dict(x=x, x_ref=tp.x_ref, dcm_ref=tp.dcm_ref, lam=lam_term, mu=mu),
               shapes, dtype, device)
    Vx = torch.empty((nb, ndx), dtype=dtype, device=device)
    Vxx = torch.empty((nb, ndx, ndx), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_term_linearize_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb, Vx.data_ptr(),
                 Vxx.data_ptr(), _stream(device))
    _raise_on(err, "term_linearize")
    return Vx, Vxx


def term_linearize(solver, x, tp, lam_term, mu):
    """K5.  x (B,nx) terminal states, tp terminal params (leaves (B, ...)),
    lam_term (B,n_term_eq), mu (B,).  Returns Vx (B,ndx), Vxx (B,ndx,ndx)."""
    dev = x.device
    if dev.type == "cpu":
        return _linearize_term_plain(solver, x, tp, lam_term, mu)
    if dev.type == "cuda":
        out = _term_cuda(solver, x, tp, lam_term, mu)
        term_linearize.launches += 1
        return out
    raise RuntimeError(f"term_linearize: no kernel for device {dev}")


term_linearize.launches = 0


# ---------------------------------------------------------------------------
# K9: the fused tick's bookkeeping
# ---------------------------------------------------------------------------

EMPTY = 2**30  # sentinel of an empty event-queue slot (int32)
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


def _tick_cuda(fused, carry, x_meas):
    ocp, s = fused.ocp, fused.settings
    dtype, device = x_meas.dtype, x_meas.device
    C, dims = _stage_consts(ocp, dtype, device)
    nb, L, nk = carry.plan.shape
    T, qmax = fused.T, carry.takeoff.shape[-1]
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
    fn = getattr(_library(), f"smpc_tick_refs_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb, T, L, qmax, EMPTY,
                 s.T_fly, float((s.T_fly + s.T_contact) * s.timestep),
                 float(s.swing_apex), *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, "tick_refs")
    return out._replace(walking=out.walking != 0)


def tick_refs(fused, carry, x_meas):
    """K9.  carry: an `MPCCarry` with the scenario axis leading every leaf;
    x_meas (B,nx).  Returns `TickRefs`."""
    dev = x_meas.device
    if dev.type == "cpu":
        return tick_refs_plain(fused, carry, x_meas)
    if dev.type == "cuda":
        out = _tick_cuda(fused, carry, x_meas)
        tick_refs.launches += 1
        return out
    raise RuntimeError(f"tick_refs: no kernel for device {dev}")


tick_refs.launches = 0


# ---------------------------------------------------------------------------
# The closed loop's kernels: K8 (qp_admm, id_assemble) and K10 (sim_step)
# ---------------------------------------------------------------------------

QP_MAX_N = 64  # qp.cu kMaxN: variables (Go2 30; a Talos-sized ID about 50)
QP_MAX_M = 256  # qp.cu kMaxM: constraint rows (Go2 66, 78 with motion equalities)
_body_cache: dict = {}


def _body_consts(model, frame_ids, nk, dtype, device, kp=0.0, kd=0.0, prox=1e-9):
    """(packed constants, Dims) of the rigid-body kernels csrc/id.cu and
    csrc/sim.cu: the model's joint tree and inertias, the selected frames
    `frame_ids` (the nk feet first, then any other frame), the Baumgarte
    gains kp, kd on every contact row and the Delassus diagonal's proximal
    term max(prox, 50 eps(dtype)), as `constrained_fwd_dynamics_soa` takes
    it."""
    tab = _world.tables(model)
    key = (id(model), id(tab), tuple(frame_ids), nk, kp, kd, prox, dtype, device)
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
        o_kp=np.full(3 * nk, float(kp)), o_kd=np.full(3 * nk, float(kd)),
        o_Icom=soa_dyn._static_body_params(model)[2],
        o_grav=np.asarray(model.gravity, np.float64),
        o_prox=np.array([max(prox, 50.0 * torch.finfo(dtype).eps)]))
    dims = dict(nj=nj, nq=model.nq, nv=model.nv, nu=model.nv - 6, nk=nk, fs=3,
                kp_on=int(kp != 0.0), parent=list(model.parents), qidx=list(model.idx_q),
                vidx=list(model.idx_v), frame_parent=[int(tab.fparent[f]) for f in sel])
    buf, dims_c = _pack_consts(dims, blocks, dtype, device)
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
    flat = np.concatenate([
        [s.kp_base, s.kp_posture, s.kp_contact, *kd, s.w_base, s.w_posture,
         s.w_contact_motion, s.w_contact_force, idsolver.min_f, idsolver.max_f,
         idsolver.dt, idsolver.dt ** 2],
        np.asarray(idsolver._cone_mat).reshape(-1),
        m.velocity_limit[6:], m.lower_limit[7:], m.upper_limit[7:], m.effort_limit[6:]])
    buf = torch.as_tensor(flat, dtype=dtype, device=device)
    _id_cache[key] = (idsolver, buf)
    return buf


def _id_cuda(idsolver, q, v, targets):
    from .id.kinodynamics_id import KinodynamicsID

    if type(idsolver)._extra_tasks is not KinodynamicsID._extra_tasks:
        raise NotImplementedError("id_assemble takes the KinodynamicsID task set")
    m = idsolver.model
    _require_body_layout(m, idsolver.nk, "id_assemble")
    dtype, device = q.dtype, q.device
    nb, nv, nk, nz = q.shape[0], idsolver.nv, idsolver.nk, idsolver.nz
    C, dims = _body_consts(m, idsolver.feet_fids + [idsolver.mh.base_frame_id], nk, dtype,
                           device)
    P = _id_params(idsolver, dtype, device)
    rows = _id_rows(idsolver)
    shapes = dict(q=(nb, m.nq), v=(nb, nv), q_t=(nb, m.nq), v_t=(nb, nv), a_t=(nb, nv),
                  contacts=(nb, nk), f_t=(nb, nk, 3))
    t = _check(dict(q=q, v=v, **targets), shapes, dtype, device)
    out = {k: torch.empty(s, dtype=dtype, device=device) for k, s in (
        ("H", (nb, nz, nz)), ("g", (nb, nz)), ("A", (nb, rows, nz)), ("l", (nb, rows)),
        ("u", (nb, rows)), ("M", (nb, nv, nv)), ("h", (nb, nv)), ("JcT", (nb, nv, 3 * nk)))}
    fn = getattr(_library(), f"smpc_id_assemble_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), P.data_ptr(),
                 *[t[k].data_ptr() for k in shapes], nb,
                 int(idsolver.settings.contact_motion_equality), idsolver.n_cone, rows,
                 *[out[k].data_ptr() for k in ID_OUT], _stream(device))
    _raise_on(err, "id_assemble")
    return tuple(out[k] for k in ID_OUT)


def id_assemble(idsolver, q, v, targets):
    """K8's assembly: the inverse-dynamics QP of B robots (H, g, A, l, u)
    with M, h and Jc' for the torques.  q (B,nq), v (B,nv), targets
    q_t (B,nq), v_t, a_t (B,nv), contacts (B,nk), f_t (B,nk,3)."""
    dev = q.device
    if dev.type == "cpu":
        return idsolver._assemble_core(q, v, targets)
    if dev.type == "cuda":
        out = _id_cuda(idsolver, q, v, targets)
        id_assemble.launches += 1
        return out
    raise RuntimeError(f"id_assemble: no kernel for device {dev}")


id_assemble.launches = 0


def _sim_cuda(sim, q, v, tau):
    from .sim.simulator import SimStep

    s, m = sim.settings, sim.model
    _require_body_layout(m, sim.nk, "sim_step")
    dtype, device = q.dtype, q.device
    nb, nk = q.shape[0], sim.nk
    C, dims = _body_consts(m, sim.feet_fids, nk, dtype, device, s.baumgarte_kp,
                           s.baumgarte_kd)
    shapes = dict(q=(nb, m.nq), v=(nb, m.nv), tau=(nb, m.nv - 6))
    t = _check(dict(q=q, v=v, tau=tau), shapes, dtype, device)
    out = SimStep(*(torch.empty(sh, dtype=dtype, device=device) for sh in (
        (nb, m.nq), (nb, m.nv), (nb, nk, 3), (nb, 2, nk))))
    fn = getattr(_library(), f"smpc_sim_step_{_suffix(dtype)}")
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(dims), C.data_ptr(), *[t[k].data_ptr() for k in shapes],
                 nb, float(s.dt), float(s.ground_height), float(s.contact_margin),
                 *[o.data_ptr() for o in out], _stream(device))
    _raise_on(err, "sim_step")
    return out


def sim_step(sim, q, v, tau):
    """K10: one step of the rigid-contact simulator for B robots.  q (B,nq),
    v (B,nv), tau (B,nu).  Returns `SimStep` q, v, the world contact forces
    f_w (B,nk,3) and the contact masks of the two solves (B,2,nk)."""
    dev = q.device
    if dev.type == "cpu":
        return sim.step_plain(q, v, tau)
    if dev.type == "cuda":
        out = _sim_cuda(sim, q, v, tau)
        sim_step.launches += 1
        return out
    raise RuntimeError(f"sim_step: no kernel for device {dev}")


sim_step.launches = 0


KERNELS = (stage_linearize, stage_eval, riccati_backward, parallel_riccati_backward,
           linear_rollout, term_linearize, tick_refs, fd_stage_linearize, fd_stage_eval,
           fd_dynamics, qp_admm, id_assemble, sim_step)


def reset_launches():
    """Zero every kernel's launch counter."""
    for k in KERNELS:
        k.launches = 0
