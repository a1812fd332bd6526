"""Hand-written CUDA kernels of the solver's path, with their plain twins.

K3 `riccati_backward` (csrc/riccati.cu) replaces
`simple_mpc_tpu/solver/proxddp.py` `ProxDDPSolver._backward` (the serial
`lax.scan` step with `ops/soa_dyn.py` chol_unrolled/chol_solve_unrolled).
K4 `linear_rollout` (csrc/rollout.cu) replaces `ProxDDPSolver._candidate`'s
rollout scan.  Each source file states what bounds the kernel on the card
and what its design does about it.

Dispatch: a tensor on the CPU goes to the plain PyTorch twin; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its kernel launches in
a plain int attribute (`riccati_backward.launches`,
`linear_rollout.launches`).

The kernels are compiled at first use with `nvcc` for sm_90a into a shared
library with a plain C interface under `_build/`, and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .ops.soa_dyn import chol_solve_unrolled, chol_unrolled

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("riccati.cu", "rollout.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Compile csrc/*.cu into _build/libsmpc_kernels_<hash>.so unless that
    library exists.  Returns {"path", "seconds", "log"} (log: nvcc's
    register/shared-memory report; empty when the library was cached)."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libsmpc_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": secs, "log": r.stdout + r.stderr}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"smpc_riccati_backward_{dt}")
            fn.argtypes = [P] * 10 + [D, D, I, I, I, I] + [P] * 4
            fn.restype = I
            fn = getattr(lib, f"smpc_linear_rollout_{dt}")
            fn.argtypes = [P] * 7 + [I] * 5 + [P] * 3
            fn.restype = I
        _lib = lib
    return _lib


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"CUDA kernels take float32 or float64, got {dtype}")


def _check(tensors: dict, shapes: dict, dtype, device):
    out = {}
    for k, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{k}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: expected shape {shapes[k]}, got {tuple(t.shape)}")
        out[k] = t.contiguous()
    return out


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


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


def _riccati_cuda(lin: dict, Vx_T, Vxx_T, reg: float):
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
    ks = torch.empty((nb, T, nu), dtype=dtype, device=device)
    Ks = torch.empty((nb, T, nu, nx), dtype=dtype, device=device)
    Qus = torch.empty((nb, T, nu), dtype=dtype, device=device)
    fn = getattr(_library(), f"smpc_riccati_backward_{_suffix(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t[k].data_ptr() for k in (*LIN_KEYS, "Vx_T", "Vxx_T")],
                 float(reg), float(torch.finfo(dtype).eps), nb, T, nx, nu,
                 ks.data_ptr(), Ks.data_ptr(), Qus.data_ptr(), stream)
    _raise_on(err, "riccati_backward")
    return ks, Ks, Qus


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
