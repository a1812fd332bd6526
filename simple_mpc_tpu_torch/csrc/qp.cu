// K8 (the solve): the dense ADMM QP of the 1 kHz inverse-dynamics layer,
// one block per problem.
//
// Replaces simple_mpc_tpu/id/qp.py solve_qp (33-66), which the JAX package
// jits with the assembly (id/kinodynamics_id.py _solve_core) into one XLA
// program; its twin is simple_mpc_tpu_torch/id/qp.py.  For each problem
//   min 0.5 z'Hz + g'z  s.t.  l <= Az <= u
// rho_r = 1e3 rho on the rows with |u - l| < 1e-12 (equalities), rho else;
// K = sym(H + sigma I + A' diag(rho) A), L L' = K (NaN everywhere when a
// pivot is not positive, as jnp.linalg.cholesky); from x = z0 (or 0),
// zc = A x, y = y0 (or 0), `iters` steps of
//   x  = K^-1 (sigma x - g + A'(rho zc - y))      (two triangular solves)
//   Ar = alpha A x + (1 - alpha) zc
//   zc = clip(Ar + y / rho, l, u);  y += rho (Ar - zc)
// then prim = max|Ax - clip(Ax, l, u)|, dual = max|Hx + g + A'y|.  The clip
// is min(max(., l), u): bounds of +-1e20 or +-inf pass through it, and a
// NaN stays NaN.
//
// What bounds it on the card: latency.  A Go2 problem (n = 30, m = 66) is
// ~0.2 MFLOP a solve, far below what one SM does in a microsecond, but each
// ADMM step is a chain of dependent pieces: two matrix-vector products over
// the block and two triangular solves of n dependent steps each.  The
// design keeps L, A, the bounds and the iterates in shared memory for the
// whole solve, so device memory is touched once at each end; the products
// give each row to one thread; the triangular solves stay triangular solves
// (the twin's arithmetic, not a product with K^-1) and run in warp 0, one
// column a step, with __syncwarp between steps.  Several problems per block,
// K^-1 by columns in parallel and tensor cores are left for later work.
//
// Layouts (row-major, contiguous, leading problem axis b): H (B,n,n)
// g (B,n) A (B,m,n) l u (B,m) z0 (B,n) y0 (B,m), z0 and y0 optional (null);
// out z (B,n) y (B,m) prim dual (B,).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;   // kernels.QP_MAX_N
constexpr int kMaxM = 256;  // kernels.QP_MAX_M

template <class F>
__device__ F clip(F x, F lo, F hi) {
  x = (x < lo) ? lo : x;  // max(x, lo), NaN kept
  return (x > hi) ? hi : x;
}

// max that keeps a NaN, as jnp.max / torch.amax do
template <class F>
__device__ F keep_nan_max(F a, F b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// block-wide max of v over all threads (NaN wins); red has kThreads slots
template <class F>
__device__ F block_max(F v, F* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = keep_nan_max(red[tid], red[tid + s]);
    __syncthreads();
  }
  const F r = red[0];
  __syncthreads();
  return r;
}

// (L L') x = b in place on b (length n), by warp 0; L row-major n x n,
// lower triangle.  Forward: column j fixes b[j] and updates the rows below
// it, so each row accumulates b_i - L_i0 y_0 - L_i1 y_1 - ... in the order
// of the row-oriented substitution; backward likewise with L'.
template <class F>
__device__ void chol_solve_warp(const F* L, int n, F* b) {
  const int lane = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const F yj = b[j] / L[j * n + j];
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) b[i] -= L[i * n + j] * yj;
    if (lane == 0) b[j] = yj;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const F xj = b[j] / L[j * n + j];
    __syncwarp();
    for (int i = lane; i < j; i += 32) b[i] -= L[j * n + i] * xj;
    if (lane == 0) b[j] = xj;
    __syncwarp();
  }
}

template <class F>
__global__ void __launch_bounds__(kThreads)
qp_admm_kernel(const F* __restrict__ Hg, const F* __restrict__ gg, const F* __restrict__ Ag,
               const F* __restrict__ lg, const F* __restrict__ ug, const F* __restrict__ z0,
               const F* __restrict__ y0, int n, int m, int iters, F rho, F rho_eq,
               F sigma, F alpha,
               F* __restrict__ z_o, F* __restrict__ y_o, F* __restrict__ prim_o,
               F* __restrict__ dual_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* L = reinterpret_cast<F*>(smem_raw);  // n x n
  F* A = L + n * n;                       // m x n
  F* l = A + (size_t)m * n;               // m
  F* u = l + m;
  F* rv = u + m;   // rho per row
  F* zc = rv + m;  // m
  F* y = zc + m;   // m
  F* w = y + m;    // m: rho zc - y
  F* x = w + m;    // n
  F* g = x + n;    // n
  F* red = g + n;  // kThreads
  __shared__ int fail;

  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t b = blockIdx.x;
  const F* H = Hg + b * n * n;
  for (int i = tid; i < m * n; i += nth) A[i] = Ag[b * m * n + i];
  for (int r = tid; r < m; r += nth) {
    l[r] = lg[b * m + r];
    u[r] = ug[b * m + r];
    const F d = u[r] - l[r];
    rv[r] = ((d < F(0) ? -d : d) < F(1e-12)) ? rho_eq : rho;
    y[r] = y0 ? y0[b * m + r] : F(0);
  }
  for (int i = tid; i < n; i += nth) {
    x[i] = z0 ? z0[b * n + i] : F(0);
    g[i] = gg[b * n + i];
  }
  if (tid == 0) fail = 0;
  __syncthreads();

  // K = sym(H + sigma I + A' diag(rho) A), lower triangle into L
  for (int idx = tid; idx < n * n; idx += nth) {
    const int i = idx / n, j = idx % n;
    if (j > i) continue;
    F pij = F(0), pji = F(0);
    for (int r = 0; r < m; ++r) {
      pij += A[r * n + i] * rv[r] * A[r * n + j];
      pji += A[r * n + j] * rv[r] * A[r * n + i];
    }
    const F s = (i == j) ? sigma : F(0);
    L[i * n + j] = F(0.5) * ((H[i * n + j] + s + pij) + (H[j * n + i] + s + pji));
  }
  __syncthreads();

  // Cholesky, left-looking by columns: the rows of column j in parallel
  for (int j = 0; j < n; ++j) {
    for (int i = j + tid; i < n; i += nth) {
      F s = L[i * n + j];
      for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
      L[i * n + j] = s;
    }
    __syncthreads();
    if (tid == 0) {
      const F d = L[j * n + j];
      if (!(d > F(0))) fail = 1;
      L[j * n + j] = sqrt(d);
    }
    __syncthreads();
    for (int i = j + 1 + tid; i < n; i += nth) L[i * n + j] /= L[j * n + j];
    __syncthreads();
  }
  if (fail) {
    const F nan = F(0) / F(0);
    for (int i = tid; i < n * n; i += nth) L[i] = nan;
    __syncthreads();
  }

  // zc = A x
  for (int r = tid; r < m; r += nth) {
    F s = F(0);
    for (int i = 0; i < n; ++i) s += A[r * n + i] * x[i];
    zc[r] = s;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int r = tid; r < m; r += nth) w[r] = rv[r] * zc[r] - y[r];
    __syncthreads();
    // x <- sigma x - g + A' w (each thread its own entries: no race)
    for (int i = tid; i < n; i += nth) {
      F s = F(0);
      for (int r = 0; r < m; ++r) s += A[r * n + i] * w[r];
      x[i] = sigma * x[i] - g[i] + s;
    }
    __syncthreads();
    if (tid < 32) chol_solve_warp(L, n, x);
    __syncthreads();
    for (int r = tid; r < m; r += nth) {
      F s = F(0);
      for (int i = 0; i < n; ++i) s += A[r * n + i] * x[i];
      const F ar = alpha * s + (F(1) - alpha) * zc[r];
      const F zn = clip(ar + y[r] / rv[r], l[r], u[r]);
      y[r] = y[r] + rv[r] * (ar - zn);
      zc[r] = zn;
    }
    __syncthreads();
  }

  F pm = F(0);
  for (int r = tid; r < m; r += nth) {
    F s = F(0);
    for (int i = 0; i < n; ++i) s += A[r * n + i] * x[i];
    const F e = s - clip(s, l[r], u[r]);
    pm = keep_nan_max(pm, e < F(0) ? -e : e);
  }
  F dm = F(0);
  for (int i = tid; i < n; i += nth) {
    F s = F(0);
    for (int j = 0; j < n; ++j) s += H[i * n + j] * x[j];
    F t = F(0);
    for (int r = 0; r < m; ++r) t += A[r * n + i] * y[r];
    const F e = s + g[i] + t;
    dm = keep_nan_max(dm, e < F(0) ? -e : e);
  }
  const F prim = block_max(pm, red);
  const F dual = block_max(dm, red);
  for (int i = tid; i < n; i += nth) z_o[b * n + i] = x[i];
  for (int r = tid; r < m; r += nth) y_o[b * m + r] = y[r];
  if (tid == 0) {
    prim_o[b] = prim;
    dual_o[b] = dual;
  }
}

template <class F>
int launch_qp(const void* H, const void* g, const void* A, const void* l, const void* u,
              const void* z0, const void* y0, int nbatch, int n, int m, int iters,
              double rho, double sigma, double alpha, void* z, void* y, void* prim,
              void* dual, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)n * n + (size_t)m * n + 6 * (size_t)m + 2 * (size_t)n +
                       kThreads) * sizeof(F);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qp_admm_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qp_admm_kernel<F><<<nbatch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(H), static_cast<const F*>(g), static_cast<const F*>(A),
      static_cast<const F*>(l), static_cast<const F*>(u), static_cast<const F*>(z0),
      static_cast<const F*>(y0), n, m, iters, F(rho), F(1e3 * rho), F(sigma), F(alpha),
      static_cast<F*>(z), static_cast<F*>(y), static_cast<F*>(prim), static_cast<F*>(dual));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SMPC_QP(sfx, F)                                                                \
  int smpc_qp_admm_##sfx(const void* H, const void* g, const void* A, const void* l,   \
                         const void* u, const void* z0, const void* y0, int nbatch,    \
                         int n, int m, int iters, double rho, double sigma,            \
                         double alpha, void* z, void* y, void* prim, void* dual,       \
                         void* stream) {                                               \
    return launch_qp<F>(H, g, A, l, u, z0, y0, nbatch, n, m, iters, rho, sigma, alpha, \
                        z, y, prim, dual, stream);                                     \
  }

SMPC_QP(f32, float)
SMPC_QP(f64, double)

}  // extern "C"
