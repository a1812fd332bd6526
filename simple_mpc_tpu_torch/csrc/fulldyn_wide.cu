// The full-dynamics stage kernels at wide shapes: K7 (csrc/fulldyn_wide.cuh)
// inside K1 and K2, K7 inside K1, and K7 alone, for what csrc/fulldyn.cu
// refuses — 6D contacts (a wrench per foot), more than 16 joints or more
// than 64 tangent directions; at most 32 joints, 128 directions and 24
// contact rows (8 point feet or 4 feet with 6D contacts).  Talos full
// dynamics (23 joints, two 6D quad feet) has nq = 29, nv = 28, ndx = 56,
// nu = 22 torques: 78 directions, 12 contact rows and 196 AL rows a stage
// (108 cost, 44 torque box, 44 joint box), 230 with the two 17-row wrench
// cones, 242 with the landing rows too.
//
// wide_fd_stage_linearize replaces simple_mpc_tpu/solver/proxddp.py
// ProxDDPSolver._linearize_traj_soa (271-350) with _stage_bundle_soa over
// ocp/fulldynamics.py stage_eval_soa (194-289) at these shapes;
// wide_fd_stage_eval the candidate evaluation of _eval_traj (183-205) on
// the same stage; wide_fd_dynamics ops/soa_dyn.py
// constrained_fwd_dynamics_soa (199-287), the dynamics of
// FullDynamicsOCP.get_contact_forces and state_derivative.  Their twins
// are the Go2 kernels' (kernels.py `_linearize_traj_plain`,
// `_eval_traj_plain`, `fd_dynamics_plain`).
//
// The design is fulldyn.cu's at linearize_wide.cu's block: one block of
// 128 threads a (scenario, stage) lane, thread j < ndx + nu evaluating the
// bundle in Dual arithmetic along direction j and writing its column of
// ws*Jr (nr rows) and of Jgap (ndx rows) to shared memory; after one
// barrier the block forms qx, qu, the Qxx, Quu, Qux blocks straight from
// the columns, and A, B, d in the (B, T, ...) layout the Riccati kernel
// reads.  The candidates and the dynamics take one thread a lane in primal
// arithmetic.
//
// What bounds them on the card: scattered scalar arithmetic and local
// memory.  A lane's primal K7 is the 28x28 CRBA and Cholesky, 13 forward
// substitutions and the 12x12 Delassus product and Cholesky (~40 kFLOP);
// the linearization repeats it in Dual arithmetic on each of 78 threads,
// each holding the factor of M (406 duals), L^-1 Jc^T (28 x 24) and the
// dual kinematics of 32 joints in local memory.  Its shared memory, (nr +
// ndx) x ndir scalars, is 77.8 KiB a block in f32 and 155.5 KiB in f64 for
// Talos (183.9 KiB in f64 with the cones and the landing rows), so one or
// two blocks share an SM.  A simple, right kernel first: sharing the primal
// factors across the block (the tangent through M^-1 as M^-1 (dr - dM x))
// and tensor cores for the GN products are later work.
//
// Layouts (row-major, contiguous) as fulldyn.cu's, with foot_ref_R
// (B,T,nk,3,3) among the stage parameters and f_ref (B,T,nk,fs);
// wide_fd_dynamics: x (N,nx) u (N,nu) active (N,nk) foot_ref_R (N,nk,3,3)
// foot_ref_p (N,nk,3); out ddq (N,nv) f (N,nk,fs).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "fulldyn_wide.cuh"

namespace {

using smpc_wide::Dims;
using smpc_wide::Dual;

constexpr int kWideThreads = 128;  // tangent directions a block takes
constexpr int kEvalThreads = 128;
constexpr int kDynThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's dynamic shared memory on sm_90

template <class F>
struct ParamPtrs {
  const F* active;
  const F* foot_ref_R;
  const F* foot_ref_p;
  const F* x_ref;
  const F* u_ref;
  const F* f_ref;
  const F* land;

  __device__ smpc_wide::FdWideParams<F> at(const Dims& D, size_t n) const {
    const int nx = D.nq + D.nv;
    smpc_wide::FdWideParams<F> p;
    p.active = active + n * D.nk;
    p.foot_ref_R = foot_ref_R + n * 9 * D.nk;
    p.foot_ref_p = foot_ref_p + n * 3 * D.nk;
    p.x_ref = x_ref + n * nx;
    p.u_ref = u_ref + n * D.nu;
    p.f_ref = f_ref + n * D.fs * D.nk;
    p.land = land + n * D.nk;
    return p;
  }
};

// column j of ws*Jr and of Jgap, strided by ndir in shared memory; the
// primal (ws*r, gap) from the thread that has `primal` set
template <class F>
struct LinSink {
  F* jw;
  F* jd;
  F* wr;
  F* d0;
  int ndir;
  bool primal;
  __device__ void row(int n, const Dual<F>& r, F w) {
    const F ws = smpc_wide::msqrt(w);
    jw[n * ndir] = r.d * ws;
    if (primal) wr[n] = ws * r.v;
  }
  __device__ void gap(int i, const Dual<F>& g) {
    jd[i * ndir] = g.d;
    if (primal) d0[i] = g.v;
  }
  __device__ void eq(int, const Dual<F>&) {}
  __device__ void ineq(int, const Dual<F>&) {}
};

template <class F>
__global__ void __launch_bounds__(kWideThreads)
fdw_linearize_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                     const F* __restrict__ us, ParamPtrs<F> P, const F* __restrict__ lam_eq,
                     const F* __restrict__ lam_in, const F* __restrict__ mu,
                     const F* __restrict__ su, int nT, F* __restrict__ A, F* __restrict__ Bm,
                     F* __restrict__ d, F* __restrict__ qx, F* __restrict__ qu,
                     F* __restrict__ Qxx, F* __restrict__ Quu, F* __restrict__ Qux) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = D.nq, nv = D.nv, nu = D.nu, nx = nq + nv, ndx = 2 * nv;
  const int ndir = ndx + nu;
  const int nr = D.n_cost + D.n_eq + D.n_in;
  F* jw = reinterpret_cast<F*>(smem_raw);  // nr x ndir
  F* jd = jw + (size_t)nr * ndir;          // ndx x ndir
  F* wr = jd + (size_t)ndx * ndir;         // nr
  F* d0 = wr + nr;                         // ndx

  const size_t n = blockIdx.x;
  const size_t b = n / nT, t = n % nT;
  const int j = threadIdx.x;
  if (j < ndir) {
    const F* X = xs + (b * (nT + 1) + t) * nx;
    const F* U = us + n * nu;
    Dual<F> q[smpc_wide::kMaxQ], v[smpc_wide::kMaxV], u[smpc_wide::kMaxU];
    smpc_wide::seed_state(D, X, j < ndx ? j : -1, q, v);
    for (int i = 0; i < nu; ++i)
      u[i] = Dual<F>(U[i], (j - ndx == i) ? (su ? su[i] : F(1)) : F(0));
    LinSink<F> sink{jw + j, jd + j, wr, d0, ndir, j == 0};
    smpc_wide::fd_stage_bundle_wide(D, C, q, v, u, X + nx, P.at(D, n), mu[b],
                                    lam_eq + n * D.n_eq, lam_in + n * D.n_in, sink);
  }
  __syncthreads();

  const int tid = threadIdx.x, nth = blockDim.x;
  for (int e = tid; e < ndir; e += nth) {
    F s = 0;
    for (int r = 0; r < nr; ++r) s += jw[r * ndir + e] * wr[r];
    if (e < ndx) qx[n * ndx + e] = s;
    else qu[n * nu + e - ndx] = s;
  }
  for (int i = tid; i < ndx; i += nth) d[n * ndx + i] = d0[i];
  for (int idx = tid; idx < ndx * ndx; idx += nth) {
    const int r = idx / ndx, c = idx % ndx;
    A[n * ndx * ndx + idx] = jd[r * ndir + c];
  }
  for (int idx = tid; idx < ndx * nu; idx += nth) {
    const int r = idx / nu, c = idx % nu;
    Bm[n * ndx * nu + idx] = jd[r * ndir + ndx + c];
  }
  auto dot = [&](int a, int c) {
    F s = 0;
    for (int r = 0; r < nr; ++r) s += jw[r * ndir + a] * jw[r * ndir + c];
    return s;
  };
  for (int idx = tid; idx < ndx * ndx; idx += nth)
    Qxx[n * ndx * ndx + idx] = dot(idx / ndx, idx % ndx);
  for (int idx = tid; idx < nu * nu; idx += nth)
    Quu[n * nu * nu + idx] = dot(ndx + idx / nu, ndx + idx % nu);
  for (int idx = tid; idx < nu * ndx; idx += nth)
    Qux[n * nu * ndx + idx] = dot(ndx + idx / ndx, idx % ndx);
}

template <class F>
struct EvalSink {
  F cost;
  F* g;
  F* h;
  F* gap_o;
  __device__ void row(int, F r, F w) { cost += w * r * r; }
  __device__ void gap(int i, F v) { gap_o[i] = v; }
  __device__ void eq(int i, F v) { g[i] = v; }
  __device__ void ineq(int i, F v) { h[i] = v; }
};

template <class F>
__global__ void __launch_bounds__(kEvalThreads)
fdw_eval_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                const F* __restrict__ us, ParamPtrs<F> P, const F* __restrict__ lam_eq,
                const F* __restrict__ lam_in, const F* __restrict__ mu, int n_alpha, int nT,
                size_t n_lanes, F* __restrict__ cost, F* __restrict__ g, F* __restrict__ h,
                F* __restrict__ gap) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nq = D.nq, nv = D.nv, nu = D.nu, nx = nq + nv;
  const size_t ba = m / nT, t = m % nT, b = ba / n_alpha;
  const size_t n = b * nT + t;  // the scenario's stage
  const F* X = xs + (ba * (nT + 1) + t) * nx;
  const F* U = us + m * nu;
  EvalSink<F> sink{F(0), g + m * D.n_eq, h + m * D.n_in, gap + m * 2 * nv};
  smpc_wide::fd_stage_bundle_wide(D, C, X, X + nq, U, X + nx, P.at(D, n), mu[b],
                                  lam_eq + n * D.n_eq, lam_in + n * D.n_in, sink);
  cost[m] = F(0.5) * sink.cost;
}

template <class F>
__global__ void __launch_bounds__(kDynThreads)
fdw_dynamics_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                    const F* __restrict__ u, const F* __restrict__ active,
                    const F* __restrict__ foot_ref_R, const F* __restrict__ foot_ref_p,
                    int n_lanes, F* __restrict__ ddq, F* __restrict__ f) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nq = D.nq, nv = D.nv, nk = D.nk;
  const F* X = x + (size_t)m * (nq + nv);
  smpc_wide::FdKin<F> K;
  smpc_wide::fd_kinematics(D, C, X, X + nq, K);
  smpc_wide::constrained_dynamics_wide(D, C, K, X + nq, u + (size_t)m * D.nu,
                                       active + (size_t)m * nk,
                                       foot_ref_R + (size_t)m * 9 * nk,
                                       foot_ref_p + (size_t)m * 3 * nk, ddq + (size_t)m * nv,
                                       f + (size_t)m * D.fs * nk);
}

Dims load_dims(const int* dims) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  return D;
}

// the unit's limits: tangent directions (one a thread) and contact rows
bool fits(const Dims& D) {
  return 2 * D.nv + D.nu <= kWideThreads && D.fs * D.nk <= smpc_wide::kFdWideRows &&
         (D.fs == 3 || D.fs == 6);
}

// opt into the dynamic shared memory above 48 KB; refuse more than a block
// can have
template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <class F>
ParamPtrs<F> params(const void* active, const void* foot_ref_R, const void* foot_ref_p,
                    const void* x_ref, const void* u_ref, const void* f_ref,
                    const void* land) {
  return ParamPtrs<F>{static_cast<const F*>(active), static_cast<const F*>(foot_ref_R),
                      static_cast<const F*>(foot_ref_p), static_cast<const F*>(x_ref),
                      static_cast<const F*>(u_ref), static_cast<const F*>(f_ref),
                      static_cast<const F*>(land)};
}

template <class F>
int launch_linearize(const int* dims, const void* C, const void* xs, const void* us,
                     const ParamPtrs<F>& P, const void* lam_eq, const void* lam_in,
                     const void* mu, const void* su, int nbatch, int nT, void* A, void* Bm,
                     void* d, void* qx, void* qu, void* Qxx, void* Quu, void* Qux,
                     void* stream) {
  const Dims D = load_dims(dims);
  if (!fits(D)) return static_cast<int>(cudaErrorInvalidValue);
  const int ndx = 2 * D.nv, ndir = ndx + D.nu;
  const int nr = D.n_cost + D.n_eq + D.n_in;
  const size_t smem = ((size_t)(nr + ndx) * ndir + nr + ndx) * sizeof(F);
  if (int e = set_smem(fdw_linearize_kernel<F>, smem)) return e;
  fdw_linearize_kernel<F><<<nbatch * nT, kWideThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us), P,
      static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), static_cast<const F*>(su), nT, static_cast<F*>(A),
      static_cast<F*>(Bm), static_cast<F*>(d), static_cast<F*>(qx), static_cast<F*>(qu),
      static_cast<F*>(Qxx), static_cast<F*>(Quu), static_cast<F*>(Qux));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_eval(const int* dims, const void* C, const void* xs, const void* us,
                const ParamPtrs<F>& P, const void* lam_eq, const void* lam_in,
                const void* mu, int nbatch, int n_alpha, int nT, void* cost, void* g,
                void* h, void* gap, void* stream) {
  const Dims D = load_dims(dims);
  if (!fits(D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_lanes = (size_t)nbatch * n_alpha * nT;
  const unsigned blocks = (unsigned)((n_lanes + kEvalThreads - 1) / kEvalThreads);
  fdw_eval_kernel<F><<<blocks, kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us), P,
      static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), n_alpha, nT, n_lanes, static_cast<F*>(cost),
      static_cast<F*>(g), static_cast<F*>(h), static_cast<F*>(gap));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_dynamics(const int* dims, const void* C, const void* x, const void* u,
                    const void* active, const void* foot_ref_R, const void* foot_ref_p,
                    int n_lanes, void* ddq, void* f, void* stream) {
  const Dims D = load_dims(dims);
  if (!fits(D)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((n_lanes + kDynThreads - 1) / kDynThreads);
  fdw_dynamics_kernel<F><<<blocks, kDynThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x), static_cast<const F*>(u),
      static_cast<const F*>(active), static_cast<const F*>(foot_ref_R),
      static_cast<const F*>(foot_ref_p), n_lanes, static_cast<F*>(ddq),
      static_cast<F*>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define SMPC_FULLDYN_WIDE(sfx, F)                                                        \
  int smpc_wide_fd_stage_linearize_##sfx(                                                \
      const int* dims, const void* C, const void* xs, const void* us,                    \
      const void* active, const void* foot_ref_R, const void* foot_ref_p,                \
      const void* x_ref, const void* u_ref, const void* f_ref, const void* land,         \
      const void* lam_eq, const void* lam_in, const void* mu, const void* su,            \
      int nbatch, int nT, void* A, void* Bm, void* d, void* qx, void* qu, void* Qxx,     \
      void* Quu, void* Qux, void* stream) {                                              \
    return launch_linearize<F>(                                                          \
        dims, C, xs, us,                                                                 \
        params<F>(active, foot_ref_R, foot_ref_p, x_ref, u_ref, f_ref, land), lam_eq,    \
        lam_in, mu, su, nbatch, nT, A, Bm, d, qx, qu, Qxx, Quu, Qux, stream);            \
  }                                                                                      \
  int smpc_wide_fd_stage_eval_##sfx(                                                     \
      const int* dims, const void* C, const void* xs, const void* us,                    \
      const void* active, const void* foot_ref_R, const void* foot_ref_p,                \
      const void* x_ref, const void* u_ref, const void* f_ref, const void* land,         \
      const void* lam_eq, const void* lam_in, const void* mu, int nbatch, int n_alpha,   \
      int nT, void* cost, void* g, void* h, void* gap, void* stream) {                   \
    return launch_eval<F>(                                                               \
        dims, C, xs, us,                                                                 \
        params<F>(active, foot_ref_R, foot_ref_p, x_ref, u_ref, f_ref, land), lam_eq,    \
        lam_in, mu, nbatch, n_alpha, nT, cost, g, h, gap, stream);                       \
  }                                                                                      \
  int smpc_wide_fd_dynamics_##sfx(const int* dims, const void* C, const void* x,         \
                                  const void* u, const void* active,                     \
                                  const void* foot_ref_R, const void* foot_ref_p,        \
                                  int n_lanes, void* ddq, void* f, void* stream) {       \
    return launch_dynamics<F>(dims, C, x, u, active, foot_ref_R, foot_ref_p, n_lanes,    \
                              ddq, f, stream);                                           \
  }

SMPC_FULLDYN_WIDE(f32, float)
SMPC_FULLDYN_WIDE(f64, double)

}  // extern "C"
