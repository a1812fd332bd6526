// The full-dynamics stage kernels: K7 (csrc/fulldyn.cuh) inside K1 and K2.
//
// fd_stage_linearize replaces simple_mpc_tpu/solver/proxddp.py
// ProxDDPSolver._linearize_traj_soa (271-350) with _stage_bundle_soa over
// ocp/fulldynamics.py stage_eval_soa (194-289): one block of 64 threads per
// (scenario, stage) lane; thread j < 48 evaluates the bundle in Dual
// arithmetic along tangent direction j (18 dq, 18 dv, 12 du scaled by
// u_scale) and writes its column of ws*Jr (146 rows) and of Jgap (36
// rows) to shared memory (36 KB f32, 71 KB f64); after a barrier the block
// forms grad = (ws Jr)'(ws r), H = (ws Jr)'(ws Jr), A, B and d in the
// (B, T, ...) layout the Riccati kernel reads.
// fd_stage_eval replaces the candidate evaluation of
// ProxDDPSolver._eval_traj (183-205) on the same stage: one thread per
// (scenario, step size, stage) lane, parameters read at its scenario.
// fd_dynamics gives ddq and the contact forces of given (x, u, params),
// one thread per lane: FullDynamicsOCP.get_contact_forces and
// state_derivative (JAX ocp/fulldynamics.py:291-294, 398-401) on the card.
//
// The two stage kernels are linearize.cu's stage_linearize and stage_eval
// over the full-dynamics stage.  linearize.cu keeps its own copies: sharing
// one templated kernel changed nvcc's FMA contraction in the
// kinodynamics kernels (the same arithmetic in source order, bitwise equal
// in a host build), which moved the f32 re-solve of the kinodynamics
// fixture from 2.5e-5 to 1.1e-4 against its 1e-4 gate.
//
// What bounds them on the card: scattered scalar arithmetic.  A lane's
// primal K7 is about 30 kFLOP (the 18x18 CRBA and Cholesky, a 13-column
// solve, the 12x12 Delassus product and Cholesky); the linearization
// repeats it in Dual arithmetic on each of 48 threads, with ~2k dual
// scalars of factors and solves per thread in local memory.  Each thread
// recomputes the kinematics and the factorizations; sharing the primal
// factors across the block (the tangent through M^-1 as M^-1 (dr - dM x))
// and tensor cores for the products are left for later work.
//
// Layouts (row-major, contiguous) as linearize.cu's, with f_ref
// (B,T,nk,3) beside the other stage parameters; fd_dynamics: x (N,nx)
// u (N,nu) active (N,nk) foot_ref_p (N,nk,3); out ddq (N,nv) f (N,nk,3).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "fulldyn.cuh"

namespace smpc {
namespace {

constexpr int kLinThreads = 64;
constexpr int kEvalThreads = 128;

template <class F>
struct ParamPtrs {
  const F* active;
  const F* foot_ref_p;
  const F* x_ref;
  const F* u_ref;
  const F* f_ref;
  const F* land;

  __device__ StageParams<F> at(const Dims& D, size_t n) const {
    const int nx = D.nq + D.nv;
    StageParams<F> p;
    p.active = active + n * D.nk;
    p.foot_ref_p = foot_ref_p + n * 3 * D.nk;
    p.x_ref = x_ref + n * nx;
    p.u_ref = u_ref + n * D.nu;
    p.f_ref = f_ref + n * 3 * D.nk;
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
    const F ws = msqrt(w);
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
__global__ void __launch_bounds__(kLinThreads)
fd_stage_linearize_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                       const F* __restrict__ us, ParamPtrs<F> P,
                       const F* __restrict__ lam_eq, const F* __restrict__ lam_in,
                       const F* __restrict__ mu, const F* __restrict__ su, int nT,
                       F* __restrict__ A, F* __restrict__ Bm, F* __restrict__ d,
                       F* __restrict__ qx, F* __restrict__ qu, F* __restrict__ Qxx,
                       F* __restrict__ Quu, F* __restrict__ Qux) {
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
    Dual<F> q[kMaxQ], v[kMaxV], u[kMaxU];
    seed_state(D, X, j < ndx ? j : -1, q, v);
    for (int i = 0; i < nu; ++i)
      u[i] = Dual<F>(U[i], (j - ndx == i) ? (su ? su[i] : F(1)) : F(0));
    LinSink<F> sink{jw + j, jd + j, wr, d0, ndir, j == 0};
    smpc::fd_stage_bundle(D, C, q, v, u, X + nx, P.at(D, n), mu[b], lam_eq + n * D.n_eq,
                          lam_in + n * D.n_in, sink);
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
fd_stage_eval_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                  const F* __restrict__ us, ParamPtrs<F> P, const F* __restrict__ lam_eq,
                  const F* __restrict__ lam_in, const F* __restrict__ mu, int n_alpha,
                  int nT, size_t n_lanes, F* __restrict__ cost, F* __restrict__ g,
                  F* __restrict__ h, F* __restrict__ gap) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nq = D.nq, nv = D.nv, nu = D.nu, nx = nq + nv;
  const size_t ba = m / nT, t = m % nT, b = ba / n_alpha;
  const size_t n = b * nT + t;  // the scenario's stage
  const F* X = xs + (ba * (nT + 1) + t) * nx;
  const F* U = us + m * nu;
  EvalSink<F> sink{F(0), g + m * D.n_eq, h + m * D.n_in, gap + m * 2 * nv};
  smpc::fd_stage_bundle(D, C, X, X + nq, U, X + nx, P.at(D, n), mu[b],
                        lam_eq + n * D.n_eq, lam_in + n * D.n_in, sink);
  cost[m] = F(0.5) * sink.cost;
}

Dims load_dims(const int* dims) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  return D;
}

template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <class F>
ParamPtrs<F> param_ptrs(const void* active, const void* foot_ref_p, const void* x_ref,
                        const void* u_ref, const void* f_ref, const void* land) {
  return ParamPtrs<F>{static_cast<const F*>(active), static_cast<const F*>(foot_ref_p),
                      static_cast<const F*>(x_ref), static_cast<const F*>(u_ref),
                      static_cast<const F*>(f_ref), static_cast<const F*>(land)};
}

template <class F>
int launch_linearize(const int* dims, const void* C, const void* xs, const void* us,
                     const ParamPtrs<F>& P, const void* lam_eq, const void* lam_in,
                     const void* mu, const void* su, int nbatch, int nT, void* A, void* Bm,
                     void* d, void* qx, void* qu, void* Qxx, void* Quu, void* Qux,
                     void* stream) {
  const Dims D = load_dims(dims);
  const int ndx = 2 * D.nv, ndir = ndx + D.nu;
  const int nr = D.n_cost + D.n_eq + D.n_in;
  if (ndir > kLinThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)(nr + ndx) * ndir + nr + ndx) * sizeof(F);
  if (int e = set_smem(fd_stage_linearize_kernel<F>, smem)) return e;
  fd_stage_linearize_kernel<F><<<nbatch * nT, kLinThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      P, static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
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
  const size_t n_lanes = (size_t)nbatch * n_alpha * nT;
  const unsigned blocks = (unsigned)((n_lanes + kEvalThreads - 1) / kEvalThreads);
  fd_stage_eval_kernel<F><<<blocks, kEvalThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      P, static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), n_alpha, nT, n_lanes, static_cast<F*>(cost),
      static_cast<F*>(g), static_cast<F*>(h), static_cast<F*>(gap));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kDynThreads = 128;

template <class F>
__global__ void __launch_bounds__(kDynThreads)
fd_dynamics_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                   const F* __restrict__ u, const F* __restrict__ active,
                   const F* __restrict__ foot_ref_p, int n_lanes, F* __restrict__ ddq,
                   F* __restrict__ f) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nq = D.nq, nv = D.nv, nk = D.nk;
  const F* X = x + (size_t)m * (nq + nv);
  FdKin<F> K;
  fd_kinematics(D, C, X, X + nq, K);
  constrained_dynamics(D, C, K, X + nq, u + (size_t)m * D.nu, active + (size_t)m * nk,
                       foot_ref_p + (size_t)m * 3 * nk, ddq + (size_t)m * nv,
                       f + (size_t)m * 3 * nk);
}

template <class F>
int launch_dynamics(const int* dims, const void* C, const void* x, const void* u,
                    const void* active, const void* foot_ref_p, int n_lanes, void* ddq,
                    void* f, void* stream) {
  const Dims D = load_dims(dims);
  const unsigned blocks = (unsigned)((n_lanes + kDynThreads - 1) / kDynThreads);
  fd_dynamics_kernel<F><<<blocks, kDynThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x), static_cast<const F*>(u),
      static_cast<const F*>(active), static_cast<const F*>(foot_ref_p), n_lanes,
      static_cast<F*>(ddq), static_cast<F*>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace smpc

extern "C" {

#define SMPC_FULLDYN(sfx, F)                                                         \
  int smpc_fd_stage_linearize_##sfx(                                                 \
      const int* dims, const void* C, const void* xs, const void* us,                \
      const void* active, const void* foot_ref_p, const void* x_ref,                 \
      const void* u_ref, const void* f_ref, const void* land, const void* lam_eq,    \
      const void* lam_in, const void* mu, const void* su, int nbatch, int nT,        \
      void* A, void* Bm, void* d, void* qx, void* qu, void* Qxx, void* Quu,          \
      void* Qux, void* stream) {                                                     \
    return smpc::launch_linearize<F>(                                                \
        dims, C, xs, us,                                                             \
        smpc::param_ptrs<F>(active, foot_ref_p, x_ref, u_ref, f_ref, land), lam_eq,  \
        lam_in, mu, su, nbatch, nT, A, Bm, d, qx, qu, Qxx, Quu, Qux, stream);        \
  }                                                                                  \
  int smpc_fd_stage_eval_##sfx(                                                      \
      const int* dims, const void* C, const void* xs, const void* us,                \
      const void* active, const void* foot_ref_p, const void* x_ref,                 \
      const void* u_ref, const void* f_ref, const void* land, const void* lam_eq,    \
      const void* lam_in, const void* mu, int nbatch, int n_alpha, int nT,           \
      void* cost, void* g, void* h, void* gap, void* stream) {                       \
    return smpc::launch_eval<F>(                                                     \
        dims, C, xs, us,                                                             \
        smpc::param_ptrs<F>(active, foot_ref_p, x_ref, u_ref, f_ref, land), lam_eq,  \
        lam_in, mu, nbatch, n_alpha, nT, cost, g, h, gap, stream);                   \
  }                                                                                  \
  int smpc_fd_dynamics_##sfx(const int* dims, const void* C, const void* x,          \
                             const void* u, const void* active,                      \
                             const void* foot_ref_p, int n_lanes, void* ddq,         \
                             void* f, void* stream) {                                \
    return smpc::launch_dynamics<F>(dims, C, x, u, active, foot_ref_p, n_lanes, ddq, \
                                    f, stream);                                      \
  }

SMPC_FULLDYN(f32, float)
SMPC_FULLDYN(f64, double)

}  // extern "C"
