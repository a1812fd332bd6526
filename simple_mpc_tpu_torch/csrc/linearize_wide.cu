// The wide stage kernels: K1 + K2, K1 on the candidates and K5 for models
// that csrc/linearize.cu refuses — 6D contacts (a wrench per foot), more
// than 16 joints or more than 64 tangent directions; at most 32 joints, 8
// feet and 128 directions.  The Talos kinodynamics stage (23 joints, two
// 6D quad feet) has nq = 29, nv = 28, ndx = 56, nu = 34: 90 directions and
// 170 AL rows a stage (114 cost, 12 equality, 44 joint box), 204 with the
// two 17-row wrench cones.
//
// wide_stage_linearize replaces simple_mpc_tpu/solver/proxddp.py
// ProxDDPSolver._linearize_traj_soa (271-350) with _stage_bundle_soa
// (166-176) and ocp/kinodynamics.py stage_eval_soa (259-355) at these
// shapes; wide_stage_eval the candidate evaluation of _eval_traj
// (183-205); wide_term_linearize _linearize_term (352-369).  Their twins
// are the same plain PyTorch functions as the Go2 kernels'
// (kernels.py `_linearize_traj_plain`, `_eval_traj_plain`,
// `_linearize_term_plain`).
//
// The design is linearize.cu's, at a wider block: one block of 128 threads
// a lane, thread j < ndx + nu evaluating the bundle (csrc/stage_wide.cuh)
// in Dual arithmetic along direction j and writing its column of ws*Jr (nr
// rows) and of Jgap (ndx rows) to shared memory; after one barrier the
// block forms qx, qu and the Qxx, Quu, Qux blocks of the Gauss-Newton
// Hessian straight from the columns in shared memory (no 90x90 H is kept)
// and writes A, B, d into the (B, T, ...) layout the Riccati kernel reads.
// The candidates take one thread a (scenario, step size, stage) lane in
// primal arithmetic; the terminal Jacobian one block a scenario, thread j <
// ndx along direction j.
//
// What bounds them on the card: the linearization is compute- and
// local-memory-bound as linearize.cu is, at about three times its work a
// lane (23 joints, 170 rows, 6196 dot products of length 170 for the GN
// blocks).  Its shared memory, (nr + ndx) x ndir scalars, is 82 KB a block
// in f32 and 165 KB in f64 for Talos (189 KB in f64 with the cones), so one
// or two blocks share an SM and latency is poorly hidden.  Each thread's
// dual kinematics (kinematic tree, dof axes, body motions of 32 joints) sit
// in local memory.  A simple, right kernel first: sharing the primal and the
// u-independent kinematics across the block, and tensor cores for the GN
// products, are later work.
//
// Layouts (row-major, contiguous) are linearize.cu's, with foot_ref_R
// (B,T,nk,3,3) among the stage parameters.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "stage_wide.cuh"

namespace {

using smpc_wide::Dims;
using smpc_wide::Dual;

constexpr int kWideThreads = 128;  // tangent directions a block takes
constexpr int kEvalThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's dynamic shared memory on sm_90

template <class F>
struct ParamPtrs {
  const F* active;
  const F* foot_ref_R;
  const F* foot_ref_p;
  const F* x_ref;
  const F* u_ref;
  const F* land;

  __device__ smpc_wide::WideParams<F> at(const Dims& D, size_t n) const {
    const int nx = D.nq + D.nv;
    smpc_wide::WideParams<F> p;
    p.active = active + n * D.nk;
    p.foot_ref_R = foot_ref_R + n * 9 * D.nk;
    p.foot_ref_p = foot_ref_p + n * 3 * D.nk;
    p.x_ref = x_ref + n * nx;
    p.u_ref = u_ref + n * D.nu;
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
linearize_wide_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
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
    Dual<F> q[smpc_wide::kMaxQ], v[smpc_wide::kMaxV], u[smpc_wide::kMaxU];
    smpc_wide::seed_state(D, X, j < ndx ? j : -1, q, v);
    for (int i = 0; i < nu; ++i)
      u[i] = Dual<F>(U[i], (j - ndx == i) ? (su ? su[i] : F(1)) : F(0));
    LinSink<F> sink{jw + j, jd + j, wr, d0, ndir, j == 0};
    smpc_wide::stage_bundle_wide(D, C, q, v, u, X + nx, P.at(D, n), mu[b],
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
eval_wide_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                 const F* __restrict__ us, ParamPtrs<F> P, const F* __restrict__ lam_eq,
                 const F* __restrict__ lam_in, const F* __restrict__ mu, int n_alpha, int nT,
                 size_t n_lanes, F* __restrict__ cost, F* __restrict__ g,
                 F* __restrict__ h, F* __restrict__ gap) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nq = D.nq, nv = D.nv, nu = D.nu, nx = nq + nv;
  const size_t ba = m / nT, t = m % nT, b = ba / n_alpha;
  const size_t n = b * nT + t;  // the scenario's stage
  const F* X = xs + (ba * (nT + 1) + t) * nx;
  const F* U = us + m * nu;
  EvalSink<F> sink{F(0), g + m * D.n_eq, h + m * D.n_in, gap + m * 2 * nv};
  smpc_wide::stage_bundle_wide(D, C, X, X + nq, U, X + nx, P.at(D, n), mu[b],
                               lam_eq + n * D.n_eq, lam_in + n * D.n_in, sink);
  cost[m] = F(0.5) * sink.cost;
}

template <class F>
struct TermSink {
  F* J;  // column j, strided by ndx
  F* wr;
  F* w0;
  int ndx;
  bool primal;
  __device__ void row(int n, const Dual<F>& r, F w) {
    J[n * ndx] = r.d;
    if (primal) { wr[n] = w * r.v; w0[n] = w; }
  }
};

template <class F>
__global__ void __launch_bounds__(kWideThreads)
term_wide_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                 const F* __restrict__ x_ref, const F* __restrict__ dcm_ref,
                 const F* __restrict__ lam, const F* __restrict__ mu, F* __restrict__ Vx,
                 F* __restrict__ Vxx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = D.nq, nv = D.nv, nx = nq + nv, ndx = 2 * nv;
  const int nr = D.n_term_cost + D.n_term_eq;
  F* J = reinterpret_cast<F*>(smem_raw);  // nr x ndx
  F* wr = J + (size_t)nr * ndx;           // nr
  F* w0 = wr + nr;                        // nr
  const size_t b = blockIdx.x;
  const int j = threadIdx.x;
  if (j < ndx) {
    Dual<F> xd[smpc_wide::kMaxQ + smpc_wide::kMaxV];
    smpc_wide::seed_state(D, x + b * nx, j, xd, xd + nq);
    TermSink<F> sink{J + j, wr, w0, ndx, j == 0};
    smpc_wide::term_bundle(D, C, xd, x_ref + b * nx, dcm_ref + b * 3, mu[b],
                           lam + b * D.n_term_eq, sink);
  }
  __syncthreads();
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < ndx; i += nth) {
    F s = 0;
    for (int r = 0; r < nr; ++r) s += J[r * ndx + i] * wr[r];
    Vx[b * ndx + i] = s;
  }
  for (int idx = tid; idx < ndx * ndx; idx += nth) {
    const int a = idx / ndx, c = idx % ndx;
    F s = 0;
    for (int r = 0; r < nr; ++r) s += J[r * ndx + a] * (w0[r] * J[r * ndx + c]);
    Vxx[b * ndx * ndx + idx] = s;
  }
}

Dims load_dims(const int* dims) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  return D;
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
                    const void* x_ref, const void* u_ref, const void* land) {
  return ParamPtrs<F>{static_cast<const F*>(active), static_cast<const F*>(foot_ref_R),
                      static_cast<const F*>(foot_ref_p), static_cast<const F*>(x_ref),
                      static_cast<const F*>(u_ref), static_cast<const F*>(land)};
}

template <class F>
int launch_linearize(const int* dims, const void* C, const void* xs, const void* us,
                     const void* active, const void* foot_ref_R, const void* foot_ref_p,
                     const void* x_ref, const void* u_ref, const void* land,
                     const void* lam_eq, const void* lam_in, const void* mu, const void* su,
                     int nbatch, int nT, void* A, void* Bm, void* d, void* qx, void* qu,
                     void* Qxx, void* Quu, void* Qux, void* stream) {
  const Dims D = load_dims(dims);
  const int ndx = 2 * D.nv, ndir = ndx + D.nu;
  const int nr = D.n_cost + D.n_eq + D.n_in;
  if (ndir > kWideThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)(nr + ndx) * ndir + nr + ndx) * sizeof(F);
  if (int e = set_smem(linearize_wide_kernel<F>, smem)) return e;
  linearize_wide_kernel<F><<<nbatch * nT, kWideThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      params<F>(active, foot_ref_R, foot_ref_p, x_ref, u_ref, land),
      static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), static_cast<const F*>(su), nT, static_cast<F*>(A),
      static_cast<F*>(Bm), static_cast<F*>(d), static_cast<F*>(qx), static_cast<F*>(qu),
      static_cast<F*>(Qxx), static_cast<F*>(Quu), static_cast<F*>(Qux));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_eval(const int* dims, const void* C, const void* xs, const void* us,
                const void* active, const void* foot_ref_R, const void* foot_ref_p,
                const void* x_ref, const void* u_ref, const void* land, const void* lam_eq,
                const void* lam_in, const void* mu, int nbatch, int n_alpha, int nT,
                void* cost, void* g, void* h, void* gap, void* stream) {
  const Dims D = load_dims(dims);
  const size_t n_lanes = (size_t)nbatch * n_alpha * nT;
  const unsigned blocks = (unsigned)((n_lanes + kEvalThreads - 1) / kEvalThreads);
  eval_wide_kernel<F><<<blocks, kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      params<F>(active, foot_ref_R, foot_ref_p, x_ref, u_ref, land),
      static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), n_alpha, nT, n_lanes, static_cast<F*>(cost),
      static_cast<F*>(g), static_cast<F*>(h), static_cast<F*>(gap));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_term(const int* dims, const void* C, const void* x, const void* x_ref,
                const void* dcm_ref, const void* lam, const void* mu, int nbatch, void* Vx,
                void* Vxx, void* stream) {
  const Dims D = load_dims(dims);
  const int ndx = 2 * D.nv;
  const int nr = D.n_term_cost + D.n_term_eq;
  if (ndx > kWideThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)nr * ndx + 2 * nr) * sizeof(F);
  if (int e = set_smem(term_wide_kernel<F>, smem)) return e;
  term_wide_kernel<F><<<nbatch, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x), static_cast<const F*>(x_ref),
      static_cast<const F*>(dcm_ref), static_cast<const F*>(lam), static_cast<const F*>(mu),
      static_cast<F*>(Vx), static_cast<F*>(Vxx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smpc_wide_dims_ints() { return static_cast<int>(sizeof(Dims) / sizeof(int)); }

#define SMPC_WIDE(sfx, F)                                                             \
  int smpc_wide_stage_linearize_##sfx(                                                \
      const int* dims, const void* C, const void* xs, const void* us,                 \
      const void* active, const void* foot_ref_R, const void* foot_ref_p,             \
      const void* x_ref, const void* u_ref, const void* land, const void* lam_eq,     \
      const void* lam_in, const void* mu, const void* su, int nbatch, int nT,         \
      void* A, void* Bm, void* d, void* qx, void* qu, void* Qxx, void* Quu,           \
      void* Qux, void* stream) {                                                      \
    return launch_linearize<F>(dims, C, xs, us, active, foot_ref_R, foot_ref_p,       \
                               x_ref, u_ref, land, lam_eq, lam_in, mu, su, nbatch,    \
                               nT, A, Bm, d, qx, qu, Qxx, Quu, Qux, stream);          \
  }                                                                                   \
  int smpc_wide_stage_eval_##sfx(                                                     \
      const int* dims, const void* C, const void* xs, const void* us,                 \
      const void* active, const void* foot_ref_R, const void* foot_ref_p,             \
      const void* x_ref, const void* u_ref, const void* land, const void* lam_eq,     \
      const void* lam_in, const void* mu, int nbatch, int n_alpha, int nT,            \
      void* cost, void* g, void* h, void* gap, void* stream) {                        \
    return launch_eval<F>(dims, C, xs, us, active, foot_ref_R, foot_ref_p, x_ref,     \
                          u_ref, land, lam_eq, lam_in, mu, nbatch, n_alpha, nT, cost, \
                          g, h, gap, stream);                                         \
  }                                                                                   \
  int smpc_wide_term_linearize_##sfx(const int* dims, const void* C, const void* x,   \
                                     const void* x_ref, const void* dcm_ref,          \
                                     const void* lam, const void* mu, int nbatch,     \
                                     void* Vx, void* Vxx, void* stream) {             \
    return launch_term<F>(dims, C, x, x_ref, dcm_ref, lam, mu, nbatch, Vx, Vxx,       \
                          stream);                                                    \
  }

SMPC_WIDE(f32, float)
SMPC_WIDE(f64, double)

}  // extern "C"
