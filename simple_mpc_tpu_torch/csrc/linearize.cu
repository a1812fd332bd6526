// K1 + K2: the stage linearization of the ProxDDP iteration; K1 in primal
// mode on the line-search candidates; K5: the terminal Jacobian.
//
// stage_linearize replaces simple_mpc_tpu/solver/proxddp.py
// ProxDDPSolver._linearize_traj_soa (271-350) together with
// _stage_bundle_soa (166-176) and ocp/kinodynamics.py stage_eval_soa
// (259-355): the stage bundle on N = B*T lanes, its forward tangents along
// the 60 basis directions (18 dq, 18 dv, 24 du scaled by u_scale) and the
// Gauss-Newton products
//   ws = sqrt(w_all), grad = (ws Jr)'(ws r), H = (ws Jr)'(ws Jr),
//   A = dgap/ddx, B = dgap/ddu, d = difference(x_{t+1}, xnext).
// One block of 64 threads per lane: thread j < 60 evaluates the bundle in
// Dual arithmetic along direction j and writes its column of ws*Jr (nr
// rows) and of Jgap (36 rows) to shared memory; after a barrier the block
// forms grad and the Qxx, Quu, Qux blocks of H and writes A, B, d, qx, qu,
// Qxx, Quu, Qux straight into the (B, T, ...) layout the Riccati kernel
// reads.  The Jacobian never reaches device memory.
//
// stage_eval replaces the candidate evaluation of ProxDDPSolver._eval_traj
// (183-205): one thread per (scenario, step size, stage) lane computes the
// AL stage cost 0.5 sum w_all r_all^2, the raw constraints g, h and the gap.
// The stage parameters and multipliers are read at the lane's scenario, so
// the n_alpha copies the JAX package tiles are never made.
//
// term_linearize replaces ProxDDPSolver._linearize_term (352-369): one
// block per scenario, thread j < 36 in Dual along tangent direction j of
// the terminal state; Vx = J'(w r), Vxx = J' diag(w) J.
//
// What bounds them on the card: the linearization is compute-bound in
// scattered scalar arithmetic (the bundle is ~20 kFLOP in primal mode, so
// ~3 MFLOP of dual arithmetic a lane, plus 2736 dot products of length nr
// for the GN blocks), with each thread's kinematics (~3-6 KB of dual
// scalars) in local memory; the block's shared memory (156x60 scalars, 37
// KB f32 / 75 KB f64) bounds the blocks resident on an SM.  The design
// spends one thread per direction rather than one kernel launch per
// operation: the plain twin issues about 32k small launches for the same
// work.  Sharing the primal and the u-independent kinematics across the
// block, and tensor cores for the GN products, are left for later work.
//
// Layouts (row-major, contiguous):
//   xs (B,T+1,nx)  us (B,T,nu)  stage params (B,T,...)  lam_eq (B,T,n_eq)
//   lam_in (B,T,n_in)  mu (B)  su (nu) or null
//   out: A (B,T,ndx,ndx)  Bm (B,T,ndx,nu)  d (B,T,ndx)  qx (B,T,ndx)
//        qu (B,T,nu)  Qxx (B,T,ndx,ndx)  Quu (B,T,nu,nu)  Qux (B,T,nu,ndx)
//   stage_eval: xs (B,nA,T+1,nx)  us (B,nA,T,nu); out cost (B,nA,T),
//        g (B,nA,T,n_eq)  h (B,nA,T,n_in)  gap (B,nA,T,ndx)
//   term_linearize: x (B,nx)  x_ref (B,nx)  dcm_ref (B,3)  lam (B,n_term_eq);
//        out Vx (B,ndx)  Vxx (B,ndx,ndx)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "stage.cuh"

namespace {

using smpc::Dims;
using smpc::Dual;

constexpr int kLinThreads = 64;
constexpr int kEvalThreads = 128;

template <class F>
struct ParamPtrs {
  const F* active;
  const F* foot_ref_p;
  const F* x_ref;
  const F* u_ref;
  const F* land;

  __device__ smpc::StageParams<F> at(const Dims& D, size_t n) const {
    const int nx = D.nq + D.nv;
    smpc::StageParams<F> p;
    p.active = active + n * D.nk;
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
    const F ws = smpc::msqrt(w);
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
stage_linearize_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
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
    Dual<F> q[smpc::kMaxQ], v[smpc::kMaxV], u[smpc::kMaxU];
    smpc::seed_state(D, X, j < ndx ? j : -1, q, v);
    for (int i = 0; i < nu; ++i)
      u[i] = Dual<F>(U[i], (j - ndx == i) ? (su ? su[i] : F(1)) : F(0));
    LinSink<F> sink{jw + j, jd + j, wr, d0, ndir, j == 0};
    smpc::stage_bundle(D, C, q, v, u, X + nx, P.at(D, n), mu[b],
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
stage_eval_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
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
  smpc::stage_bundle(D, C, X, X + nq, U, X + nx, P.at(D, n), mu[b],
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
__global__ void __launch_bounds__(kLinThreads)
term_linearize_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                      const F* __restrict__ x_ref, const F* __restrict__ dcm_ref,
                      const F* __restrict__ lam, const F* __restrict__ mu,
                      F* __restrict__ Vx, F* __restrict__ Vxx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = D.nq, nv = D.nv, nx = nq + nv, ndx = 2 * nv;
  const int nr = D.n_term_cost + D.n_term_eq;
  F* J = reinterpret_cast<F*>(smem_raw);  // nr x ndx
  F* wr = J + (size_t)nr * ndx;           // nr
  F* w0 = wr + nr;                        // nr
  const size_t b = blockIdx.x;
  const int j = threadIdx.x;
  if (j < ndx) {
    Dual<F> xd[smpc::kMaxQ + smpc::kMaxV];
    smpc::seed_state(D, x + b * nx, j, xd, xd + nq);
    TermSink<F> sink{J + j, wr, w0, ndx, j == 0};
    smpc::term_bundle(D, C, xd, x_ref + b * nx, dcm_ref + b * 3, mu[b],
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
int launch_linearize(const int* dims, const void* C, const void* xs, const void* us,
                     const void* active, const void* foot_ref_p, const void* x_ref,
                     const void* u_ref, const void* land, const void* lam_eq,
                     const void* lam_in, const void* mu, const void* su, int nbatch,
                     int nT, void* A, void* Bm, void* d, void* qx, void* qu, void* Qxx,
                     void* Quu, void* Qux, void* stream) {
  const Dims D = load_dims(dims);
  const int ndx = 2 * D.nv, ndir = ndx + D.nu;
  const int nr = D.n_cost + D.n_eq + D.n_in;
  if (ndir > kLinThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)(nr + ndx) * ndir + nr + ndx) * sizeof(F);
  if (int e = set_smem(stage_linearize_kernel<F>, smem)) return e;
  ParamPtrs<F> P{static_cast<const F*>(active), static_cast<const F*>(foot_ref_p),
                 static_cast<const F*>(x_ref), static_cast<const F*>(u_ref),
                 static_cast<const F*>(land)};
  stage_linearize_kernel<F><<<nbatch * nT, kLinThreads, smem,
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
                const void* active, const void* foot_ref_p, const void* x_ref,
                const void* u_ref, const void* land, const void* lam_eq,
                const void* lam_in, const void* mu, int nbatch, int n_alpha, int nT,
                void* cost, void* g, void* h, void* gap, void* stream) {
  const Dims D = load_dims(dims);
  const size_t n_lanes = (size_t)nbatch * n_alpha * nT;
  const unsigned blocks = (unsigned)((n_lanes + kEvalThreads - 1) / kEvalThreads);
  ParamPtrs<F> P{static_cast<const F*>(active), static_cast<const F*>(foot_ref_p),
                 static_cast<const F*>(x_ref), static_cast<const F*>(u_ref),
                 static_cast<const F*>(land)};
  stage_eval_kernel<F><<<blocks, kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      P, static_cast<const F*>(lam_eq), static_cast<const F*>(lam_in),
      static_cast<const F*>(mu), n_alpha, nT, n_lanes, static_cast<F*>(cost),
      static_cast<F*>(g), static_cast<F*>(h), static_cast<F*>(gap));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_term(const int* dims, const void* C, const void* x, const void* x_ref,
                const void* dcm_ref, const void* lam, const void* mu, int nbatch,
                void* Vx, void* Vxx, void* stream) {
  const Dims D = load_dims(dims);
  const int ndx = 2 * D.nv;
  const int nr = D.n_term_cost + D.n_term_eq;
  if (ndx > kLinThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)nr * ndx + 2 * nr) * sizeof(F);
  if (int e = set_smem(term_linearize_kernel<F>, smem)) return e;
  term_linearize_kernel<F><<<nbatch, kLinThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x),
      static_cast<const F*>(x_ref), static_cast<const F*>(dcm_ref),
      static_cast<const F*>(lam), static_cast<const F*>(mu), static_cast<F*>(Vx),
      static_cast<F*>(Vxx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smpc_dims_ints() { return static_cast<int>(sizeof(Dims) / sizeof(int)); }

#define SMPC_LINEARIZE(sfx, F)                                                      \
  int smpc_stage_linearize_##sfx(                                                   \
      const int* dims, const void* C, const void* xs, const void* us,               \
      const void* active, const void* foot_ref_p, const void* x_ref,                \
      const void* u_ref, const void* land, const void* lam_eq, const void* lam_in,  \
      const void* mu, const void* su, int nbatch, int nT, void* A, void* Bm,        \
      void* d, void* qx, void* qu, void* Qxx, void* Quu, void* Qux, void* stream) { \
    return launch_linearize<F>(dims, C, xs, us, active, foot_ref_p, x_ref, u_ref,   \
                               land, lam_eq, lam_in, mu, su, nbatch, nT, A, Bm, d,  \
                               qx, qu, Qxx, Quu, Qux, stream);                      \
  }                                                                                 \
  int smpc_stage_eval_##sfx(const int* dims, const void* C, const void* xs,         \
                            const void* us, const void* active,                     \
                            const void* foot_ref_p, const void* x_ref,              \
                            const void* u_ref, const void* land,                    \
                            const void* lam_eq, const void* lam_in, const void* mu, \
                            int nbatch, int n_alpha, int nT, void* cost, void* g,   \
                            void* h, void* gap, void* stream) {                     \
    return launch_eval<F>(dims, C, xs, us, active, foot_ref_p, x_ref, u_ref, land,  \
                          lam_eq, lam_in, mu, nbatch, n_alpha, nT, cost, g, h, gap, \
                          stream);                                                  \
  }                                                                                 \
  int smpc_term_linearize_##sfx(const int* dims, const void* C, const void* x,      \
                                const void* x_ref, const void* dcm_ref,             \
                                const void* lam, const void* mu, int nbatch,        \
                                void* Vx, void* Vxx, void* stream) {                \
    return launch_term<F>(dims, C, x, x_ref, dcm_ref, lam, mu, nbatch, Vx, Vxx,     \
                          stream);                                                  \
  }

SMPC_LINEARIZE(f32, float)
SMPC_LINEARIZE(f64, double)

}  // extern "C"
