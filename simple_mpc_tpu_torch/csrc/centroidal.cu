// The centroidal formulation's stage kernels (csrc/centroidal.cuh).
//
// centroidal_stage_linearize replaces the linearization of the JAX solver's
// generic path over CentroidalOCP (simple_mpc_tpu/solver/proxddp.py
// `_linearize_stage` 222-268 with `_stage_bundle`, over
// ocp/centroidal.py:107-170): one block per (scenario, stage) lane.  The
// block loads the lane, thread 0 forms the active forces' sum and torque,
// then each thread takes AL rows n: the residual r_n, its weight w_n (the
// 15 + nu cost rows with the settings' weights; each cone row as the AL
// term max(h + mu lam, 0) with weight act / mu) and the row of its Jacobian
// along the 9 state and nu control directions, in closed form (the stage is
// linear in u and bilinear in (com, f)), scaled by sqrt(w_n) into shared
// memory.  After a barrier the threads form the Gauss-Newton products
// grad = (sqrt(w) J)' sqrt(w) r and H = (sqrt(w) J)' (sqrt(w) J), the
// dynamics' A = I + dt d ode / dx, B = dt d ode / du and the gap
// d = x + dt ode - x_next.  With u scaling (su) the control columns are
// scaled by su, as the twin's tangents along su du are.
//
// centroidal_stage_eval (the candidates' K1, `_eval_traj`'s generic
// branch): one thread per (scenario, step size, stage) lane: the AL stage
// cost 0.5 sum w r^2, the raw cone rows and the gap.
// centroidal_term_linearize (K5, `_linearize_term`): one thread per
// scenario; the terminal rows are the momenta, so Vx = [0; w r] and Vxx =
// diag(0, w).
// centroidal_ode: the ODE on N lanes (MPC.get_state_derivative).
// vector_candidate_integrate / vector_state_difference: K4's integrate of
// the candidates and the initial gap on a vector space (x + dx, x2 - x1),
// one thread an element.
//
// What bounds them on the card: bytes.  At B=128, T=100 a lane of the
// linearization reads ~60 words and writes the LQ data, 9x9 + 9x12 + 9 +
// 9 + 12 + 81 + 144 + 108 = 552 words: ~57 MB in f64 at 12,800 lanes,
// ~17 us at 3.35 TB/s; its arithmetic, ~21 x 21 x 61 products a lane, is
// ~0.7 GFLOP.
//
// Layouts (row-major, contiguous): xs (B,T+1,9) us (B,T,nu); stage params
// active (B,T,nk) pose (B,T,nk,3) com_ref (B,T,3) u_ref (B,T,nu)
// linmom_ref angmom_ref (B,T,3); lam_in (B,T,n_in); mu (B); su (nu) or
// null; out A (B,T,9,9) B (B,T,9,nu) d qx (B,T,9) qu (B,T,nu) Qxx (B,T,9,9)
// Quu (B,T,nu,nu) Qux (B,T,nu,9).  stage_eval: xs (B,nA,T+1,9) us
// (B,nA,T,nu); out costs (B*nA,T) h (B*nA,T,n_in) gap (B*nA,T,9).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <math.h>

#include "centroidal.cuh"

namespace {

using smpc_cent::Dims;
using smpc_cent::Params;
constexpr int kNx = smpc_cent::kNx;
constexpr int kLinThreads = 64;
constexpr int kLaneThreads = 128;

template <class F>
__device__ Params<F> lane_params(const Dims& D, size_t lane, const F* active, const F* pose,
                                 const F* com_ref, const F* u_ref, const F* linmom_ref,
                                 const F* angmom_ref) {
  Params<F> P;
  P.active = active + lane * D.nk;
  P.pose = pose + lane * 3 * D.nk;
  P.com_ref = com_ref + lane * 3;
  P.u_ref = u_ref + lane * D.nu;
  P.linmom_ref = linmom_ref + lane * 3;
  P.angmom_ref = angmom_ref + lane * 3;
  return P;
}

// (r, w) of AL row n: a cost row, or cone row j = n - n_cost as
// max(h + mu lam, 0) with weight act / mu
template <class F>
__device__ void al_row(const Dims& D, const F* C, const F* x, const F* u, const Params<F>& P,
                       const F* fsum, const F* tau, const F* LI, F mu, int n, F& r, F& w,
                       bool& act) {
  if (n < D.n_cost) {
    r = smpc_cent::cost_row(D, C, x, u, P, fsum, tau, n);
    w = C[D.o_w + n];
    act = true;
    return;
  }
  const int j = n - D.n_cost;
  const F sh = smpc_cent::cone_row(D, C, u, P.active, j) + mu * LI[j];
  act = sh > F(0);
  r = act ? sh : F(0);
  w = (act ? F(1) : F(0)) / mu;
}

template <class F>
__global__ void __launch_bounds__(kLinThreads)
centroidal_linearize_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                            const F* __restrict__ us, const F* __restrict__ active,
                            const F* __restrict__ pose, const F* __restrict__ com_ref,
                            const F* __restrict__ u_ref, const F* __restrict__ linmom_ref,
                            const F* __restrict__ angmom_ref, const F* __restrict__ lam_in,
                            const F* __restrict__ mu, const F* __restrict__ su, int nT,
                            F* __restrict__ A, F* __restrict__ B, F* __restrict__ d,
                            F* __restrict__ qx, F* __restrict__ qu, F* __restrict__ Qxx,
                            F* __restrict__ Quu, F* __restrict__ Qux) {
  __shared__ F s_x[kNx], s_xn[kNx], s_u[smpc_cent::kMaxU], s_fsum[3], s_tau[3];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t lane = blockIdx.x, b = lane / nT;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int nu = D.nu, fs = D.fs, nk = D.nk, ndir = kNx + nu;
  const int nr = D.n_cost + D.n_in;
  F* Jw = reinterpret_cast<F*>(smem_raw);  // nr x ndir: sqrt(w) J
  F* wr = Jw + (size_t)nr * ndir;          // nr: sqrt(w) r

  const F* X = xs + (lane + b) * kNx;  // knot t of scenario b: (b (T+1) + t)
  const F* U = us + lane * nu;
  for (int i = tid; i < kNx; i += nth) {
    s_x[i] = X[i];
    s_xn[i] = X[kNx + i];
  }
  for (int i = tid; i < nu; i += nth) s_u[i] = U[i];
  const Params<F> P = lane_params(D, lane, active, pose, com_ref, u_ref, linmom_ref,
                                  angmom_ref);
  __syncthreads();
  if (tid == 0) smpc_cent::wrench(D, s_x, s_u, P.active, P.pose, s_fsum, s_tau);
  __syncthreads();

  const F m = C[D.o_scalars], dt = C[D.o_scalars + 1];
  const F mu_b = mu[b];
  const F* LI = lam_in + lane * D.n_in;
  for (int i = tid; i < nr * ndir; i += nth) Jw[i] = F(0);
  __syncthreads();
  for (int n = tid; n < nr; n += nth) {
    F r, w;
    bool act;
    al_row(D, C, s_x, s_u, P, s_fsum, s_tau, LI, mu_b, n, r, w, act);
    const F ws = sqrt(w);
    wr[n] = ws * r;
    F* J = Jw + (size_t)n * ndir;
    const int nc = D.n_cost;
    if (n < 3) {  // com
      J[n] = ws;
    } else if (n < 3 + nu) {  // control
      const int j = n - 3;
      J[kNx + j] = ws * (su ? su[j] : F(1));
    } else if (n < 9 + nu) {  // linear, angular momentum
      J[n - nu] = ws;
    } else if (n < 12 + nu) {  // linear acceleration: sum a_k f_k / m + g
      const int i = n - 9 - nu;
      for (int k = 0; k < nk; ++k) {
        const int j = fs * k + i;
        J[kNx + j] = ws * (P.active[k] / m) * (su ? su[j] : F(1));
      }
    } else if (n < nc) {  // tau = sum a_k (p_k - c) x f_k (+ sum a_k tau_k)
      const int i = n - 12 - nu, i1 = (i + 1) % 3, i2 = (i + 2) % 3;
      // d tau / d c = sum_k [a_k f_k]x, row i
      F dc1 = F(0), dc2 = F(0);
      for (int k = 0; k < nk; ++k) {
        const F a = P.active[k];
        dc1 -= s_u[fs * k + i2] * a;  // [f]x (i, i1) = -f_i2
        dc2 += s_u[fs * k + i1] * a;  // [f]x (i, i2) = f_i1
      }
      J[i1] = ws * dc1;
      J[i2] = ws * dc2;
      for (int k = 0; k < nk; ++k) {
        const F a = P.active[k];
        const F r1 = P.pose[3 * k + i1] - s_x[i1], r2 = P.pose[3 * k + i2] - s_x[i2];
        // [p - c]x row i: (i, i1) = -r_i2, (i, i2) = r_i1
        const int j1 = fs * k + i1, j2 = fs * k + i2;
        J[kNx + j1] = ws * (-r2 * a) * (su ? su[j1] : F(1));
        J[kNx + j2] = ws * (r1 * a) * (su ? su[j2] : F(1));
        if (fs == 6) {
          const int j3 = fs * k + 3 + i;
          J[kNx + j3] = ws * a * (su ? su[j3] : F(1));
        }
      }
    } else {  // cone row of foot k, on the raw control
      const int jr = n - nc, k = jr / D.n_cone, c = jr % D.n_cone;
      if (act && P.active[k] > F(0.5))
        for (int i = 0; i < fs; ++i) {
          const int j = fs * k + i;
          J[kNx + j] = ws * C[D.o_cone + fs * c + i] * (su ? su[j] : F(1));
        }
    }
  }
  __syncthreads();

  // the Gauss-Newton products
  for (int idx = tid; idx < ndir * ndir; idx += nth) {
    const int i = idx / ndir, j = idx % ndir;
    F s = F(0);
    for (int n = 0; n < nr; ++n) s += Jw[n * ndir + i] * Jw[n * ndir + j];
    if (i < kNx && j < kNx)
      Qxx[lane * kNx * kNx + i * kNx + j] = s;
    else if (i >= kNx && j >= kNx)
      Quu[lane * nu * nu + (i - kNx) * nu + (j - kNx)] = s;
    else if (i >= kNx)
      Qux[lane * nu * kNx + (i - kNx) * kNx + j] = s;
  }
  for (int i = tid; i < ndir; i += nth) {
    F s = F(0);
    for (int n = 0; n < nr; ++n) s += Jw[n * ndir + i] * wr[n];
    if (i < kNx)
      qx[lane * kNx + i] = s;
    else
      qu[lane * nu + i - kNx] = s;
  }

  // the dynamics: A = I + dt d ode / dx, B = dt d ode / du, the gap d
  for (int idx = tid; idx < kNx * kNx; idx += nth) {
    const int i = idx / kNx, j = idx % kNx;
    F a = (i == j) ? F(1) : F(0);
    if (i < 3 && j == i + 3) a += dt * (F(1) / m);
    if (i >= 6 && j < 3) {  // d tau / d c
      const int r = i - 6;
      F s = F(0);
      for (int k = 0; k < nk; ++k) {
        const F f1 = s_u[fs * k + (r + 1) % 3] * P.active[k];
        const F f2 = s_u[fs * k + (r + 2) % 3] * P.active[k];
        if (j == (r + 1) % 3) s -= f2;
        if (j == (r + 2) % 3) s += f1;
      }
      a += dt * s;
    }
    A[lane * kNx * kNx + idx] = a;
  }
  for (int idx = tid; idx < kNx * nu; idx += nth) {
    const int i = idx / nu, j = idx % nu, k = j / fs, c = j % fs;
    const F act = P.active[k];
    F s = F(0);
    if (i >= 3 && i < 6 && c == i - 3) s = act;
    if (i >= 6) {
      const int r = i - 6;
      if (c < 3) {  // [p_k - c]x (r, c)
        const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
        if (c == r1) s = -(P.pose[3 * k + r2] - s_x[r2]) * act;
        if (c == r2) s = (P.pose[3 * k + r1] - s_x[r1]) * act;
      } else if (c - 3 == r) {
        s = act;
      }
    }
    B[lane * kNx * nu + idx] = dt * s * (su ? su[j] : F(1));
  }
  if (tid < kNx) {
    const int i = tid;
    F o;
    if (i < 3)
      o = s_x[3 + i] / m;
    else if (i < 6)
      o = s_fsum[i - 3] + m * C[D.o_g + i - 3];
    else
      o = s_tau[i - 6];
    d[lane * kNx + i] = (s_x[i] + dt * o) - s_xn[i];
  }
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
centroidal_eval_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ xs,
                       const F* __restrict__ us, const F* __restrict__ active,
                       const F* __restrict__ pose, const F* __restrict__ com_ref,
                       const F* __restrict__ u_ref, const F* __restrict__ linmom_ref,
                       const F* __restrict__ angmom_ref, const F* __restrict__ lam_in,
                       const F* __restrict__ mu, int n_alpha, int nT, size_t n_lanes,
                       F* __restrict__ costs, F* __restrict__ h, F* __restrict__ gap) {
  const size_t m_ = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m_ >= n_lanes) return;
  const size_t t = m_ % nT, ba = m_ / nT, b = ba / n_alpha, lane = b * nT + t;
  const int nu = D.nu, n_in = D.n_in;
  const F* X = xs + (ba * (nT + 1) + t) * kNx;
  const F* U = us + m_ * nu;
  const Params<F> P = lane_params(D, lane, active, pose, com_ref, u_ref, linmom_ref,
                                  angmom_ref);
  F fsum[3], tau[3];
  smpc_cent::wrench(D, X, U, P.active, P.pose, fsum, tau);
  const F mu_b = mu[b];
  const F* LI = lam_in + lane * n_in;
  F cost = F(0);
  for (int n = 0; n < D.n_cost + n_in; ++n) {
    F r, w;
    bool act;
    al_row(D, C, X, U, P, fsum, tau, LI, mu_b, n, r, w, act);
    cost += w * r * r;
  }
  costs[m_] = F(0.5) * cost;
  for (int j = 0; j < n_in; ++j) h[m_ * n_in + j] = smpc_cent::cone_row(D, C, U, P.active, j);
  F o[kNx];
  smpc_cent::ode(D, C, X, U, P.active, P.pose, o);
  const F dt = C[D.o_scalars + 1];
  for (int i = 0; i < kNx; ++i) gap[m_ * kNx + i] = (X[i] + dt * o[i]) - X[kNx + i];
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
centroidal_term_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                       const F* __restrict__ linmom_ref, const F* __restrict__ angmom_ref,
                       int nbatch, F* __restrict__ Vx, F* __restrict__ Vxx) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbatch) return;
  const F* w = C + D.o_wterm;
  const F* xb = x + (size_t)b * kNx;
  for (int i = 0; i < kNx * kNx; ++i) Vxx[(size_t)b * kNx * kNx + i] = F(0);
  for (int i = 0; i < 3; ++i) Vx[(size_t)b * kNx + i] = F(0);
  for (int n = 0; n < 6; ++n) {
    const F r = xb[3 + n] - (n < 3 ? linmom_ref[b * 3 + n] : angmom_ref[b * 3 + n - 3]);
    Vx[(size_t)b * kNx + 3 + n] = w[n] * r;
    Vxx[(size_t)b * kNx * kNx + (3 + n) * kNx + 3 + n] = w[n];
  }
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
centroidal_ode_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                      const F* __restrict__ u, const F* __restrict__ active,
                      const F* __restrict__ pose, int n, F* __restrict__ out) {
  const size_t m_ = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m_ >= (size_t)n) return;
  smpc_cent::ode(D, C, x + m_ * kNx, u + m_ * D.nu, active + m_ * D.nk, pose + m_ * 3 * D.nk,
                 out + m_ * kNx);
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
vector_integrate_kernel(int nx, int nu, const F* __restrict__ xs, const F* __restrict__ us,
                        const F* __restrict__ dxs, const F* __restrict__ dus,
                        const F* __restrict__ su, int n_alpha, int nT, size_t n_x,
                        size_t n_u, F* __restrict__ xs_c, F* __restrict__ us_c) {
  const size_t m_ = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m_ < n_x) {
    const size_t i = m_ % nx, ba = m_ / nx / (nT + 1), t = (m_ / nx) % (nT + 1);
    const size_t b = ba / n_alpha;
    xs_c[m_] = xs[(b * (nT + 1) + t) * nx + i] + dxs[m_];
  } else if (m_ < n_x + n_u) {
    const size_t e = m_ - n_x;
    const size_t j = e % nu, ba = e / nu / nT, t = (e / nu) % nT, b = ba / n_alpha;
    us_c[e] = us[(b * nT + t) * nu + j] + (su ? dus[e] * su[j] : dus[e]);
  }
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
vector_difference_kernel(const F* __restrict__ x1, const F* __restrict__ x2, size_t n,
                         F* __restrict__ out) {
  const size_t m_ = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m_ < n) out[m_] = x2[m_] - x1[m_];
}

unsigned blocks_for(size_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

bool dims_ok(const Dims& D) {
  return D.nq + D.nv == kNx && D.nk <= smpc_cent::kMaxK && D.nu <= smpc_cent::kMaxU &&
         D.nu == D.fs * D.nk && D.n_in <= smpc_cent::kMaxIn && D.n_eq == 0 &&
         D.n_term_eq == 0 && (D.fs == 3 || D.fs == 6);
}

template <class F>
int launch_linearize(const int* dims, const void* C, const void* xs, const void* us,
                     const void* active, const void* pose, const void* com_ref,
                     const void* u_ref, const void* linmom_ref, const void* angmom_ref,
                     const void* lam_in, const void* mu, const void* su, int nbatch, int nT,
                     void* A, void* B, void* d, void* qx, void* qu, void* Qxx, void* Quu,
                     void* Qux, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (!dims_ok(D)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)nbatch * nT;
  if (n == 0) return 0;
  const int nr = D.n_cost + D.n_in;
  const size_t smem = ((size_t)nr * (kNx + D.nu) + nr) * sizeof(F);
  centroidal_linearize_kernel<F>
      <<<(unsigned)n, kLinThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
          static_cast<const F*>(active), static_cast<const F*>(pose),
          static_cast<const F*>(com_ref), static_cast<const F*>(u_ref),
          static_cast<const F*>(linmom_ref), static_cast<const F*>(angmom_ref),
          static_cast<const F*>(lam_in), static_cast<const F*>(mu),
          static_cast<const F*>(su), nT, static_cast<F*>(A), static_cast<F*>(B),
          static_cast<F*>(d), static_cast<F*>(qx), static_cast<F*>(qu), static_cast<F*>(Qxx),
          static_cast<F*>(Quu), static_cast<F*>(Qux));
  return (int)cudaGetLastError();
}

template <class F>
int launch_eval(const int* dims, const void* C, const void* xs, const void* us,
                const void* active, const void* pose, const void* com_ref, const void* u_ref,
                const void* linmom_ref, const void* angmom_ref, const void* lam_in,
                const void* mu, int nbatch, int n_alpha, int nT, void* costs, void* h,
                void* gap, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (!dims_ok(D)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)nbatch * n_alpha * nT;
  if (n == 0) return 0;
  centroidal_eval_kernel<F><<<blocks_for(n, kLaneThreads), kLaneThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(xs), static_cast<const F*>(us),
      static_cast<const F*>(active), static_cast<const F*>(pose),
      static_cast<const F*>(com_ref), static_cast<const F*>(u_ref),
      static_cast<const F*>(linmom_ref), static_cast<const F*>(angmom_ref),
      static_cast<const F*>(lam_in), static_cast<const F*>(mu), n_alpha, nT, n,
      static_cast<F*>(costs), static_cast<F*>(h), static_cast<F*>(gap));
  return (int)cudaGetLastError();
}

template <class F>
int launch_term(const int* dims, const void* C, const void* x, const void* linmom_ref,
                const void* angmom_ref, int nbatch, void* Vx, void* Vxx, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (!dims_ok(D)) return (int)cudaErrorInvalidValue;
  if (nbatch == 0) return 0;
  centroidal_term_kernel<F><<<blocks_for(nbatch, kLaneThreads), kLaneThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x),
      static_cast<const F*>(linmom_ref), static_cast<const F*>(angmom_ref), nbatch,
      static_cast<F*>(Vx), static_cast<F*>(Vxx));
  return (int)cudaGetLastError();
}

template <class F>
int launch_ode(const int* dims, const void* C, const void* x, const void* u,
               const void* active, const void* pose, int n, void* out, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (!dims_ok(D)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  centroidal_ode_kernel<F><<<blocks_for(n, kLaneThreads), kLaneThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x), static_cast<const F*>(u),
      static_cast<const F*>(active), static_cast<const F*>(pose), n, static_cast<F*>(out));
  return (int)cudaGetLastError();
}

template <class F>
int launch_vector_integrate(int nx, int nu, const void* xs, const void* us, const void* dxs,
                            const void* dus, const void* su, int nbatch, int n_alpha, int nT,
                            void* xs_c, void* us_c, void* stream) {
  const size_t n_x = (size_t)nbatch * n_alpha * (nT + 1) * nx;
  const size_t n_u = (size_t)nbatch * n_alpha * nT * nu;
  if (n_x + n_u == 0) return 0;
  vector_integrate_kernel<F><<<blocks_for(n_x + n_u, kLaneThreads), kLaneThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      nx, nu, static_cast<const F*>(xs), static_cast<const F*>(us),
      static_cast<const F*>(dxs), static_cast<const F*>(dus), static_cast<const F*>(su),
      n_alpha, nT, n_x, n_u, static_cast<F*>(xs_c), static_cast<F*>(us_c));
  return (int)cudaGetLastError();
}

template <class F>
int launch_vector_difference(int nx, const void* x1, const void* x2, int n, void* out,
                             void* stream) {
  const size_t m_ = (size_t)n * nx;
  if (m_ == 0) return 0;
  vector_difference_kernel<F><<<blocks_for(m_, kLaneThreads), kLaneThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const F*>(x1), static_cast<const F*>(x2), m_, static_cast<F*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int smpc_centroidal_dims_ints() { return (int)(sizeof(Dims) / sizeof(int)); }

#define SMPC_CENTROIDAL(sfx, F)                                                                \
  int smpc_centroidal_stage_linearize_##sfx(                                                   \
      const int* dims, const void* C, const void* xs, const void* us, const void* active,      \
      const void* pose, const void* com_ref, const void* u_ref, const void* linmom_ref,        \
      const void* angmom_ref, const void* lam_in, const void* mu, const void* su, int nbatch,  \
      int nT, void* A, void* B, void* d, void* qx, void* qu, void* Qxx, void* Quu, void* Qux, \
      void* stream) {                                                                          \
    return launch_linearize<F>(dims, C, xs, us, active, pose, com_ref, u_ref, linmom_ref,      \
                               angmom_ref, lam_in, mu, su, nbatch, nT, A, B, d, qx, qu, Qxx,   \
                               Quu, Qux, stream);                                              \
  }                                                                                            \
  int smpc_centroidal_stage_eval_##sfx(                                                        \
      const int* dims, const void* C, const void* xs, const void* us, const void* active,      \
      const void* pose, const void* com_ref, const void* u_ref, const void* linmom_ref,        \
      const void* angmom_ref, const void* lam_in, const void* mu, int nbatch, int n_alpha,    \
      int nT, void* costs, void* h, void* gap, void* stream) {                                 \
    return launch_eval<F>(dims, C, xs, us, active, pose, com_ref, u_ref, linmom_ref,           \
                          angmom_ref, lam_in, mu, nbatch, n_alpha, nT, costs, h, gap, stream); \
  }                                                                                            \
  int smpc_centroidal_term_linearize_##sfx(const int* dims, const void* C, const void* x,      \
                                           const void* linmom_ref, const void* angmom_ref,     \
                                           int nbatch, void* Vx, void* Vxx, void* stream) {    \
    return launch_term<F>(dims, C, x, linmom_ref, angmom_ref, nbatch, Vx, Vxx, stream);        \
  }                                                                                            \
  int smpc_centroidal_ode_##sfx(const int* dims, const void* C, const void* x, const void* u, \
                                const void* active, const void* pose, int n, void* out,        \
                                void* stream) {                                                \
    return launch_ode<F>(dims, C, x, u, active, pose, n, out, stream);                         \
  }                                                                                            \
  int smpc_vector_candidate_integrate_##sfx(int nx, int nu, const void* xs, const void* us,    \
                                            const void* dxs, const void* dus, const void* su,  \
                                            int nbatch, int n_alpha, int nT, void* xs_c,       \
                                            void* us_c, void* stream) {                        \
    return launch_vector_integrate<F>(nx, nu, xs, us, dxs, dus, su, nbatch, n_alpha, nT,       \
                                      xs_c, us_c, stream);                                     \
  }                                                                                            \
  int smpc_vector_state_difference_##sfx(int nx, const void* x1, const void* x2, int n,        \
                                         void* out, void* stream) {                            \
    return launch_vector_difference<F>(nx, x1, x2, n, out, stream);                            \
  }

SMPC_CENTROIDAL(f32, float)
SMPC_CENTROIDAL(f64, double)

}  // extern "C"
