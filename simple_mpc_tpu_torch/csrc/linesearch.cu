// K4 after the rollout: the candidates' Lie integrate, their terminal AL
// cost, the merit, the argmin, the pick and the BCL update of the ProxDDP
// iteration; and the state difference that starts it.
//
// candidate_integrate replaces the integrate of
// simple_mpc_tpu/solver/proxddp.py ProxDDPSolver._candidate (458-475): one
// thread per (scenario, step size, knot) lane,
//   xs_c = integrate(xs, dxs)   (free-flyer exp on the base, plain adds on
//                                the joints and velocities)
//   us_c = us + su * dus        (su = u_scale, or 1)
// kernels.py builds this unit (and its wide instance) with -fmad=false: no
// product is fused into an add, so the integrate rounds as the plain torch
// ops it replaces did on the card, and the f32 iterate the line search
// picks stays where the solver's earlier path put it.  What bounds it on
// the card: bytes.  A lane reads the knot's
// state (nx), its tangent (ndx) and, below the last knot, its control and
// step (2 nu), about 182 words at Go2 widths, and writes about 61; at
// B=128, nA=5, T=100 that is ~47 MB in f32, ~14 us at 3.35 TB/s.  The
// lanes' rows are read with a stride of one row per thread; L1 and L2
// serve the neighbours.
//
// line_search_select replaces the rest of the iteration after the
// candidates' stage costs (JAX proxddp.py _term_al_cost 207-212,
// _merit_from 214-217, try_alpha and the argmin 527-544, prim and the BCL
// schedule 546-600): one block per scenario, warp a on step size a:
//   (a) lane 0: the terminal AL cost of xs_c[b,a,T] through term_bundle in
//       primal mode, called with a zero multiplier so that the sink sees
//       the raw terminal equality g and forms g + mu lam itself (never
//       row - mu lam, which cancels in f32 where mu lam dominates); the raw
//       g of every candidate is kept for prim and the lam_term update;
//   (b) lane 1: the x0 gap difference(xs_c[b,a,0], x0) (JAX :538);
//   (c) the warp: sum_t costs and sum gap^2 by a shuffle reduction, then
//       merit = sum costs + term + 0.5/mu sum gap^2 + 0.5/mu sum x0gap^2;
//   (d) NaN -> +inf, then the argmin: the first index wins a tie and an
//       all-inf scenario picks index 0, as torch.argmin and jnp.argmin do;
//   (e) the block: the chosen xs and us copied out, prim = max(|gap|, |g|,
//       max(h, 0), |g_term|) with NaN propagating (torch.amax), the BCL
//       update on thread 0, then the gated multiplier updates.
// It writes new arrays only; the chosen candidate's x0 gap is the next
// iteration's dx0 (the same arguments as JAX :527).  What bounds it on the
// card: the serial FK and centroidal momentum of the nA terminal states,
// one thread each (a few thousand dependent operations), then one block
// reduction per step size and the block's copy of the chosen trajectory;
// the bytes it must move (the nA candidates' costs and gaps, the chosen
// one's states, controls and constraints) are ~1 MB at B=128 in f32.
//
// state_difference: difference(x1, x2) on N lanes, one thread a lane
// (proxddp.py:527, the initial gap before the first iteration).
//
// Layouts (row-major, contiguous):
//   candidate_integrate: xs (B,T+1,nx)  us (B,T,nu)  dxs (B,nA,T+1,ndx)
//     dus (B,nA,T,nu)  su (nu) or null; out xs_c (B,nA,T+1,nx)  us_c (B,nA,T,nu)
//   line_search_select: xs_c, us_c as above; costs (B,nA,T); g (B,nA,T,n_eq);
//     h (B,nA,T,n_in); gap (B,nA,T,ndx); x_ref (B,nx); dcm_ref (B,3); x0 (B,nx);
//     lam_eq (B,T,n_eq); lam_in (B,T,n_in); lam_term (B,n_term_eq); mu, eta,
//     omega, dual (B); alphas (nA); bcl (8 doubles on the host, kernels.py
//     `_bcl_consts`); out xs (B,T+1,nx)  us (B,T,nu)  alpha, merit, prim (B)
//     lam_eq, lam_in, lam_term as the inputs  mu, eta, omega (B)  dx0 (B,ndx)
//   state_difference: x1, x2 (N,nx); out (N,ndx)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <math.h>

#include "stage.cuh"

namespace {

using smpc::Dims;

constexpr int kIntThreads = 128;
constexpr int kMaxAlpha = 8;
constexpr int kSelThreads = 32 * kMaxAlpha;
constexpr int kMaxTermEq = 3;
constexpr unsigned kFull = 0xffffffffu;

// the BCL schedule's constants (SolverSettings), kernels.py `_bcl_consts`
struct Bcl {
  double tol, mu_floor, alpha, mu_factor, eta_shrink, omega_init, omega_shrink, on;
};

// torch.maximum / torch.amax: NaN wins
template <class F>
__device__ __forceinline__ F nan_max(F a, F b) {
  return (a != a || a > b) ? a : b;
}
// torch.clamp(x, min=lo): NaN stays NaN
template <class F>
__device__ __forceinline__ F clamp_lo(F x, F lo) {
  return x < lo ? lo : x;
}

template <class F>
__global__ void __launch_bounds__(kIntThreads)
candidate_integrate_kernel(int nq, int nv, int nu, const F* __restrict__ xs,
                           const F* __restrict__ us, const F* __restrict__ dxs,
                           const F* __restrict__ dus, const F* __restrict__ su, int n_alpha,
                           int nT, size_t n_lanes, F* __restrict__ xs_c, F* __restrict__ us_c) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_lanes) return;
  const int nx = nq + nv, ndx = 2 * nv;
  const size_t t = m % (nT + 1), ba = m / (nT + 1), b = ba / n_alpha;
  const F* X = xs + (b * (nT + 1) + t) * nx;
  const F* DX = dxs + m * ndx;
  F* O = xs_c + m * nx;
  smpc::freeflyer_integrate(X, DX, O);
  for (int i = 7; i < nq; ++i) O[i] = X[i] + DX[i - 1];
  for (int i = 0; i < nv; ++i) O[nq + i] = X[nq + i] + DX[nv + i];
  if (t < (size_t)nT) {
    const F* U = us + (b * nT + t) * nu;
    const F* DU = dus + (ba * nT + t) * nu;
    F* OU = us_c + (ba * nT + t) * nu;
    for (int i = 0; i < nu; ++i) OU[i] = U[i] + (su ? DU[i] * su[i] : DU[i]);
  }
}

template <class F>
__global__ void __launch_bounds__(kIntThreads)
state_difference_kernel(int nq, int nv, const F* __restrict__ x1, const F* __restrict__ x2,
                        size_t n, F* __restrict__ out) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const int nx = nq + nv;
  smpc::state_difference(nq, nv, x1 + m * nx, x2 + m * nx, out + m * 2 * nv);
}

// term_bundle's rows: the cost rows summed as sum w r^2, the AL rows (with
// a zero multiplier: the raw equality) kept
template <class F>
struct TermCostSink {
  int n_cost;
  F wrr;
  F g[kMaxTermEq];
  __device__ void row(int n, F r, F w) {
    if (n < n_cost)
      wrr += w * r * r;
    else
      g[n - n_cost] = r;
  }
};

template <class F>
__device__ __forceinline__ F warp_sum(F v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

template <class F>
__global__ void __launch_bounds__(kSelThreads)
line_search_select_kernel(
    Dims D, const F* __restrict__ C, Bcl P, const F* __restrict__ xs_c,
    const F* __restrict__ us_c, const F* __restrict__ costs, const F* __restrict__ g,
    const F* __restrict__ h, const F* __restrict__ gap, const F* __restrict__ x_ref,
    const F* __restrict__ dcm_ref, const F* __restrict__ x0, const F* __restrict__ lam_eq,
    const F* __restrict__ lam_in, const F* __restrict__ lam_term, const F* __restrict__ mu,
    const F* __restrict__ eta, const F* __restrict__ omega, const F* __restrict__ dual,
    const F* __restrict__ alphas, int n_alpha, int nT, F* __restrict__ xs_o,
    F* __restrict__ us_o, F* __restrict__ alpha_o, F* __restrict__ merit_o,
    F* __restrict__ prim_o, F* __restrict__ lam_eq_o, F* __restrict__ lam_in_o,
    F* __restrict__ lam_term_o, F* __restrict__ mu_o, F* __restrict__ eta_o,
    F* __restrict__ omega_o, F* __restrict__ dx0_o) {
  __shared__ F s_merit[kMaxAlpha];
  __shared__ F s_gterm[kMaxAlpha][kMaxTermEq];
  __shared__ F s_x0g[kMaxAlpha][2 * smpc::kMaxV];
  __shared__ F s_red[kSelThreads / 32];
  __shared__ int s_best, s_ok;

  const int nq = D.nq, nv = D.nv, nu = D.nu, nx = nq + nv, ndx = 2 * nv;
  const int n_eq = D.n_eq, n_in = D.n_in, n_te = D.n_term_eq;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid / 32, lane = tid % 32;
  const F mu_b = mu[b];
  const F half_mu = F(0.5) / mu_b;

  // (a)-(d): warp a on step size a
  if (warp < n_alpha) {
    const size_t ba = b * n_alpha + warp;
    const F* Xa = xs_c + ba * (nT + 1) * nx;
    F term = F(0), x0sq = F(0);
    if (lane == 0) {
      F zero[kMaxTermEq] = {};
      TermCostSink<F> sink{D.n_term_cost, F(0), {}};
      smpc::term_bundle(D, C, Xa + (size_t)nT * nx, x_ref + b * nx, dcm_ref + b * 3, mu_b,
                        zero, sink);
      F rgrg = F(0);
      for (int i = 0; i < n_te; ++i) {
        const F rg = sink.g[i] + mu_b * lam_term[b * n_te + i];
        rgrg += rg * rg;
        s_gterm[warp][i] = sink.g[i];
      }
      term = F(0.5) * sink.wrr + half_mu * rgrg;
    } else if (lane == 1) {
      smpc::state_difference(nq, nv, Xa, x0 + b * nx, s_x0g[warp]);
      for (int i = 0; i < ndx; ++i) x0sq += s_x0g[warp][i] * s_x0g[warp][i];
    }
    F sc = F(0), sg = F(0);
    for (int t = lane; t < nT; t += 32) sc += costs[ba * nT + t];
    const F* G = gap + ba * nT * ndx;
    for (int i = lane; i < nT * ndx; i += 32) sg += G[i] * G[i];
    sc = warp_sum(sc);
    sg = warp_sum(sg);
    x0sq = __shfl_sync(kFull, x0sq, 1);
    if (lane == 0) {
      F m = ((sc + term) + half_mu * sg) + half_mu * x0sq;
      s_merit[warp] = (m != m) ? F(INFINITY) : m;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int a = 1; a < n_alpha; ++a)
      if (s_merit[a] < s_merit[best]) best = a;
    s_best = best;
    alpha_o[b] = alphas[best];
    merit_o[b] = s_merit[best];
  }
  __syncthreads();

  // (e): the pick and prim
  const int best = s_best;
  const size_t bb = b * n_alpha + best;
  const F* Xb = xs_c + bb * (nT + 1) * nx;
  for (int i = tid; i < (nT + 1) * nx; i += nth) xs_o[b * (nT + 1) * nx + i] = Xb[i];
  const F* Ub = us_c + bb * nT * nu;
  for (int i = tid; i < nT * nu; i += nth) us_o[b * nT * nu + i] = Ub[i];
  for (int i = tid; i < ndx; i += nth) dx0_o[b * ndx + i] = s_x0g[best][i];
  const F* Gb = gap + bb * nT * ndx;
  const F* gb = g + bb * nT * n_eq;
  const F* hb = h + bb * nT * n_in;
  F p = F(0);
  for (int i = tid; i < nT * ndx; i += nth) p = nan_max(p, F(fabs(Gb[i])));
  for (int i = tid; i < nT * n_eq; i += nth) p = nan_max(p, F(fabs(gb[i])));
  for (int i = tid; i < nT * n_in; i += nth) p = nan_max(p, clamp_lo(hb[i], F(0)));
  if (tid == 0)
    for (int i = 0; i < n_te; ++i) p = nan_max(p, F(fabs(s_gterm[best][i])));
  for (int o = 16; o > 0; o >>= 1) p = nan_max(p, __shfl_down_sync(kFull, p, o));
  if (lane == 0) s_red[warp] = p;
  __syncthreads();

  // the BCL schedule (LANCELOT), JAX :565-596
  if (tid == 0) {
    F prim = s_red[0];
    for (int w = 1; w < nth / 32; ++w) prim = nan_max(prim, s_red[w]);
    const F tol = F(P.tol);
    F om = omega[b], et = eta[b], mu_n = mu_b, eta_n = et, om_n = om;
    bool ok = true;
    if (P.on != 0.0) {
      if (om < F(0)) om = clamp_lo(dual[b] * F(P.omega_init), tol);
      const bool dual_ok = dual[b] <= om;
      ok = dual_ok && prim <= et;
      const bool fail = dual_ok && prim > et;
      mu_n = fail ? clamp_lo(mu_b * F(P.mu_factor), F(P.mu_floor)) : mu_b;
      eta_n = ok ? clamp_lo(et * F(P.eta_shrink), tol)
                 : (fail ? clamp_lo(F(pow(mu_n, F(P.alpha))), tol) : et);
      om_n = ok ? clamp_lo(om * F(P.omega_shrink), tol) : (fail ? om / F(P.mu_factor) : om);
    }
    prim_o[b] = prim;
    mu_o[b] = mu_n;
    eta_o[b] = eta_n;
    omega_o[b] = om_n;
    s_ok = ok;
  }
  __syncthreads();

  // the gated multiplier updates with the old mu; lam_in projected >= 0
  const bool ok = s_ok != 0;
  const F* le = lam_eq + b * nT * n_eq;
  for (int i = tid; i < nT * n_eq; i += nth)
    lam_eq_o[b * nT * n_eq + i] = ok ? le[i] + gb[i] / mu_b : le[i];
  const F* li = lam_in + b * nT * n_in;
  for (int i = tid; i < nT * n_in; i += nth)
    lam_in_o[b * nT * n_in + i] = ok ? clamp_lo(li[i] + hb[i] / mu_b, F(0)) : li[i];
  for (int i = tid; i < n_te; i += nth)
    lam_term_o[b * n_te + i] =
        ok ? lam_term[b * n_te + i] + s_gterm[best][i] / mu_b : lam_term[b * n_te + i];
}

template <class F>
int launch_integrate(int nq, int nv, int nu, const void* xs, const void* us, const void* dxs,
                     const void* dus, const void* su, int nbatch, int n_alpha, int nT,
                     void* xs_c, void* us_c, void* stream) {
  const size_t n_lanes = (size_t)nbatch * n_alpha * (nT + 1);
  if (n_lanes == 0) return 0;
  const unsigned blocks = (unsigned)((n_lanes + kIntThreads - 1) / kIntThreads);
  candidate_integrate_kernel<F><<<blocks, kIntThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nq, nv, nu, static_cast<const F*>(xs), static_cast<const F*>(us),
      static_cast<const F*>(dxs), static_cast<const F*>(dus), static_cast<const F*>(su),
      n_alpha, nT, n_lanes, static_cast<F*>(xs_c), static_cast<F*>(us_c));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_difference(int nq, int nv, const void* x1, const void* x2, int n, void* out,
                      void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kIntThreads - 1) / kIntThreads);
  state_difference_kernel<F><<<blocks, kIntThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nq, nv, static_cast<const F*>(x1), static_cast<const F*>(x2), (size_t)n,
      static_cast<F*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_select(const int* dims, const void* C, const double* bcl, const void* const* in,
                  int nbatch, int n_alpha, int nT, void* const* out, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (n_alpha < 1 || n_alpha > kMaxAlpha || D.n_term_eq > kMaxTermEq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbatch == 0) return 0;
  Bcl P;
  std::memcpy(&P, bcl, sizeof(Bcl));
  const F* const* I = reinterpret_cast<const F* const*>(in);
  F* const* O = reinterpret_cast<F* const*>(out);
  line_search_select_kernel<F><<<nbatch, kSelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), P, I[0], I[1], I[2], I[3], I[4], I[5], I[6], I[7], I[8],
      I[9], I[10], I[11], I[12], I[13], I[14], I[15], I[16], n_alpha, nT, O[0], O[1], O[2],
      O[3], O[4], O[5], O[6], O[7], O[8], O[9], O[10], O[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// candidate_integrate and state_difference read nq and nv alone and serve
// every model from this unit; linesearch_wide.cu (SMPC_SELECT_ONLY) builds
// line_search_select alone.  line_search_select's 17 inputs and 12 outputs
// come as arrays of device pointers (host memory), in the order of the
// layouts above
#ifdef SMPC_SELECT_ONLY
#define SMPC_LINESEARCH(sfx, F) SMPC_SELECT(sfx, F)
#else
#define SMPC_LINESEARCH(sfx, F)                                                           \
  int smpc_candidate_integrate_##sfx(int nq, int nv, int nu, const void* xs,             \
                                     const void* us, const void* dxs, const void* dus,  \
                                     const void* su, int nbatch, int n_alpha, int nT,   \
                                     void* xs_c, void* us_c, void* stream) {             \
    return launch_integrate<F>(nq, nv, nu, xs, us, dxs, dus, su, nbatch, n_alpha, nT,   \
                               xs_c, us_c, stream);                                     \
  }                                                                                     \
  int smpc_state_difference_##sfx(int nq, int nv, const void* x1, const void* x2, int n, \
                                   void* out, void* stream) {                           \
    return launch_difference<F>(nq, nv, x1, x2, n, out, stream);                        \
  }                                                                                     \
  SMPC_SELECT(sfx, F)
#endif
#define SMPC_SELECT(sfx, F)                                                               \
  int smpc_line_search_select_##sfx(const int* dims, const void* C, const double* bcl,  \
                                    const void* const* in, int nbatch, int n_alpha,     \
                                    int nT, void* const* out, void* stream) {           \
    return launch_select<F>(dims, C, bcl, in, nbatch, n_alpha, nT, out, stream);        \
  }

SMPC_LINESEARCH(f32, float)
SMPC_LINESEARCH(f64, double)

}  // extern "C"
