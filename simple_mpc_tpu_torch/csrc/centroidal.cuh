// The centroidal stage as device functions: the 9-dim state
// x = [com; h_lin; h_ang], the control u = the stacked per-foot forces
// (force size 3) or wrenches (6), the explicit-Euler ODE, the 15 + nu cost
// residuals and the friction pyramid or wrench cone of each active foot.
//
// Counterpart of simple_mpc_tpu_torch/ocp/centroidal.py `stage_eval_soa` /
// `term_residuals` (JAX ocp/centroidal.py:107-170), for ONE lane: one
// (scenario, stage).  The model is linear in u and bilinear in (com, f), so
// the kernels of csrc/centroidal.cu take its Jacobians in closed form.
//
// Namespace smpc_cent.  It also gives what csrc/linesearch.cu's select reads
// of `smpc` (Dims, kMaxV, term_bundle, state_difference; see
// csrc/linesearch_centroidal.cu): Dims carries nq = 9 and nv = 0, so that the
// select's nx = nq + nv is the state's 9 and its ndx (SMPC_LS_NDX) the
// tangent's 9.
#pragma once

#include <math.h>

#include "stage.cuh"

namespace smpc_cent {

constexpr int kMaxK = 8;    // feet
constexpr int kMaxU = 24;   // nu = fs nk
constexpr int kMaxIn = 68;  // cone rows: 4 feet x 17, or 8 feet x 5
constexpr int kMaxV = 5;    // linesearch.cu's x0 gap buffer holds 2 kMaxV >= 9
constexpr int kNx = 9;

// Static sizes and offsets; kernels.py `_CENT_DIMS_FIELDS` lists the same
// ints in the same order.
struct Dims {
  int nq, nv;  // 9 and 0 (see above)
  int nu, nk, fs, n_cone;
  int n_cost, n_eq, n_in, n_term_cost, n_term_eq;
  int o_w, o_wterm, o_g, o_cone, o_scalars;  // scalars: mass, timestep, pyramid epsilon
};

using smpc::freeflyer_integrate;

// one lane's stage parameters, each leaf of the (B, T, ...) layout
template <class F>
struct Params {
  const F* active;      // (nk,)
  const F* pose;        // (nk, 3)
  const F* com_ref;     // (3,)
  const F* u_ref;       // (nu,)
  const F* linmom_ref;  // (3,)
  const F* angmom_ref;  // (3,)
};

// the active forces' sum and their torque about the CoM (plus the active
// wrenches' torques)
template <class F>
SMPC_HD void wrench(const Dims& D, const F* x, const F* u, const F* active, const F* pose,
                    F* fsum, F* tau) {
  for (int i = 0; i < 3; ++i) fsum[i] = tau[i] = F(0);
  for (int k = 0; k < D.nk; ++k) {
    const F a = active[k];
    const F* uk = u + D.fs * k;
    const F f0 = uk[0] * a, f1 = uk[1] * a, f2 = uk[2] * a;
    const F r0 = pose[3 * k] - x[0], r1 = pose[3 * k + 1] - x[1], r2 = pose[3 * k + 2] - x[2];
    fsum[0] += f0;
    fsum[1] += f1;
    fsum[2] += f2;
    tau[0] += r1 * f2 - r2 * f1;
    tau[1] += r2 * f0 - r0 * f2;
    tau[2] += r0 * f1 - r1 * f0;
  }
  if (D.fs == 6)
    for (int k = 0; k < D.nk; ++k)
      for (int i = 0; i < 3; ++i) tau[i] += u[6 * k + 3 + i] * active[k];
}

// the continuous ODE [h / m; sum f + m g; tau]
template <class F>
SMPC_HD void ode(const Dims& D, const F* C, const F* x, const F* u, const F* active,
                 const F* pose, F* out) {
  const F m = C[D.o_scalars];
  const F* g = C + D.o_g;
  F fsum[3], tau[3];
  wrench(D, x, u, active, pose, fsum, tau);
  for (int i = 0; i < 3; ++i) {
    out[i] = x[3 + i] / m;
    out[3 + i] = fsum[i] + m * g[i];
    out[6 + i] = tau[i];
  }
}

// cost residual n (0 <= n < n_cost): [com - com_ref; u - u_ref;
// h_lin - linmom_ref; h_ang - angmom_ref; sum f / m + g; tau]
template <class F>
SMPC_HD F cost_row(const Dims& D, const F* C, const F* x, const F* u, const Params<F>& P,
                   const F* fsum, const F* tau, int n) {
  const int nu = D.nu;
  if (n < 3) return x[n] - P.com_ref[n];
  n -= 3;
  if (n < nu) return u[n] - P.u_ref[n];
  n -= nu;
  if (n < 3) return x[3 + n] - P.linmom_ref[n];
  n -= 3;
  if (n < 3) return x[6 + n] - P.angmom_ref[n];
  n -= 3;
  if (n < 3) return fsum[n] / C[D.o_scalars] + C[D.o_g + n];
  return tau[n - 3];
}

// inequality row j (0 <= j < n_in) of foot k = j / n_cone on the raw control:
// the cone (the pyramid's fz row moved by its epsilon), -1 on a foot out of
// contact or a non-finite row
template <class F>
SMPC_HD F cone_row(const Dims& D, const F* C, const F* u, const F* active, int j) {
  const int k = j / D.n_cone, c = j % D.n_cone, fs = D.fs;
  const F* A = C + D.o_cone + fs * c;
  F r = F(0);
  for (int i = 0; i < fs; ++i) r += A[i] * u[fs * k + i];
  if (fs == 3 && c == 0) r += C[D.o_scalars + 2];
  if (!smpc::finite(r)) r = F(-1);
  return active[k] > F(0.5) ? r : F(-1);
}

// Terminal residuals [h_lin - linmom_ref; h_ang - angmom_ref] as the
// select's sink rows; x_ref is the terminal params packed as
// [com_ref; linmom_ref; angmom_ref] (kernels.py `_centroidal_term_refs`).
// No terminal equality: dcm_ref, mu and lam are unused.
template <class F, class Sink>
SMPC_HD void term_bundle(const Dims& D, const F* C, const F* x, const F* x_ref,
                         const F* dcm_ref, F mu, const F* lam, Sink& sink) {
  const F* w = C + D.o_wterm;
  for (int n = 0; n < 6; ++n) sink.row(n, x[3 + n] - x_ref[3 + n], w[n]);
}

// difference(x1, x2) = x2 - x1 on the vector space (nq + nv = 9 coordinates)
template <class F>
SMPC_HD void state_difference(int nq, int nv, const F* x1, const F* x2, F* out) {
  for (int i = 0; i < nq + nv; ++i) out[i] = x2[i] - x1[i];
}

}  // namespace smpc_cent
