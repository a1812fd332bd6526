// The kinodynamics stage at wide shapes: 6D contacts (force_size 6: a
// wrench per foot) or point feet, up to 32 joints.
//
// stage.cuh compiled again with wider limits, in the namespace smpc_wide
// (the token `smpc` is renamed while it is included), so its types and
// inline templates never meet the Go2 units' copies, whose limits and
// machine code stay as they are.  One translation unit includes this
// header: csrc/linearize_wide.cu.
//
// stage_bundle_wide is the counterpart of simple_mpc_tpu/ocp/
// kinodynamics.py stage_eval_soa (259-355) with the AL bundle of
// ProxDDPSolver._stage_bundle_soa, for either force size; beyond the point
// feet of stage.cuh's stage_bundle it computes
//   * the contact torques in the centroidal wrench (:294-295);
//   * the SE(3) foot-pose residual log6(refR' fR, refR' (fp - ref_p))
//     (:310-315);
//   * the 6D LOCAL frame velocity of each stance foot (:326-328);
//   * the 17-row wrench cone of each stance foot (:343-350).
#pragma once

#define SMPC_MAX_JOINTS 32
#define SMPC_MAX_FORCE_SIZE 6
#define smpc smpc_wide
#include "stage.cuh"
#undef smpc

namespace smpc_wide {

// one lane's stage parameters, each leaf of the (B, T, ...) layout
template <class F>
struct WideParams {
  const F* active;      // (nk,)
  const F* foot_ref_R;  // (nk, 3, 3)
  const F* foot_ref_p;  // (nk, 3)
  const F* x_ref;       // (nx,)
  const F* u_ref;       // (nu,)
  const F* land;        // (nk,)
};

// the Sink interface of stage.cuh's stage_bundle
template <class S, class Sink>
SMPC_HD void stage_bundle_wide(const Dims& D, const real_t<S>* C, const S* q, const S* v,
                               const S* u, const real_t<S>* xn,
                               const WideParams<real_t<S>>& P, real_t<S> mu,
                               const real_t<S>* LE, const real_t<S>* LI, Sink& sink) {
  typedef real_t<S> F;
  const int nq = D.nq, nv = D.nv, nu = D.nu, nk = D.nk, fs = D.fs;
  Kin<S> k;
  fk(D, C, q, k);
  V6<S> Sw[kMaxV];
  world_axes(D, C, k, Sw);
  const V3<S> com = com_world(D, C, k);
  V6<S> vW[kMaxJ];
  body_velocities(D, Sw, v, vW);
  V3<S> fpw[kMaxK];
  M3<S> fRw[kMaxK];
  for (int f = 0; f < nk; ++f) {
    fpw[f] = frame_pos(D, C, k, f);
    fRw[f] = frame_rot(D, C, k, f);
  }
  const V6<S> hg = agx(D, C, k, vW, com);
  const V6<S> bias = bias_hdot(D, C, k, Sw, vW, v, com);

  // external centroidal wrench of the commanded (contact-masked) forces,
  // and with 6D contacts their torques
  const F mass = C[D.o_scalars + 1];
  V6<S> Wr;
  for (int i = 0; i < 3; ++i) {
    S fsum = u[i] * P.active[0];
    for (int f = 1; f < nk; ++f) fsum += u[fs * f + i] * P.active[f];
    Wr[i] = mass * C[D.o_g + i] + fsum;
  }
  for (int f = 0; f < nk; ++f) {
    const F a = P.active[f];
    const V3<S> ff = {{u[fs * f] * a, u[fs * f + 1] * a, u[fs * f + 2] * a}};
    const V3<S> t = cross(sub3(fpw[f], com), ff);
    for (int i = 0; i < 3; ++i) Wr[3 + i] = (f == 0) ? t[i] : Wr[3 + i] + t[i];
  }
  if (fs == 6) {
    for (int i = 0; i < 3; ++i) {
      S tsum = u[3 + i] * P.active[0];
      for (int f = 1; f < nk; ++f) tsum += u[6 * f + 3 + i] * P.active[f];
      Wr[3 + i] = Wr[3 + i] + tsum;
    }
  }

  // KinodynamicsFwdDynamics: base acceleration from wrench consistency
  const S* ddq = u + fs * nk;
  V6<S> vA[kMaxJ];
  {
    S acc[kMaxV];
    for (int d = 0; d < 6; ++d) acc[d] = S(F(0));
    for (int d = 6; d < nv; ++d) acc[d] = ddq[d - 6];
    body_velocities(D, Sw, acc, vA);
  }
  const V6<S> agj = agx(D, C, k, vA, com);
  V6<S> rhs;
  for (int i = 0; i < 6; ++i) rhs[i] = Wr[i] - bias[i] - agj[i];
  const V6<S> a_base = centroidal_solve6(D, C, k, com, rhs);

  // semi-implicit Euler and the gap to the next node
  const F dt = C[D.o_scalars + 2];
  S xnext[kMaxQ + kMaxV];
  S dqn[kMaxV];
  for (int i = 0; i < nv; ++i) {
    const S a = (i < 6) ? a_base[i] : ddq[i - 6];
    xnext[nq + i] = v[i] + dt * a;
    dqn[i] = dt * xnext[nq + i];
  }
  freeflyer_integrate(q, dqn, xnext);
  for (int i = 7; i < nq; ++i) xnext[i] = q[i] + dqn[i - 1];
  {
    S xnc[kMaxQ + kMaxV];
    for (int i = 0; i < nq + nv; ++i) xnc[i] = S(xn[i]);
    S g[2 * kMaxV];
    state_difference(nq, nv, xnc, xnext, g);
    for (int i = 0; i < 2 * nv; ++i) sink.gap(i, g[i]);
  }

  // costs: [state; control; hg; wrench; foot poses (6D) or translations]
  const F* w = C + D.o_w;
  int n = 0;
  {
    S xr[kMaxQ + kMaxV], x[kMaxQ + kMaxV], r[2 * kMaxV];
    for (int i = 0; i < nq + nv; ++i) xr[i] = S(P.x_ref[i]);
    for (int i = 0; i < nq; ++i) x[i] = q[i];
    for (int i = 0; i < nv; ++i) x[nq + i] = v[i];
    state_difference(nq, nv, xr, x, r);
    for (int i = 0; i < 2 * nv; ++i, ++n) sink.row(n, r[i], w[n]);
  }
  for (int i = 0; i < nu; ++i, ++n) sink.row(n, u[i] - P.u_ref[i], w[n]);
  for (int i = 0; i < 6; ++i, ++n) sink.row(n, hg[i], w[n]);
  for (int i = 0; i < 6; ++i, ++n) sink.row(n, Wr[i], w[n]);
  for (int f = 0; f < nk; ++f) {
    const V3<S> dpw = sub3(fpw[f], load3<S>(P.foot_ref_p + 3 * f));
    if (fs == 6) {
      const M3<S> refR = load33<S>(P.foot_ref_R + 9 * f);
      const V3<S> wl = log3(mtm(refR, fRw[f]));
      const V3<S> lin = mv(so3_Vinv(wl), mtv(refR, dpw));
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, lin[i], w[n]);
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, wl[i], w[n]);
    } else {
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, dpw[i], w[n]);
    }
  }

  // equalities: stance-foot zero velocity in the foot frame, 6D with 6D
  // contacts (+ land heights, point feet only)
  const F inv_mu = F(1) / mu;
  int e = 0;
  for (int f = 0; f < nk; ++f) {
    const V6<S>& vj = vW[D.frame_parent[f]];
    const V3<S> lin = add3(lin3(vj), cross(ang3(vj), fpw[f]));
    const V3<S> vl = mtv(fRw[f], lin);
    const V3<S> va = mtv(fRw[f], ang3(vj));
    const F on = P.active[f] > F(0.5) ? F(1) : F(0);
    for (int i = 0; i < (fs == 6 ? 6 : 3); ++i, ++e, ++n) {
      const S g = (i < 3 ? vl[i] : va[i - 3]) * on;
      sink.eq(e, g);
      sink.row(n, g + mu * LE[e], inv_mu);
    }
  }
  if (D.land_cstr && fs == 3) {
    for (int f = 0; f < nk; ++f, ++e, ++n) {
      const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
      const S g = on ? fpw[f][2] - P.foot_ref_p[3 * f + 2] : S(F(0));
      sink.eq(e, g);
      sink.row(n, g + mu * LE[e], inv_mu);
    }
  }

  // inequalities: joint box (+ friction pyramids or wrench cones); the
  // active set is decided on the primal
  int h = 0;
  auto ineq = [&](const S& hv) {
    sink.ineq(h, hv);
    const S sh = hv + mu * LI[h];
    const bool act = val(sh) > F(0);
    sink.row(n, act ? sh : S(F(0)), act ? inv_mu : F(0));
    ++h;
    ++n;
  };
  if (D.kin_limits) {
    for (int i = 0; i < nv - 6; ++i) {
      const S b = q[7 + i] - C[D.o_qmax + i];
      ineq(finite(val(b)) ? b : S(F(-1)));
    }
    for (int i = 0; i < nv - 6; ++i) {
      const S b = C[D.o_qmin + i] - q[7 + i];
      ineq(finite(val(b)) ? b : S(F(-1)));
    }
  }
  if (D.force_cone) {
    const F* A = C + D.o_cone;  // (5, 3) pyramid or (17, 6) wrench cone
    const int n_rows = fs == 6 ? 17 : 5;
    for (int f = 0; f < nk; ++f)
      for (int c = 0; c < n_rows; ++c) {
        S cr = A[fs * c] * u[fs * f];
        for (int j = 1; j < fs; ++j) cr = cr + A[fs * c + j] * u[fs * f + j];
        if (fs == 3 && c == 0) cr = cr + C[D.o_scalars + 3];
        ineq(P.active[f] > F(0.5) ? cr : S(F(-1)));
      }
  }
}

}  // namespace smpc_wide
