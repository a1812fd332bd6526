// K7 at wide shapes: the full-dynamics stage with 6D LOCAL_WORLD_ALIGNED
// contacts (a wrench per foot) or point feet, up to 32 joints.
//
// csrc/fulldyn.cuh compiled in the namespace smpc_wide over
// csrc/stage_wide.cuh (as csrc/sim_wide.cu and id_wide.cu compile it), so
// its rigid-body pass (`mass_bias`), Cholesky (`chol`), integrator
// (`euler_gap`), state cost rows and AL rows serve here unchanged, and the
// Go2 units' machine code does not move.  One translation unit includes
// this header: csrc/fulldyn_wide.cu.
//
// Counterparts of simple_mpc_tpu_torch/ops/soa_dyn.py
// constrained_fwd_dynamics_soa (JAX ops/soa_dyn.py:199-287) with either
// contact dimension, and of ocp/fulldynamics.py stage_eval_soa (JAX
// ocp/fulldynamics.py:194-289) with its 6D branches:
//   * contact rows: force size 3, the LOCAL linear rows fR^T (lin) of each
//     foot; force size 6, the LOCAL_WORLD_ALIGNED rows [lin; ang]
//     (soa_dyn.py:183-193), lin = Sw_lin + Sw_ang x p over the foot's
//     ancestor dofs;
//   * J-dot v in closed form: fR^T (a_lin + a_ang x p) for point feet
//     (fulldyn.cuh), [a_lin + a_ang x p + w x p-dot; a_ang] with 6D
//     contacts (csrc/id.cu `lwa_rows`), a the world bias acceleration of
//     the foot's parent body and w its angular velocity;
//   * the Baumgarte rows kd (J v) + kp err, err = fR^T (p - p_ref) for point
//     feet, [R_ref e_lin; R_ref e_ang] with e = log6(R_ref^T fR,
//     R_ref^T (p - p_ref)) with 6D contacts (:261-266), used when a kp is
//     non-zero;
//   * the masked Delassus solve with prox = max(1e-9, 50 eps), as
//     fulldyn.cuh's;
//   * the foot-pose cost log6 (fulldynamics.py:236-239), the fs-wide force
//     cost, the landing equalities (6 rows a foot and no height row with
//     6D contacts, :253-258) and the 17-row wrench cones (no
//     FRICTION_EPS).
//
// What differs from the twin in the order of operations (roundoff only):
// the twin solves M X = [Jc^T | tau - b] and forms the Delassus matrix as
// Jc X; here Y = L^-1 Jc^T and z = L^-1 (tau - b) (forward substitution
// with the Cholesky factor L of M), the Delassus matrix is Y^T Y, J a_free
// is Y^T z and ddq = L^-T (z + Y f).  The contact rows are recomputed from
// the dof axes where they are needed, not stored: a thread of the
// linearization keeps the factor of M, Y and the Delassus factor, sized by
// this unit's own contact limit kFdWideRows.
#pragma once

#include "stage_wide.cuh"

#define smpc smpc_wide
#include "fulldyn.cuh"
#undef smpc

namespace smpc_wide {

// contact rows of the wide K7: 8 point feet or 4 feet with 6D contacts
// (kernels.py FD_WIDE_ROWS)
constexpr int kFdWideRows = 24;

// one lane's stage parameters, each leaf of the (B, T, ...) layout
template <class F>
struct FdWideParams {
  const F* active;      // (nk,)
  const F* foot_ref_R;  // (nk, 3, 3)
  const F* foot_ref_p;  // (nk, 3)
  const F* x_ref;       // (nx,)
  const F* u_ref;       // (nu,)
  const F* f_ref;       // (nk, fs)
  const F* land;        // (nk,)
};

// the contact rows of foot fo along dof d: rows 0..fs-1 of the result
template <class S>
SMPC_HD V6<S> contact_col(const Dims& D, const FdKin<S>& K, int fo, int d) {
  typedef real_t<S> F;
  V6<S> c;
  if (!joint_ancestor(D, dof_joint(d), D.frame_parent[fo])) {
    for (int i = 0; i < 6; ++i) c[i] = S(F(0));
    return c;
  }
  const V3<S> w = ang3(K.Sw[d]);
  const V3<S> lin = add3(lin3(K.Sw[d]), cross(w, K.fpw[fo]));
  if (D.fs == 6) return cat6(lin, w);
  return cat6(mtv(K.fRw[fo], lin), w);
}

// Constrained forward dynamics of the lane (soa_dyn.constrained_fwd_dynamics_soa
// with dim = fs): ddq (nv) and the contact forces f (fs nk, foot-major).
template <class S>
SMPC_HD void constrained_dynamics_wide(const Dims& D, const real_t<S>* C, const FdKin<S>& K,
                                       const S* v, const S* u, const real_t<S>* active,
                                       const real_t<S>* ref_R, const real_t<S>* ref_p, S* ddq,
                                       S* f) {
  typedef real_t<S> F;
  const int nv = D.nv, nk = D.nk, fs = D.fs, nc = fs * nk;
  S Lm[kMaxV * (kMaxV + 1) / 2], hb[kMaxV];
  V6<S> aW[kMaxJ];
  mass_bias(D, C, K, v, [&](int i, int j, const S& m) { Lm[tri(i, j)] = m; }, hb, aW);
  chol(Lm, nv);

  // Y = Jc^T (then L^-1 Jc^T), and the contact rows' right-hand side
  // J-dot v + kd (J v) (+ kp err)
  S Y[kMaxV][kFdWideRows];
  S rhs_c[kFdWideRows];
  for (int fo = 0; fo < nk; ++fo) {
    const int pj = D.frame_parent[fo];
    const M3<S>& R = K.fRw[fo];
    const V3<S>& p = K.fpw[fo];
    S jv[6];
    for (int d = 0; d < nv; ++d) {
      const V6<S> c = contact_col(D, K, fo, d);
      for (int i = 0; i < fs; ++i) {
        Y[d][fs * fo + i] = c[i];
        jv[i] = (d == 0) ? c[i] * v[0] : jv[i] + c[i] * v[d];
      }
    }
    const V3<S> acc = add3(lin3(aW[pj]), cross(ang3(aW[pj]), p));
    V6<S> jdv, err;
    if (fs == 6) {
      const V3<S> om = ang3(K.vW[pj]);
      const V3<S> pdot = add3(lin3(K.vW[pj]), cross(om, p));
      jdv = cat6(add3(acc, cross(om, pdot)), ang3(aW[pj]));
      if (D.kp_on) {
        const M3<S> Rr = load33<S>(ref_R + 9 * fo);
        const V3<S> wl = log3(mtm(Rr, R));
        const V3<S> el = mv(so3_Vinv(wl), mtv(Rr, sub3(p, load3<S>(ref_p + 3 * fo))));
        err = cat6(mv(Rr, el), mv(Rr, wl));
      }
    } else {
      const V3<S> a3 = mtv(R, acc);
      for (int i = 0; i < 3; ++i) jdv[i] = a3[i];
      if (D.kp_on) {
        const V3<S> e3 = mtv(R, sub3(p, load3<S>(ref_p + 3 * fo)));
        for (int i = 0; i < 3; ++i) err[i] = e3[i];
      }
    }
    for (int i = 0; i < fs; ++i) {
      S corr = C[D.o_kd + fs * fo + i] * jv[i];
      if (D.kp_on) corr = corr + C[D.o_kp + fs * fo + i] * err[i];
      rhs_c[fs * fo + i] = jdv[i] + corr;
    }
  }

  // forward substitution: Y = L^-1 Jc^T, z = L^-1 (tau - b)
  S z[kMaxV];
  for (int i = 0; i < nv; ++i) {
    S s = (i < 6 ? S(F(0)) : u[i - 6]) - hb[i];
    for (int k = 0; k < i; ++k) s = s - Lm[tri(i, k)] * z[k];
    z[i] = s / Lm[tri(i, i)];
  }
  for (int r = 0; r < nc; ++r)
    for (int i = 0; i < nv; ++i) {
      S s = Y[i][r];
      for (int k = 0; k < i; ++k) s = s - Lm[tri(i, k)] * Y[k][r];
      Y[i][r] = s / Lm[tri(i, i)];
    }

  // masked Delassus matrix Y^T Y with the proximal diagonal, and its solve
  F m_rows[kFdWideRows];
  for (int r = 0; r < nc; ++r) m_rows[r] = active[r / fs];
  const F prox = C[D.o_prox];
  S La[kFdWideRows * (kFdWideRows + 1) / 2];
  S y[kFdWideRows];
  for (int r = 0; r < nc; ++r) {
    for (int s = 0; s <= r; ++s) {
      S a = Y[0][r] * Y[0][s];
      for (int d = 1; d < nv; ++d) a += Y[d][r] * Y[d][s];
      a = a * m_rows[r] * m_rows[s];
      if (r == s) a = a + (prox + F(1)) - m_rows[s];
      La[tri(r, s)] = a;
    }
    S jf = Y[0][r] * z[0];
    for (int d = 1; d < nv; ++d) jf += Y[d][r] * z[d];
    y[r] = m_rows[r] * (jf + rhs_c[r]);
  }
  chol(La, nc);
  chol_solve(La, nc, y, 1, 0);
  for (int r = 0; r < nc; ++r) f[r] = -y[r] * m_rows[r];

  // ddq = L^-T (z + Y f)
  for (int d = 0; d < nv; ++d) {
    S a = z[d];
    for (int r = 0; r < nc; ++r) a += Y[d][r] * f[r];
    z[d] = a;
  }
  for (int i = nv - 1; i >= 0; --i) {
    S s = z[i];
    for (int k = i + 1; k < nv; ++k) s = s - Lm[tri(k, i)] * ddq[k];
    ddq[i] = s / Lm[tri(i, i)];
  }
}

// The full-dynamics stage bundle at wide shapes (FullDynamicsOCP.stage_eval_soa
// + the AL bundle of ProxDDPSolver._stage_bundle_soa), either force size.
// Rows: the state (2 nv), control (nu), centroidal momentum (6), foot pose
// (6 nk: log6) or translation (3 nk) and force (fs nk) costs; the landing
// equalities (with land_cstr: 6 a foot, or 3 a foot and the heights); the
// torque box, joint box and wrench cones (17 a foot) or friction pyramids.
template <class S, class Sink>
SMPC_HD void fd_stage_bundle_wide(const Dims& D, const real_t<S>* C, const S* q,
                                  const S* v, const S* u, const real_t<S>* xn,
                                  const FdWideParams<real_t<S>>& P, real_t<S> mu,
                                  const real_t<S>* LE, const real_t<S>* LI, Sink& sink) {
  typedef real_t<S> F;
  const int nv = D.nv, nu = D.nu, nk = D.nk, fs = D.fs;
  FdKin<S> K;
  fd_kinematics(D, C, q, v, K);
  S ddq[kMaxV], frc[kFdWideRows];
  constrained_dynamics_wide(D, C, K, v, u, P.active, P.foot_ref_R, P.foot_ref_p, ddq, frc);
  euler_gap(D, C, q, v, ddq, xn, sink);

  const F* w = C + D.o_w;
  state_cost_rows(D, q, v, P.x_ref, w, sink);
  int n = 2 * nv;
  for (int i = 0; i < nu; ++i, ++n) sink.row(n, u[i] - P.u_ref[i], w[n]);
  {
    const V3<S> com = com_world(D, C, K.k);
    const V6<S> hg = agx(D, C, K.k, K.vW, com);
    for (int i = 0; i < 6; ++i, ++n) sink.row(n, hg[i], w[n]);
  }
  for (int f = 0; f < nk; ++f) {
    const V3<S> dpw = sub3(K.fpw[f], load3<S>(P.foot_ref_p + 3 * f));
    if (fs == 6) {
      const M3<S> refR = load33<S>(P.foot_ref_R + 9 * f);
      const V3<S> wl = log3(mtm(refR, K.fRw[f]));
      const V3<S> lin = mv(so3_Vinv(wl), mtv(refR, dpw));
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, lin[i], w[n]);
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, wl[i], w[n]);
    } else {
      for (int i = 0; i < 3; ++i, ++n) sink.row(n, dpw[i], w[n]);
    }
  }
  for (int f = 0; f < nk; ++f)
    for (int i = 0; i < fs; ++i, ++n)
      sink.row(n, (frc[fs * f + i] - P.f_ref[fs * f + i]) * P.active[f], w[n]);

  // equalities: the landing velocity (world-aligned; [lin; ang] with 6D
  // contacts) and, for point feet, the height
  ALRows<S, Sink> al(sink, mu, LE, LI, n);
  if (D.land_cstr) {
    for (int f = 0; f < nk; ++f) {
      const V6<S>& vj = K.vW[D.frame_parent[f]];
      const V3<S> lin = add3(lin3(vj), cross(ang3(vj), K.fpw[f]));
      const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
      for (int i = 0; i < fs; ++i) al.eq(on ? (i < 3 ? lin[i] : vj[i]) : S(F(0)));
    }
    if (fs == 3) {
      for (int f = 0; f < nk; ++f) {
        const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
        al.eq(on ? K.fpw[f][2] - P.foot_ref_p[3 * f + 2] : S(F(0)));
      }
    }
  }

  // inequalities: torque box, joint box, cones on the implicit forces
  if (D.torque_limits) {
    for (int i = 0; i < nu; ++i) al.box(u[i] - C[D.o_umax + i]);
    for (int i = 0; i < nu; ++i) al.box(C[D.o_umin + i] - u[i]);
  }
  if (D.kin_limits) {
    for (int i = 0; i < nv - 6; ++i) al.box(q[7 + i] - C[D.o_qmax + i]);
    for (int i = 0; i < nv - 6; ++i) al.box(C[D.o_qmin + i] - q[7 + i]);
  }
  if (D.force_cone) {
    const F* A = C + D.o_cone;  // (5, 3) pyramid or (17, 6) wrench cone
    const int n_rows = fs == 6 ? 17 : 5;
    for (int f = 0; f < nk; ++f)
      for (int c = 0; c < n_rows; ++c) {
        S cr = A[fs * c] * frc[fs * f];
        for (int j = 1; j < fs; ++j) cr = cr + A[fs * c + j] * frc[fs * f + j];
        if (fs == 3 && c == 0) cr = cr + C[D.o_scalars + 3];
        al.ineq(P.active[f] > F(0.5) ? cr : S(F(-1)));
      }
  }
}

}  // namespace smpc_wide
