// The Go2 full-dynamics stage as device functions: kernel K7 (world
// inertias, the CRBA mass matrix, the bias torques, the contact Jacobians
// and J-dot v, the Cholesky of M, the multi-rhs solve and the masked
// Delassus solve) and the full-dynamics stage bundle around it.
//
// Counterparts of simple_mpc_tpu_torch/ops/soa_dyn.py (JAX
// ops/soa_dyn.py:79-287) and ocp/fulldynamics.py stage_eval_soa (JAX
// ocp/fulldynamics.py:194-289), for ONE lane and templated on the scalar S
// as stage.cuh is: a real for the primal (candidate evaluation, the
// dynamics kernel), a Dual for one forward tangent (the linearization).
// The semantics are the twin's: the 1e-30 pivot floor of chol_unrolled,
// the Delassus matrix A m_i m_j + delta_ij (1 - m_j + prox) with
// prox = max(1e-9, 50 eps), forces f = -A^-1 rhs * m, Baumgarte rows
// kd (Jc v) + kp fRw^T (fpw - ref_p) (the kp term only when some kp is
// non-zero), non-finite box bounds as -1, the friction-cone epsilon on row
// 0 of each pyramid and -1 rows for inactive contacts.
//
// What differs from the twin in the order of operations (roundoff only):
//   * the composite inertias are summed up the tree by their parameters
//     (mass, first moment, rotational inertia about the origin), not as
//     6x6 matrices through the ancestor mask;
//   * J-dot v is the closed form fRw^T (a_lin + a_ang x fpw), with a the
//     world bias acceleration of the foot's parent body at the origin
//     (sum over its ancestor dofs of (vW_body(d) x Sw_d) v_d).  Along the
//     flow q' = v, dvW/dt = a; d fpw/dt = v_lin + w x fpw; d fRw/dt =
//     [w]x fRw; the two w x (v_lin + w x fpw) terms of d/dt fRw^T(v_lin +
//     w x fpw) cancel.  The twin and the JAX package take a jvp of the
//     contact Jacobian along the flow instead; the derivatives of this
//     closed form are then first-order duals, with no nested tangents.
//
// Point feet (force_size 3) only; kernels.py raises for anything else.
#pragma once

#include "stage.cuh"

namespace smpc {

constexpr int kMaxC = 3 * kMaxK;  // contact rows

// semi-implicit Euler from the acceleration a (nv): v' = v + dt a,
// q' = q (+) dt v'; the gap difference(xn, [q'; v']) goes to sink.gap
template <class S, class Sink>
SMPC_HD void euler_gap(const Dims& D, const real_t<S>* C, const S* q, const S* v,
                       const S* a, const real_t<S>* xn, Sink& sink) {
  const int nq = D.nq, nv = D.nv;
  const real_t<S> dt = C[D.o_scalars + 2];
  S xnext[kMaxQ + kMaxV];
  S dqn[kMaxV];
  for (int i = 0; i < nv; ++i) {
    xnext[nq + i] = v[i] + dt * a[i];
    dqn[i] = dt * xnext[nq + i];
  }
  freeflyer_integrate(q, dqn, xnext);
  for (int i = 7; i < nq; ++i) xnext[i] = q[i] + dqn[i - 1];
  S xnc[kMaxQ + kMaxV];
  for (int i = 0; i < nq + nv; ++i) xnc[i] = S(xn[i]);
  S g[2 * kMaxV];
  state_difference(nq, nv, xnc, xnext, g);
  for (int i = 0; i < 2 * nv; ++i) sink.gap(i, g[i]);
}

// the state cost rows difference(x_ref, x), rows 0..2nv-1 of w
template <class S, class Sink>
SMPC_HD void state_cost_rows(const Dims& D, const S* q, const S* v,
                             const real_t<S>* x_ref, const real_t<S>* w, Sink& sink) {
  const int nq = D.nq, nv = D.nv;
  S xr[kMaxQ + kMaxV], x[kMaxQ + kMaxV], r[2 * kMaxV];
  for (int i = 0; i < nq + nv; ++i) xr[i] = S(x_ref[i]);
  for (int i = 0; i < nq; ++i) x[i] = q[i];
  for (int i = 0; i < nv; ++i) x[nq + i] = v[i];
  state_difference(nq, nv, xr, x, r);
  for (int i = 0; i < 2 * nv; ++i) sink.row(i, r[i], w[i]);
}

// the AL rows of the constraints after the n cost rows
// (ProxDDPSolver._stage_bundle_soa): an equality g gives the row g + mu
// lam_eq with weight 1/mu; an inequality h gives h + mu lam_in with weight
// 1/mu where that is positive, else a zero row (the active set is decided
// on the primal)
template <class S, class Sink>
struct ALRows {
  typedef real_t<S> F;
  Sink& sink;
  F mu, inv_mu;
  const F* LE;
  const F* LI;
  int n, e, h;
  SMPC_HD ALRows(Sink& s, F mu_, const F* le, const F* li, int n0)
      : sink(s), mu(mu_), inv_mu(F(1) / mu_), LE(le), LI(li), n(n0), e(0), h(0) {}
  SMPC_HD void eq(const S& g) {
    sink.eq(e, g);
    sink.row(n, g + mu * LE[e], inv_mu);
    ++e;
    ++n;
  }
  SMPC_HD void ineq(const S& hv) {
    sink.ineq(h, hv);
    const S sh = hv + mu * LI[h];
    const bool act = val(sh) > F(0);
    sink.row(n, act ? sh : S(F(0)), act ? inv_mu : F(0));
    ++h;
    ++n;
  }
  // a box row: non-finite bounds give -1, as jnp.where(isfinite(b), b, -1)
  SMPC_HD void box(const S& b) { ineq(finite(val(b)) ? b : S(F(-1))); }
};

template <class S>
SMPC_HD S dot6(const V6<S>& a, const V6<S>& b) {
  S s = a[0] * b[0];
  for (int i = 1; i < 6; ++i) s += a[i] * b[i];
  return s;
}

// joint carrying dof d: the free-flyer's six, then one dof a joint in tree
// order (kernels.py checks that layout)
SMPC_HD int dof_joint(int d) { return d < 6 ? 0 : d - 5; }

// is joint a an ancestor of joint b, or b itself
SMPC_HD bool joint_ancestor(const Dims& D, int a, int b) {
  while (b > a) b = D.parent[b];
  return b == a;
}

// spatial inertia about the world origin by its parameters: mass m, first
// moment h = m c and rotational inertia I about the origin;
//   I6 = [[m E, -[h]x], [[h]x, I]]
template <class S>
struct Inertia {
  real_t<S> m;
  V3<S> h;
  M3<S> I;
};

template <class S>
SMPC_HD void add_inertia(Inertia<S>& a, const Inertia<S>& b) {
  a.m = a.m + b.m;
  for (int i = 0; i < 3; ++i) a.h[i] = a.h[i] + b.h[i];
  for (int i = 0; i < 9; ++i) a.I.a[i] = a.I.a[i] + b.I.a[i];
}

// I6 x for a motion x = [lin; ang]
template <class S>
SMPC_HD V6<S> inertia_mul(const Inertia<S>& Y, const V6<S>& x) {
  const V3<S> vl = lin3(x), w = ang3(x);
  const V3<S> hw = cross(Y.h, w), hv = cross(Y.h, vl);
  const V3<S> Iw = mv(Y.I, w);
  V6<S> f;
  for (int i = 0; i < 3; ++i) {
    f[i] = Y.m * vl[i] - hw[i];
    f[3 + i] = hv[i] + Iw[i];
  }
  return f;
}

// body j about the origin (soa_dyn.body_inertias_world): c the world body
// CoM, I = R I_com R^T - m [c]x [c]x
template <class S>
SMPC_HD Inertia<S> body_inertia(const Dims& D, const real_t<S>* C, const Kin<S>& k,
                                int j) {
  typedef real_t<S> F;
  Inertia<S> Y;
  const F m = C[D.o_mass + j];
  const V3<S> c = add3(k.op[j], mv(k.oR[j], load3<F>(C + D.o_com + 3 * j)));
  const M3<S> RI = mm(k.oR[j], load33<F>(C + D.o_Icom + 9 * j));
  Y.m = m;
  for (int i = 0; i < 3; ++i) Y.h[i] = m * c[i];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      // (R I_com R^T)(a, b) = sum_i (R I_com)(a, i) R(b, i)
      const S Ic = RI(a, 0) * k.oR[j](b, 0) + RI(a, 1) * k.oR[j](b, 1) +
                   RI(a, 2) * k.oR[j](b, 2);
      // [c]x [c]x = c c^T - |c|^2 E
      const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
      const S cc = (a == b) ? -(c[a1] * c[a1] + c[a2] * c[a2]) : c[a] * c[b];
      Y.I(a, b) = Ic - m * cc;
    }
  return Y;
}

// lower triangle of an n x n symmetric matrix, row-major
SMPC_HD int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// in-place lower Cholesky (ops/soa_dyn.py chol_unrolled): pivots floored
// at 1e-30
template <class S>
SMPC_HD void chol(S* L, int n) {
  typedef real_t<S> F;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) {
      S s = L[tri(i, j)];
      for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
      if (i == j) L[tri(i, i)] = msqrt(clamp_min(s, F(1e-30)));
      else L[tri(i, j)] = s / L[tri(j, j)];
    }
}

// solve (L L^T) x = b in place for column c of X (rows strided by ld)
template <class S>
SMPC_HD void chol_solve(const S* L, int n, S* X, int ld, int c) {
  for (int i = 0; i < n; ++i) {
    S s = X[i * ld + c];
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * X[k * ld + c];
    X[i * ld + c] = s / L[tri(i, i)];
  }
  for (int i = n - 1; i >= 0; --i) {
    S s = X[i * ld + c];
    for (int k = i + 1; k < n; ++k) s = s - L[tri(k, i)] * X[k * ld + c];
    X[i * ld + c] = s / L[tri(i, i)];
  }
}

// What the stage takes from the kinematics of the lane
template <class S>
struct FdKin {
  Kin<S> k;
  V6<S> Sw[kMaxV];
  V6<S> vW[kMaxJ];
  V3<S> fpw[kMaxK];
  M3<S> fRw[kMaxK];
};

template <class S>
SMPC_HD void fd_kinematics(const Dims& D, const real_t<S>* C, const S* q, const S* v,
                           FdKin<S>& K) {
  fk(D, C, q, K.k);
  world_axes(D, C, K.k, K.Sw);
  body_velocities(D, K.Sw, v, K.vW);
  for (int f = 0; f < D.nk; ++f) {
    K.fpw[f] = frame_pos(D, C, K.k, f);
    K.fRw[f] = frame_rot(D, C, K.k, f);
  }
}

// The mass matrix and the bias torques of the lane: each entry of M's lower
// triangle (crba_world) goes to store(i, j, M_ij), j <= i, where the caller
// keeps it (packed by `tri` for the Cholesky, full for the ID's QP); the
// bias torques h (nle_world: the Newton-Euler pass with the fictitious base
// acceleration -g) and the bodies' bias accelerations aW (world, at the
// origin: the derivative of vW along the flow q' = v), which the contact
// rows' J-dot v take.
template <class S, class Store>
SMPC_HD void mass_bias(const Dims& D, const real_t<S>* C, const FdKin<S>& K, const S* v,
                       Store&& store, S* h, V6<S>* aW) {
  typedef real_t<S> F;
  const int nv = D.nv, nj = D.nj;

  // composite inertias: each body's, then summed up the tree (children
  // follow their parents in joint order)
  Inertia<S> IC[kMaxJ];
  for (int j = 0; j < nj; ++j) IC[j] = body_inertia(D, C, K.k, j);

  // bias accelerations and the body forces of the Newton-Euler pass; they
  // use each body's own inertia, so they come before the composites
  V6<S> Fb[kMaxJ];
  {
    V6<S> a0 = scale6(motion_cross(K.vW[0], K.Sw[0]), v[0]);
    for (int d = 1; d < 6; ++d) a0 = add6(a0, scale6(motion_cross(K.vW[0], K.Sw[d]), v[d]));
    aW[0] = a0;
    for (int j = 1; j < nj; ++j) {
      const int d = D.vidx[j];
      aW[j] = add6(aW[D.parent[j]], scale6(motion_cross(K.vW[j], K.Sw[d]), v[d]));
    }
  }
  for (int j = 0; j < nj; ++j) {
    V6<S> at = aW[j];
    for (int i = 0; i < 3; ++i) at[i] = at[i] - C[D.o_grav + i];
    Fb[j] = add6(inertia_mul(IC[j], at),
                 motion_cross_star(K.vW[j], inertia_mul(IC[j], K.vW[j])));
  }
  for (int j = nj - 1; j > 0; --j) {
    add_inertia(IC[D.parent[j]], IC[j]);
    Fb[D.parent[j]] = add6(Fb[D.parent[j]], Fb[j]);
  }

  // M[i][j] = Sw_a . IC Sw_b for the dof b of the deeper joint
  V6<S> Fd[kMaxV];
  for (int d = 0; d < nv; ++d) Fd[d] = inertia_mul(IC[dof_joint(d)], K.Sw[d]);
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) {
      const int ji = dof_joint(i), jj = dof_joint(j);
      S mij;
      if (ji == jj) mij = dot6(K.Sw[i], Fd[j]);
      else if (joint_ancestor(D, jj, ji)) mij = dot6(K.Sw[j], Fd[i]);
      else mij = S(F(0));
      store(i, j, mij);
    }
  for (int d = 0; d < nv; ++d) h[d] = dot6(K.Sw[d], Fb[dof_joint(d)]);
}

// Constrained forward dynamics of the lane (soa_dyn.constrained_fwd_dynamics_soa
// with dim = 3): ddq (nv) and the contact forces f (3 nk, foot-major).
template <class S>
SMPC_HD void constrained_dynamics(const Dims& D, const real_t<S>* C, const FdKin<S>& K,
                                  const S* v, const S* u, const real_t<S>* active,
                                  const real_t<S>* ref_p, S* ddq, S* f) {
  typedef real_t<S> F;
  const int nv = D.nv, nk = D.nk, nc = 3 * nk;
  S Lm[kMaxV * (kMaxV + 1) / 2], hb[kMaxV];
  V6<S> aW[kMaxJ];
  mass_bias(D, C, K, v, [&](int i, int j, const S& m) { Lm[tri(i, j)] = m; }, hb, aW);

  // contact Jacobians (LOCAL linear rows), J-dot v, the Baumgarte rows
  V3<S> J[kMaxK][kMaxV];
  S rhs_c[kMaxC];
  for (int fo = 0; fo < nk; ++fo) {
    const int pj = D.frame_parent[fo];
    const M3<S>& R = K.fRw[fo];
    const V3<S>& p = K.fpw[fo];
    for (int d = 0; d < nv; ++d) {
      if (joint_ancestor(D, dof_joint(d), pj)) {
        J[fo][d] = mtv(R, add3(lin3(K.Sw[d]), cross(ang3(K.Sw[d]), p)));
      } else {
        for (int i = 0; i < 3; ++i) J[fo][d][i] = S(F(0));
      }
    }
    const V3<S> jdv = mtv(R, add3(lin3(aW[pj]), cross(ang3(aW[pj]), p)));
    V3<S> err;
    if (D.kp_on) err = mtv(R, sub3(p, load3<S>(ref_p + 3 * fo)));
    for (int i = 0; i < 3; ++i) {
      S jv = J[fo][0][i] * v[0];
      for (int d = 1; d < nv; ++d) jv += J[fo][d][i] * v[d];
      S corr = C[D.o_kd + 3 * fo + i] * jv;
      if (D.kp_on) corr = corr + C[D.o_kp + 3 * fo + i] * err[i];
      rhs_c[3 * fo + i] = jdv[i] + corr;
    }
  }

  // Cholesky of M and one multi-rhs solve: X = M^-1 [Jc^T | tau - b]
  chol(Lm, nv);
  S X[kMaxV][kMaxC + 1];
  for (int d = 0; d < nv; ++d) {
    for (int r = 0; r < nc; ++r) X[d][r] = J[r / 3][d][r % 3];
    X[d][nc] = (d < 6 ? S(F(0)) : u[d - 6]) - hb[d];
  }
  for (int c = 0; c <= nc; ++c) chol_solve(Lm, nv, &X[0][0], kMaxC + 1, c);

  // masked Delassus matrix with the proximal diagonal, and its solve
  F m_rows[kMaxC];
  for (int r = 0; r < nc; ++r) m_rows[r] = active[r / 3];
  const F prox = C[D.o_prox];
  S La[kMaxC * (kMaxC + 1) / 2];
  S y[kMaxC];
  for (int r = 0; r < nc; ++r) {
    for (int s = 0; s <= r; ++s) {
      S a = J[r / 3][0][r % 3] * X[0][s];
      for (int d = 1; d < nv; ++d) a += J[r / 3][d][r % 3] * X[d][s];
      a = a * m_rows[r] * m_rows[s];
      if (r == s) a = a + (prox + F(1)) - m_rows[s];
      La[tri(r, s)] = a;
    }
    S jf = J[r / 3][0][r % 3] * X[0][nc];
    for (int d = 1; d < nv; ++d) jf += J[r / 3][d][r % 3] * X[d][nc];
    y[r] = m_rows[r] * (jf + rhs_c[r]);
  }
  chol(La, nc);
  chol_solve(La, nc, y, 1, 0);
  for (int r = 0; r < nc; ++r) f[r] = -y[r] * m_rows[r];
  for (int d = 0; d < nv; ++d) {
    S a = X[d][nc];
    for (int r = 0; r < nc; ++r) a += X[d][r] * f[r];
    ddq[d] = a;
  }
}

// The full-dynamics stage bundle (FullDynamicsOCP.stage_eval_soa + the AL
// bundle of ProxDDPSolver._stage_bundle_soa), point feet.  Rows: the state
// (2 nv), control (nu), centroidal momentum (6), foot translations (3 nk)
// and force (3 nk) costs; the landing equalities (with land_cstr); the
// torque box, joint box and friction pyramids.
template <class S, class Sink>
SMPC_HD void fd_stage_bundle(const Dims& D, const real_t<S>* C, const S* q, const S* v,
                             const S* u, const real_t<S>* xn,
                             const StageParams<real_t<S>>& P, real_t<S> mu,
                             const real_t<S>* LE, const real_t<S>* LI, Sink& sink) {
  typedef real_t<S> F;
  const int nv = D.nv, nu = D.nu, nk = D.nk;
  FdKin<S> K;
  fd_kinematics(D, C, q, v, K);
  S ddq[kMaxV], frc[kMaxC];
  constrained_dynamics(D, C, K, v, u, P.active, P.foot_ref_p, ddq, frc);
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
  for (int f = 0; f < nk; ++f)
    for (int i = 0; i < 3; ++i, ++n) sink.row(n, K.fpw[f][i] - P.foot_ref_p[3 * f + i], w[n]);
  for (int f = 0; f < nk; ++f)
    for (int i = 0; i < 3; ++i, ++n)
      sink.row(n, (frc[3 * f + i] - P.f_ref[3 * f + i]) * P.active[f], w[n]);

  // equalities: landing velocity (world-aligned) and height
  ALRows<S, Sink> al(sink, mu, LE, LI, n);
  if (D.land_cstr) {
    for (int f = 0; f < nk; ++f) {
      const V6<S>& vj = K.vW[D.frame_parent[f]];
      const V3<S> lin = add3(lin3(vj), cross(ang3(vj), K.fpw[f]));
      const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
      for (int i = 0; i < 3; ++i) al.eq(on ? lin[i] : S(F(0)));
    }
    for (int f = 0; f < nk; ++f) {
      const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
      al.eq(on ? K.fpw[f][2] - P.foot_ref_p[3 * f + 2] : S(F(0)));
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
    const F* A = C + D.o_cone;  // (5, 3)
    for (int f = 0; f < nk; ++f)
      for (int c = 0; c < 5; ++c) {
        S cr = A[3 * c] * frc[3 * f] + A[3 * c + 1] * frc[3 * f + 1] +
               A[3 * c + 2] * frc[3 * f + 2];
        if (c == 0) cr = cr + C[D.o_scalars + 3];
        al.ineq(P.active[f] > F(0.5) ? cr : S(F(-1)));
      }
  }
}

}  // namespace smpc
