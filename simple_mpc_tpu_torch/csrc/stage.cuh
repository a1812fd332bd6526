// The Go2 kinodynamics stage as device functions: rigid-body and Lie
// algebra, forward kinematics, centroidal dynamics, the stage and terminal
// residual bundles and the tick's measured-state kinematics.
//
// Counterparts of simple_mpc_tpu_torch/ops/soa.py (JAX ops/soa.py:42-614)
// and ocp/kinodynamics.py stage_eval_soa / term_residuals (JAX
// ocp/kinodynamics.py:259-355, 471-480, 514-522), written for ONE lane: one
// thread evaluates one (scenario, stage).  Every function is a template on
// the scalar S:
//   * float or double: the primal (candidate evaluation, tick kinematics);
//   * Dual<float> or Dual<double>: a value and one forward tangent, so one
//     thread evaluates the bundle along one basis direction (the
//     linearization kernels).
// Taylor-guarded branches (exp3, log3, the SO(3) Jacobians) branch on the
// primal value and, in the small branch, evaluate the series in theta^2
// only: the tangent directions enter at delta = 0, so exp3 always runs at
// theta = 0, where sqrt(theta^2) or acos near 1 would give an infinite dual
// derivative.
//
// The FK is a serial loop over joints in tree order (parents before
// children), in place of the pointer doubling of the SoA twin.
//
// Model and OCP constants live in one packed buffer (kernels.py
// `_stage_consts`), indexed by the offsets of `Dims`, which also carries the
// static sizes, the joint tree and the selected frames' parent joints.
//
// Everything is __host__ __device__, so the arithmetic can be compiled as
// plain C++ on a machine without a card.
#pragma once

#include <float.h>
#include <math.h>

#if defined(__CUDACC__)
#define SMPC_HD __host__ __device__ __forceinline__
#else
#define SMPC_HD inline
#endif

namespace smpc {

// The limits below are the Go2 units' own; csrc/stage_wide.cuh compiles
// this header again at wider ones, in a namespace of its own.
#ifndef SMPC_MAX_JOINTS
#define SMPC_MAX_JOINTS 16
#endif
#ifndef SMPC_MAX_FORCE_SIZE
#define SMPC_MAX_FORCE_SIZE 3
#endif

constexpr int kMaxJ = SMPC_MAX_JOINTS;  // joints: a free-flyer root and 1-dof joints
constexpr int kMaxV = kMaxJ + 5;
constexpr int kMaxQ = kMaxJ + 6;
constexpr int kMaxK = 8;  // contacts
constexpr int kMaxU = SMPC_MAX_FORCE_SIZE * kMaxK + kMaxV - 6;

// Static sizes and offsets; kernels.py `_DIMS_FIELDS` lists the same ints in
// the same order.
struct Dims {
  int nj, nq, nv, nu, nk, fs;
  int n_cost, n_eq, n_in, n_term_cost, n_term_eq;
  int kin_limits, force_cone, land_cstr;
  int parent[kMaxJ];
  int qidx[kMaxJ];
  int vidx[kMaxJ];
  int frame_parent[2 * kMaxK + 1];  // feet, then foot refs, then the base
  int o_jR, o_jp, o_axis, o_prism, o_mass, o_com, o_Iloc;
  int o_fR, o_fp;  // selected frames, in frame_parent's order
  int o_w, o_wterm, o_g, o_qmin, o_qmax, o_cone;
  int o_scalars;  // total mass, OCP mass, timestep, friction-cone epsilon
  // full dynamics (fulldyn.cuh): torque box, Baumgarte rows (kp used only
  // when kp_on, as the JAX package skips the position term for zero gains),
  // rotational inertias about the body CoMs, the model's gravity, the
  // proximal term of the Delassus diagonal
  int torque_limits, kp_on;
  int o_umin, o_umax, o_kp, o_kd, o_Icom, o_grav, o_prox;
};

// ---------------------------------------------------------------------------
// Scalars: plain reals and forward-mode duals
// ---------------------------------------------------------------------------

template <class F>
struct Dual {
  F v, d;
  SMPC_HD Dual() {}
  SMPC_HD Dual(F a) : v(a), d(F(0)) {}
  SMPC_HD Dual(F a, F b) : v(a), d(b) {}

  friend SMPC_HD Dual operator-(const Dual& a) { return Dual(-a.v, -a.d); }
  friend SMPC_HD Dual operator+(const Dual& a, const Dual& b) {
    return Dual(a.v + b.v, a.d + b.d);
  }
  friend SMPC_HD Dual operator+(const Dual& a, F b) { return Dual(a.v + b, a.d); }
  friend SMPC_HD Dual operator+(F a, const Dual& b) { return Dual(a + b.v, b.d); }
  friend SMPC_HD Dual operator-(const Dual& a, const Dual& b) {
    return Dual(a.v - b.v, a.d - b.d);
  }
  friend SMPC_HD Dual operator-(const Dual& a, F b) { return Dual(a.v - b, a.d); }
  friend SMPC_HD Dual operator-(F a, const Dual& b) { return Dual(a - b.v, -b.d); }
  friend SMPC_HD Dual operator*(const Dual& a, const Dual& b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
  friend SMPC_HD Dual operator*(const Dual& a, F b) { return Dual(a.v * b, a.d * b); }
  friend SMPC_HD Dual operator*(F a, const Dual& b) { return Dual(a * b.v, a * b.d); }
  friend SMPC_HD Dual operator/(const Dual& a, const Dual& b) {
    const F q = a.v / b.v;
    return Dual(q, (a.d - q * b.d) / b.v);
  }
  friend SMPC_HD Dual operator/(const Dual& a, F b) { return Dual(a.v / b, a.d / b); }
  friend SMPC_HD Dual operator/(F a, const Dual& b) {
    const F q = a / b.v;
    return Dual(q, -q * b.d / b.v);
  }
  SMPC_HD Dual& operator+=(const Dual& b) { v += b.v; d += b.d; return *this; }
  SMPC_HD Dual& operator-=(const Dual& b) { v -= b.v; d -= b.d; return *this; }
};

template <class S>
struct Real { typedef S type; };
template <class F>
struct Real<Dual<F>> { typedef F type; };
template <class S>
using real_t = typename Real<S>::type;

// result type of a product of a constant (plain) and a scalar (either)
template <class A, class B>
struct Mul { typedef A type; };
template <class F>
struct Mul<F, Dual<F>> { typedef Dual<F> type; };
template <class A, class B>
using mul_t = typename Mul<A, B>::type;

SMPC_HD float val(float x) { return x; }
SMPC_HD double val(double x) { return x; }
template <class F>
SMPC_HD F val(const Dual<F>& x) { return x.v; }

SMPC_HD float msqrt(float x) { return sqrtf(x); }
SMPC_HD double msqrt(double x) { return sqrt(x); }
SMPC_HD float msin(float x) { return sinf(x); }
SMPC_HD double msin(double x) { return sin(x); }
SMPC_HD float mcos(float x) { return cosf(x); }
SMPC_HD double mcos(double x) { return cos(x); }
SMPC_HD float macos(float x) { return acosf(x); }
SMPC_HD double macos(double x) { return acos(x); }
SMPC_HD float masin(float x) { return asinf(x); }
SMPC_HD double masin(double x) { return asin(x); }
SMPC_HD float mpow(float x, float y) { return powf(x, y); }
SMPC_HD double mpow(double x, double y) { return pow(x, y); }

template <class F>
SMPC_HD Dual<F> msqrt(const Dual<F>& x) {
  const F s = msqrt(x.v);
  return Dual<F>(s, x.d / (F(2) * s));
}
template <class F>
SMPC_HD Dual<F> msin(const Dual<F>& x) {
  return Dual<F>(msin(x.v), mcos(x.v) * x.d);
}
template <class F>
SMPC_HD Dual<F> mcos(const Dual<F>& x) {
  return Dual<F>(mcos(x.v), -msin(x.v) * x.d);
}
template <class F>
SMPC_HD Dual<F> macos(const Dual<F>& x) {
  return Dual<F>(macos(x.v), -x.d / msqrt(F(1) - x.v * x.v));
}
template <class F>
SMPC_HD Dual<F> masin(const Dual<F>& x) {
  return Dual<F>(masin(x.v), x.d / msqrt(F(1) - x.v * x.v));
}

// torch.clamp: the tangent passes where the primal is inside the bounds
template <class S>
SMPC_HD S clamp_min(const S& x, real_t<S> lo) {
  return val(x) < lo ? S(lo) : x;
}
template <class S>
SMPC_HD S clamp_max(const S& x, real_t<S> hi) {
  return val(x) > hi ? S(hi) : x;
}

SMPC_HD bool finite(float x) { return fabsf(x) <= FLT_MAX; }
SMPC_HD bool finite(double x) { return fabs(x) <= DBL_MAX; }

// theta^2 below which the Taylor series are used: sqrt(eps(dtype))
// (ops/soa.py _small2)
template <class F>
SMPC_HD F small2();
template <>
SMPC_HD float small2<float>() { return 3.4526698300124393e-04f; }
template <>
SMPC_HD double small2<double>() { return 1.4901161193847656e-08; }

// ---------------------------------------------------------------------------
// Small vectors and matrices (row-major 3x3)
// ---------------------------------------------------------------------------

template <class S>
struct V3 {
  S x[3];
  SMPC_HD S& operator[](int i) { return x[i]; }
  SMPC_HD const S& operator[](int i) const { return x[i]; }
};
template <class S>
struct V6 {
  S x[6];
  SMPC_HD S& operator[](int i) { return x[i]; }
  SMPC_HD const S& operator[](int i) const { return x[i]; }
};
template <class S>
struct M3 {
  S a[9];
  SMPC_HD S& operator()(int i, int j) { return a[3 * i + j]; }
  SMPC_HD const S& operator()(int i, int j) const { return a[3 * i + j]; }
};

template <class S, class F>
SMPC_HD V3<S> load3(const F* p) {
  V3<S> v;
  for (int i = 0; i < 3; ++i) v[i] = S(p[i]);
  return v;
}
template <class S, class F>
SMPC_HD M3<S> load33(const F* p) {
  M3<S> m;
  for (int i = 0; i < 9; ++i) m.a[i] = S(p[i]);
  return m;
}
template <class S>
SMPC_HD V6<S> zero6() {
  V6<S> v;
  for (int i = 0; i < 6; ++i) v[i] = S(real_t<S>(0));
  return v;
}
template <class S>
SMPC_HD V6<S> cat6(const V3<S>& a, const V3<S>& b) {
  V6<S> v;
  for (int i = 0; i < 3; ++i) { v[i] = a[i]; v[3 + i] = b[i]; }
  return v;
}
template <class S>
SMPC_HD V3<S> lin3(const V6<S>& v) { V3<S> r = {{v[0], v[1], v[2]}}; return r; }
template <class S>
SMPC_HD V3<S> ang3(const V6<S>& v) { V3<S> r = {{v[3], v[4], v[5]}}; return r; }

template <class S>
SMPC_HD V3<S> add3(const V3<S>& a, const V3<S>& b) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = a[i] + b[i];
  return r;
}
template <class S>
SMPC_HD V3<S> sub3(const V3<S>& a, const V3<S>& b) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = a[i] - b[i];
  return r;
}
template <class S>
SMPC_HD V6<S> add6(const V6<S>& a, const V6<S>& b) {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r[i] = a[i] + b[i];
  return r;
}

template <class A, class B>
SMPC_HD M3<mul_t<A, B>> mm(const M3<A>& X, const M3<B>& Y) {
  M3<mul_t<A, B>> Z;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Z(i, j) = X(i, 0) * Y(0, j) + X(i, 1) * Y(1, j) + X(i, 2) * Y(2, j);
  return Z;
}
template <class S>
SMPC_HD M3<S> mtm(const M3<S>& X, const M3<S>& Y) {  // X^T Y
  M3<S> Z;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Z(i, j) = X(0, i) * Y(0, j) + X(1, i) * Y(1, j) + X(2, i) * Y(2, j);
  return Z;
}
template <class A, class B>
SMPC_HD V3<mul_t<A, B>> mv(const M3<A>& X, const V3<B>& y) {
  V3<mul_t<A, B>> z;
  for (int i = 0; i < 3; ++i)
    z[i] = X(i, 0) * y[0] + X(i, 1) * y[1] + X(i, 2) * y[2];
  return z;
}
template <class S>
SMPC_HD V3<S> mtv(const M3<S>& X, const V3<S>& y) {  // X^T y
  V3<S> z;
  for (int i = 0; i < 3; ++i)
    z[i] = X(0, i) * y[0] + X(1, i) * y[1] + X(2, i) * y[2];
  return z;
}
template <class S>
SMPC_HD V3<S> cross(const V3<S>& a, const V3<S>& b) {
  V3<S> c = {{a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
              a[0] * b[1] - a[1] * b[0]}};
  return c;
}

// ---------------------------------------------------------------------------
// Quaternions (xyzw)
// ---------------------------------------------------------------------------

template <class S>
SMPC_HD M3<S> quat_to_rotmat(const S& x, const S& y, const S& z, const S& w) {
  typedef real_t<S> F;
  const S xx = x * x, yy = y * y, zz = z * z;
  const S xy = x * y, xz = x * z, yz = y * z;
  const S wx = w * x, wy = w * y, wz = w * z;
  M3<S> R;
  R(0, 0) = F(1) - F(2) * (yy + zz);
  R(0, 1) = F(2) * (xy - wz);
  R(0, 2) = F(2) * (xz + wy);
  R(1, 0) = F(2) * (xy + wz);
  R(1, 1) = F(1) - F(2) * (xx + zz);
  R(1, 2) = F(2) * (yz - wx);
  R(2, 0) = F(2) * (xz - wy);
  R(2, 1) = F(2) * (yz + wx);
  R(2, 2) = F(1) - F(2) * (xx + yy);
  return R;
}

// branch-free Shepperd of ops/soa.py: the candidate of the largest pivot
// (first on ties, as argmax), sign so that w >= 0, normalized; q is xyzw
template <class S>
SMPC_HD void rotmat_to_quat(const M3<S>& M, S* q) {
  typedef real_t<S> F;
  const S m00 = M(0, 0), m01 = M(0, 1), m02 = M(0, 2);
  const S m10 = M(1, 0), m11 = M(1, 1), m12 = M(1, 2);
  const S m20 = M(2, 0), m21 = M(2, 1), m22 = M(2, 2);
  const S tr = m00 + m11 + m22;
  const S piv[4] = {F(1) + tr, F(1) + m00 - m11 - m22, F(1) - m00 + m11 - m22,
                    F(1) - m00 - m11 + m22};
  int k = 0;
  for (int i = 1; i < 4; ++i)
    if (val(piv[i]) > val(piv[k])) k = i;
  S c[4];  // wxyz
  if (k == 0) {
    c[0] = piv[0]; c[1] = m21 - m12; c[2] = m02 - m20; c[3] = m10 - m01;
  } else if (k == 1) {
    c[0] = m21 - m12; c[1] = piv[1]; c[2] = m01 + m10; c[3] = m02 + m20;
  } else if (k == 2) {
    c[0] = m02 - m20; c[1] = m01 + m10; c[2] = piv[2]; c[3] = m12 + m21;
  } else {
    c[0] = m10 - m01; c[1] = m02 + m20; c[2] = m12 + m21; c[3] = piv[3];
  }
  const F w = val(c[0]);
  const F sgn = (w < F(0)) ? F(-1) : F(1);
  S u[4] = {c[1] * sgn, c[2] * sgn, c[3] * sgn, c[0] * sgn};
  const S n = msqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + u[3] * u[3]);
  for (int i = 0; i < 4; ++i) q[i] = u[i] / n;
}

// ---------------------------------------------------------------------------
// SO(3) / SE(3), Taylor-guarded on the primal
// ---------------------------------------------------------------------------

template <class S>
SMPC_HD M3<S> skew_outer(const S& diag, const S& skew, const S& outer, const V3<S>& w) {
  M3<S> R;
  R(0, 0) = diag + outer * w[0] * w[0];
  R(0, 1) = -skew * w[2] + outer * w[0] * w[1];
  R(0, 2) = skew * w[1] + outer * w[0] * w[2];
  R(1, 0) = skew * w[2] + outer * w[0] * w[1];
  R(1, 1) = diag + outer * w[1] * w[1];
  R(1, 2) = -skew * w[0] + outer * w[1] * w[2];
  R(2, 0) = -skew * w[1] + outer * w[0] * w[2];
  R(2, 1) = skew * w[0] + outer * w[1] * w[2];
  R(2, 2) = diag + outer * w[2] * w[2];
  return R;
}

template <class S>
SMPC_HD M3<S> exp3(const V3<S>& w) {
  typedef real_t<S> F;
  const S theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S s, c;
  if (val(theta2) < small2<F>()) {
    s = F(1) - theta2 / F(6);
    c = F(0.5) - theta2 / F(24);
  } else {
    const S theta = msqrt(theta2);
    s = msin(theta) / theta;
    c = (F(1) - mcos(theta)) / theta2;
  }
  const S a = F(1) - c * theta2;
  return skew_outer(a, s, c, w);
}

template <class S>
SMPC_HD V3<S> log3(const M3<S>& R) {
  typedef real_t<S> F;
  const S tr = R(0, 0) + R(1, 1) + R(2, 2);
  const S cos_t = clamp_max(clamp_min((tr - F(1)) * F(0.5), F(-1)), F(1));
  const V3<S> a = {{R(2, 1) - R(1, 2), R(0, 2) - R(2, 0), R(1, 0) - R(0, 1)}};
  const bool small = val(cos_t) > F(1) - F(0.5) * small2<F>();
  const bool near_pi = val(cos_t) < F(-1) + F(2e-5);
  V3<S> w;
  if (near_pi) {
    const S a2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
    const S sin_p = msqrt(clamp_min(a2 * F(0.25), F(0)) + F(1e-30));
    const S theta_p = F(3.14159265358979323846) -
                      masin(clamp_max(clamp_min(sin_p, F(0)), F(1)));
    const S one_m_cos = F(1) - cos_t;
    for (int i = 0; i < 3; ++i) {
      const S ax = msqrt(clamp_min((R(i, i) - cos_t) / one_m_cos, F(0)));
      const F sg = val(a[i]) >= F(0) ? F(1) : F(-1);
      w[i] = theta_p * ax * sg;
    }
  } else if (small) {
    const S t2 = (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]) * F(0.25);
    const S f = F(1) + t2 / F(6) + F(7) * t2 * t2 / F(360);
    for (int i = 0; i < 3; ++i) w[i] = F(0.5) * a[i] * f;
  } else {
    const S theta = macos(cos_t);
    const S f = theta / (F(2) * msin(theta));
    for (int i = 0; i < 3; ++i) w[i] = f * a[i];
  }
  return w;
}

// left Jacobian V of SO(3)
template <class S>
SMPC_HD M3<S> so3_V(const V3<S>& w) {
  typedef real_t<S> F;
  const S theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S b, c;
  if (val(theta2) < small2<F>()) {
    b = F(0.5) - theta2 / F(24);
    c = F(1) / F(6) - theta2 / F(120);
  } else {
    const S ts = msqrt(theta2);
    b = (F(1) - mcos(ts)) / theta2;
    c = (ts - msin(ts)) / (theta2 * ts);
  }
  return skew_outer(F(1) - c * theta2, b, c, w);
}

// its inverse
template <class S>
SMPC_HD M3<S> so3_Vinv(const V3<S>& w) {
  typedef real_t<S> F;
  const S theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S e;
  if (val(theta2) < small2<F>()) {
    e = F(1) / F(12) + theta2 / F(720);
  } else {
    const S ts = msqrt(theta2);
    const S denom = F(2) * ts * msin(ts);
    e = F(1) / theta2 - (F(1) + mcos(ts)) / denom;
  }
  return skew_outer(F(1) - e * theta2, S(F(-0.5)), e, w);
}

template <class S>
SMPC_HD void freeflyer_integrate(const S* pq, const S* v, S* out) {
  const M3<S> R = quat_to_rotmat(pq[3], pq[4], pq[5], pq[6]);
  const V3<S> lin = {{v[0], v[1], v[2]}};
  const V3<S> ang = {{v[3], v[4], v[5]}};
  const M3<S> dR = exp3(ang);
  const V3<S> dp = mv(so3_V(ang), lin);
  rotmat_to_quat(mm(R, dR), out + 3);
  const V3<S> Rdp = mv(R, dp);
  for (int i = 0; i < 3; ++i) out[i] = pq[i] + Rdp[i];
}

// log6(M1^-1 M2), [lin; ang]
template <class S>
SMPC_HD void freeflyer_difference(const S* pq1, const S* pq2, S* out) {
  const M3<S> R1 = quat_to_rotmat(pq1[3], pq1[4], pq1[5], pq1[6]);
  const M3<S> R2 = quat_to_rotmat(pq2[3], pq2[4], pq2[5], pq2[6]);
  const M3<S> dR = mtm(R1, R2);
  const V3<S> dpw = {{pq2[0] - pq1[0], pq2[1] - pq1[1], pq2[2] - pq1[2]}};
  const V3<S> dp = mtv(R1, dpw);
  const V3<S> w = log3(dR);
  const V3<S> lin = mv(so3_Vinv(w), dp);
  for (int i = 0; i < 3; ++i) { out[i] = lin[i]; out[3 + i] = w[i]; }
}

// [difference(q1, q2); v2 - v1] over a free-flyer + 1-dof layout
template <class S>
SMPC_HD void state_difference(int nq, int nv, const S* x1, const S* x2, S* out) {
  freeflyer_difference(x1, x2, out);
  for (int i = 7; i < nq; ++i) out[i - 1] = x2[i] - x1[i];
  for (int i = 0; i < nv; ++i) out[nv + i] = x2[nq + i] - x1[nq + i];
}

// ---------------------------------------------------------------------------
// Spatial algebra ([lin; ang])
// ---------------------------------------------------------------------------

template <class S>
SMPC_HD V6<S> motion_action_inv(const M3<S>& R, const V3<S>& p, const V6<S>& v) {
  const V3<S> ang = ang3(v);
  return cat6(mtv(R, sub3(lin3(v), cross(p, ang))), mtv(R, ang));
}
template <class S>
SMPC_HD V6<S> force_action(const M3<S>& R, const V3<S>& p, const V6<S>& f) {
  const V3<S> la = mv(R, lin3(f));
  return cat6(la, add3(mv(R, ang3(f)), cross(p, la)));
}
template <class S>
SMPC_HD V6<S> motion_cross(const V6<S>& v, const V6<S>& m) {
  const V3<S> vl = lin3(v), va = ang3(v), ml = lin3(m), ma = ang3(m);
  return cat6(add3(cross(va, ml), cross(vl, ma)), cross(va, ma));
}
template <class S>
SMPC_HD V6<S> motion_cross_star(const V6<S>& v, const V6<S>& f) {
  const V3<S> vl = lin3(v), va = ang3(v), fl = lin3(f), fa = ang3(f);
  return cat6(cross(va, fl), add3(cross(va, fa), cross(vl, fl)));
}
template <class S>
SMPC_HD V6<S> scale6(const V6<S>& v, const S& s) {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r[i] = v[i] * s;
  return r;
}
// X*_{O<-j} (I_loc (X_{j<-O} v)), I_loc the 6x6 local spatial inertia
template <class S>
SMPC_HD V6<S> inertia_apply(const real_t<S>* I, const M3<S>& R, const V3<S>& p,
                            const V6<S>& v) {
  const V6<S> vl = motion_action_inv(R, p, v);
  V6<S> h;
  for (int a = 0; a < 6; ++a) {
    S s = I[6 * a] * vl[0];
    for (int b = 1; b < 6; ++b) s += I[6 * a + b] * vl[b];
    h[a] = s;
  }
  return force_action(R, p, h);
}
template <class S>
SMPC_HD V6<S> shift_to_com(const V6<S>& h, const V3<S>& com) {
  const V3<S> lin = lin3(h);
  return cat6(lin, sub3(ang3(h), cross(com, lin)));
}

template <class S>
SMPC_HD V3<S> solve_spd3(const M3<S>& A, const V3<S>& b) {
  typedef real_t<S> F;
  const F tiny = F(1e-30);
  const S a00 = msqrt(clamp_min(A(0, 0), tiny));
  const S l10 = A(1, 0) / a00;
  const S l20 = A(2, 0) / a00;
  const S a11 = msqrt(clamp_min(A(1, 1) - l10 * l10, tiny));
  const S l21 = (A(2, 1) - l20 * l10) / a11;
  const S a22 = msqrt(clamp_min(A(2, 2) - l20 * l20 - l21 * l21, tiny));
  const S y0 = b[0] / a00;
  const S y1 = (b[1] - l10 * y0) / a11;
  const S y2 = (b[2] - l20 * y0 - l21 * y1) / a22;
  const S x2 = y2 / a22;
  const S x1 = (y1 - l21 * x2) / a11;
  const S x0 = (y0 - l10 * x1 - l20 * x2) / a00;
  V3<S> x = {{x0, x1, x2}};
  return x;
}

// ---------------------------------------------------------------------------
// Kinematics of one configuration
// ---------------------------------------------------------------------------

template <class S>
struct Kin {
  M3<S> oR[kMaxJ];
  V3<S> op[kMaxJ];
};

template <class S>
SMPC_HD void fk(const Dims& D, const real_t<S>* C, const S* q, Kin<S>& k) {
  typedef real_t<S> F;
  for (int j = 0; j < D.nj; ++j) {
    M3<S> Rl;
    V3<S> pl;
    if (j == 0) {
      Rl = quat_to_rotmat(q[3], q[4], q[5], q[6]);
      pl[0] = q[0]; pl[1] = q[1]; pl[2] = q[2];
    } else {
      const F* ax = C + D.o_axis + 3 * j;
      const F prs = C[D.o_prism + j];
      const S th = q[D.qidx[j]];
      const S tr = th * (F(1) - prs);
      const V3<S> w = {{ax[0] * tr, ax[1] * tr, ax[2] * tr}};
      Rl = exp3(w);
      const S tp = th * prs;
      pl[0] = ax[0] * tp; pl[1] = ax[1] * tp; pl[2] = ax[2] * tp;
    }
    const M3<F> jR = load33<F>(C + D.o_jR + 9 * j);
    const M3<S> Rj = mm(jR, Rl);
    const V3<S> pj = add3(load3<S>(C + D.o_jp + 3 * j), mv(jR, pl));
    const int par = D.parent[j];
    if (par < 0) {
      k.oR[j] = Rj;
      k.op[j] = pj;
    } else {
      k.oR[j] = mm(k.oR[par], Rj);
      k.op[j] = add3(k.op[par], mv(k.oR[par], pj));
    }
  }
}

// world position of selected frame s (0..nk-1 feet, nk..2nk-1 foot refs,
// 2nk base)
template <class S>
SMPC_HD V3<S> frame_pos(const Dims& D, const real_t<S>* C, const Kin<S>& k, int s) {
  const int par = D.frame_parent[s];
  return add3(k.op[par], mv(k.oR[par], load3<real_t<S>>(C + D.o_fp + 3 * s)));
}
template <class S>
SMPC_HD M3<S> frame_rot(const Dims& D, const real_t<S>* C, const Kin<S>& k, int s) {
  return mm(k.oR[D.frame_parent[s]], load33<real_t<S>>(C + D.o_fR + 9 * s));
}

// world dof axes measured at the origin, Sw[d] for d < nv
template <class S>
SMPC_HD void world_axes(const Dims& D, const real_t<S>* C, const Kin<S>& k, V6<S>* Sw) {
  typedef real_t<S> F;
  const M3<S>& R0 = k.oR[0];
  for (int d = 0; d < 3; ++d) {
    const V3<S> col = {{R0(0, d), R0(1, d), R0(2, d)}};
    Sw[d] = cat6(col, V3<S>{{S(F(0)), S(F(0)), S(F(0))}});
    Sw[3 + d] = cat6(cross(k.op[0], col), col);
  }
  for (int j = 1; j < D.nj; ++j) {
    const F prs = C[D.o_prism + j];
    const V3<S> aw = mv(k.oR[j], load3<F>(C + D.o_axis + 3 * j));
    const V3<S> c = cross(k.op[j], aw);
    V6<S> s;
    for (int i = 0; i < 3; ++i) {
      s[i] = (F(1) - prs) * c[i] + prs * aw[i];
      s[3 + i] = (F(1) - prs) * aw[i];
    }
    Sw[D.vidx[j]] = s;
  }
}

// per-body sum of the ancestor dof motions Sw[d] x[d]
template <class S>
SMPC_HD void body_velocities(const Dims& D, const V6<S>* Sw, const S* x, V6<S>* vW) {
  V6<S> v0 = scale6(Sw[0], x[0]);
  for (int d = 1; d < 6; ++d) v0 = add6(v0, scale6(Sw[d], x[d]));
  vW[0] = v0;
  for (int j = 1; j < D.nj; ++j) {
    const int d = D.vidx[j];
    vW[j] = add6(vW[D.parent[j]], scale6(Sw[d], x[d]));
  }
}

template <class S>
SMPC_HD V3<S> com_world(const Dims& D, const real_t<S>* C, const Kin<S>& k) {
  typedef real_t<S> F;
  V3<S> s;
  for (int j = 0; j < D.nj; ++j) {
    const F m = C[D.o_mass + j];
    const V3<S> cj = add3(k.op[j], mv(k.oR[j], load3<F>(C + D.o_com + 3 * j)));
    for (int i = 0; i < 3; ++i) s[i] = (j == 0) ? m * cj[i] : s[i] + m * cj[i];
  }
  const F M = C[D.o_scalars];
  for (int i = 0; i < 3; ++i) s[i] = s[i] / M;
  return s;
}

// Ag(q) x about the CoM, from the body motions vW of x
template <class S>
SMPC_HD V6<S> agx(const Dims& D, const real_t<S>* C, const Kin<S>& k, const V6<S>* vW,
                  const V3<S>& com) {
  V6<S> h = inertia_apply(C + D.o_Iloc, k.oR[0], k.op[0], vW[0]);
  for (int j = 1; j < D.nj; ++j)
    h = add6(h, inertia_apply(C + D.o_Iloc + 36 * j, k.oR[j], k.op[j], vW[j]));
  return shift_to_com(h, com);
}

// Adot(q, v) v about the CoM (ops/soa.py bias_hdot)
template <class S>
SMPC_HD V6<S> bias_hdot(const Dims& D, const real_t<S>* C, const Kin<S>& k,
                        const V6<S>* Sw, const V6<S>* vW, const S* v, const V3<S>& com) {
  V6<S> aW[kMaxJ];
  V6<S> a0 = scale6(motion_cross(vW[0], Sw[0]), v[0]);
  for (int d = 1; d < 6; ++d) a0 = add6(a0, scale6(motion_cross(vW[0], Sw[d]), v[d]));
  aW[0] = a0;
  for (int j = 1; j < D.nj; ++j) {
    const int d = D.vidx[j];
    aW[j] = add6(aW[D.parent[j]], scale6(motion_cross(vW[j], Sw[d]), v[d]));
  }
  V6<S> f;
  for (int j = 0; j < D.nj; ++j) {
    const real_t<S>* I = C + D.o_Iloc + 36 * j;
    const V6<S> hO = inertia_apply(I, k.oR[j], k.op[j], vW[j]);
    const V6<S> fb = add6(motion_cross_star(vW[j], hO),
                          inertia_apply(I, k.oR[j], k.op[j], aW[j]));
    f = (j == 0) ? fb : add6(f, fb);
  }
  return shift_to_com(f, com);
}

// composite rotational inertia about the CoM, world axes
template <class S>
SMPC_HD M3<S> composite_rot_inertia(const Dims& D, const real_t<S>* C, const Kin<S>& k,
                                    const V3<S>& com) {
  typedef real_t<S> F;
  M3<S> IO;
  for (int kk = 0; kk < 3; ++kk) {
    V6<S> e = zero6<S>();
    e[3 + kk] = S(F(1));
    for (int j = 0; j < D.nj; ++j) {
      const V6<S> h = inertia_apply(C + D.o_Iloc + 36 * j, k.oR[j], k.op[j], e);
      for (int i = 0; i < 3; ++i) IO(i, kk) = (j == 0) ? h[3 + i] : IO(i, kk) + h[3 + i];
    }
  }
  const F m = C[D.o_scalars];
  const S c2 = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const S cc = com[i] * com[j];
      IO(i, j) = IO(i, j) + m * ((i == j) ? cc - c2 : cc);
    }
  return IO;
}

// solve Ag[:, :6] x = b in closed form (ops/soa.py centroidal_solve6)
template <class S>
SMPC_HD V6<S> centroidal_solve6(const Dims& D, const real_t<S>* C, const Kin<S>& k,
                                const V3<S>& com, const V6<S>& b) {
  typedef real_t<S> F;
  const F m = C[D.o_scalars];
  const V3<S> lin = lin3(b), ang = ang3(b);
  const V3<S> ang_O = add3(ang, cross(com, lin));
  const M3<S> Ic = composite_rot_inertia(D, C, k, com);
  const V3<S> w = solve_spd3(Ic, sub3(ang_O, cross(com, lin)));
  V3<S> vl;
  const V3<S> wc = cross(w, com);
  for (int i = 0; i < 3; ++i) vl[i] = lin[i] / m - wc[i];
  return motion_action_inv(k.oR[0], k.op[0], cat6(vl, w));
}

// ---------------------------------------------------------------------------
// The stage bundle (KinodynamicsOCP.stage_eval_soa + the AL bundle of
// ProxDDPSolver._stage_bundle_soa), point feet (fs = 3)
// ---------------------------------------------------------------------------

// one lane's stage parameters, each leaf of the (B, T, ...) layout
template <class F>
struct StageParams {
  const F* active;      // (nk,)
  const F* foot_ref_p;  // (nk, 3)
  const F* x_ref;       // (nx,)
  const F* u_ref;       // (nu,)
  const F* f_ref;       // (nk, 3), read by the full-dynamics stage only
  const F* land;        // (nk,)
};

// Sink interface:
//   row(n, r, w)  AL residual row n of r_all with weight w_all[n]
//   gap(i, g)     multiple-shooting gap difference(xn, xnext)[i]
//   eq(i, g)      raw equality row i;  ineq(i, h)  raw inequality row i
template <class S, class Sink>
SMPC_HD void stage_bundle(const Dims& D, const real_t<S>* C, const S* q, const S* v,
                          const S* u, const real_t<S>* xn, const StageParams<real_t<S>>& P,
                          real_t<S> mu, const real_t<S>* LE, const real_t<S>* LI,
                          Sink& sink) {
  typedef real_t<S> F;
  const int nq = D.nq, nv = D.nv, nu = D.nu, nk = D.nk;
  Kin<S> k;
  fk(D, C, q, k);
  V6<S> Sw[kMaxV];
  world_axes(D, C, k, Sw);
  const V3<S> com = com_world(D, C, k);
  V6<S> vW[kMaxJ];
  body_velocities(D, Sw, v, vW);
  V3<S> fpw[kMaxK];
  for (int f = 0; f < nk; ++f) fpw[f] = frame_pos(D, C, k, f);
  const V6<S> hg = agx(D, C, k, vW, com);
  const V6<S> bias = bias_hdot(D, C, k, Sw, vW, v, com);

  // external centroidal wrench of the commanded (contact-masked) forces
  const F mass = C[D.o_scalars + 1];
  V6<S> Wr;
  for (int i = 0; i < 3; ++i) {
    S fs = u[i] * P.active[0];
    for (int f = 1; f < nk; ++f) fs += u[3 * f + i] * P.active[f];
    Wr[i] = mass * C[D.o_g + i] + fs;
  }
  for (int f = 0; f < nk; ++f) {
    const V3<S> ff = {{u[3 * f] * P.active[f], u[3 * f + 1] * P.active[f],
                       u[3 * f + 2] * P.active[f]}};
    const V3<S> t = cross(sub3(fpw[f], com), ff);
    for (int i = 0; i < 3; ++i) Wr[3 + i] = (f == 0) ? t[i] : Wr[3 + i] + t[i];
  }

  // KinodynamicsFwdDynamics: base acceleration from wrench consistency
  const S* ddq = u + 3 * nk;
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

  // costs: [state; control; hg; wrench; foot translations]
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
  for (int f = 0; f < nk; ++f)
    for (int i = 0; i < 3; ++i, ++n) sink.row(n, fpw[f][i] - P.foot_ref_p[3 * f + i], w[n]);

  // equalities: stance-foot zero velocity in the foot frame (+ land heights)
  const F inv_mu = F(1) / mu;
  int e = 0;
  for (int f = 0; f < nk; ++f) {
    const V6<S>& vj = vW[D.frame_parent[f]];
    const V3<S> lin = add3(lin3(vj), cross(ang3(vj), fpw[f]));
    const V3<S> vl = mtv(frame_rot(D, C, k, f), lin);
    const F on = P.active[f] > F(0.5) ? F(1) : F(0);
    for (int i = 0; i < 3; ++i, ++e, ++n) {
      const S g = vl[i] * on;
      sink.eq(e, g);
      sink.row(n, g + mu * LE[e], inv_mu);
    }
  }
  if (D.land_cstr) {
    for (int f = 0; f < nk; ++f, ++e, ++n) {
      const bool on = P.land[f] > F(0.5) && P.active[f] > F(0.5);
      const S g = on ? fpw[f][2] - P.foot_ref_p[3 * f + 2] : S(F(0));
      sink.eq(e, g);
      sink.row(n, g + mu * LE[e], inv_mu);
    }
  }

  // inequalities: joint box (+ friction pyramids); the active set is
  // decided on the primal
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
    const F* A = C + D.o_cone;  // (5, 3)
    for (int f = 0; f < nk; ++f)
      for (int c = 0; c < 5; ++c) {
        S cr = A[3 * c] * u[3 * f] + A[3 * c + 1] * u[3 * f + 1] + A[3 * c + 2] * u[3 * f + 2];
        if (c == 0) cr = cr + C[D.o_scalars + 3];
        ineq(P.active[f] > F(0.5) ? cr : S(F(-1)));
      }
  }
}

// ---------------------------------------------------------------------------
// Terminal residuals: [state difference; hg] (+ the DCM equality)
// ---------------------------------------------------------------------------

// Sink: row(n, r, w) over the n_term_cost cost rows and the n_term_eq AL
// rows g + mu lam (weight 1/mu)
template <class S, class Sink>
SMPC_HD void term_bundle(const Dims& D, const real_t<S>* C, const S* x,
                         const real_t<S>* x_ref, const real_t<S>* dcm_ref, real_t<S> mu,
                         const real_t<S>* lam, Sink& sink) {
  typedef real_t<S> F;
  const int nq = D.nq, nv = D.nv;
  Kin<S> k;
  fk(D, C, x, k);
  V6<S> Sw[kMaxV];
  world_axes(D, C, k, Sw);
  const V3<S> com = com_world(D, C, k);
  V6<S> vW[kMaxJ];
  body_velocities(D, Sw, x + nq, vW);
  const V6<S> hg = agx(D, C, k, vW, com);
  const F* w = C + D.o_wterm;
  int n = 0;
  {
    S xr[kMaxQ + kMaxV], r[2 * kMaxV];
    for (int i = 0; i < nq + nv; ++i) xr[i] = S(x_ref[i]);
    state_difference(nq, nv, xr, x, r);
    for (int i = 0; i < 2 * nv; ++i, ++n) sink.row(n, r[i], w[n]);
  }
  for (int i = 0; i < 6; ++i, ++n) sink.row(n, hg[i], w[n]);
  if (D.n_term_eq) {
    const F tau = msqrt(dcm_ref[2] / F(9.81));
    const F mass = C[D.o_scalars + 1];
    for (int i = 0; i < 3; ++i, ++n) {
      const S g = com[i] + tau * hg[i] / mass - dcm_ref[i];
      sink.row(n, g + mu * lam[i], F(1) / mu);
    }
  }
}

// ---------------------------------------------------------------------------
// Integrate along one basis direction: the lane's state moved by a tangent
// that is zero in value and e_j in its derivative (ndx = 2 nv directions
// of the state; the control directions leave the state alone)
// ---------------------------------------------------------------------------

template <class F>
SMPC_HD void seed_state(const Dims& D, const F* X, int j, Dual<F>* q, Dual<F>* v) {
  typedef Dual<F> S;
  const int nq = D.nq, nv = D.nv;
  S pq[7], dq[6];
  for (int i = 0; i < 7; ++i) pq[i] = S(X[i]);
  for (int i = 0; i < 6; ++i) dq[i] = S(F(0), j == i ? F(1) : F(0));
  freeflyer_integrate(pq, dq, q);
  for (int i = 7; i < nq; ++i) q[i] = S(X[i] + F(0), j == i - 1 ? F(1) : F(0));
  for (int i = 0; i < nv; ++i) v[i] = S(X[nq + i] + F(0), j == nv + i ? F(1) : F(0));
}

}  // namespace smpc
