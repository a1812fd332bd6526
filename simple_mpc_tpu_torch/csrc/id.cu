// K8 (the assembly): the task-space inverse-dynamics QP of the 1 kHz layer
// for point feet, one block per robot.
//
// Replaces simple_mpc_tpu/id/kinodynamics_id.py KinodynamicsID._assemble_core
// (131-308), which the JAX package jits with the ADMM solve into one XLA
// program; its twin is simple_mpc_tpu_torch/id/kinodynamics_id.py
// `_assemble_core`.  Outputs (H, g, A, l, u) of the QP over z = [ddq; f]
// and M, h, Jc' for the torques tau = (M ddq + h - Jc' f)[6:].
//
// Thread 0 of the block computes the rigid-body part of its robot in real
// arithmetic with the device functions of K7 (csrc/fulldyn.cuh): FK, the
// world dof axes and body velocities, and `mass_bias` (the composite
// inertias, the CRBA mass matrix M, the bias torques h of the Newton-Euler
// pass with the fictitious base acceleration -g, which
// `constrained_dynamics` shares); then the feet's
// LOCAL_WORLD_ALIGNED Jacobians and the base frame's, and their J-dot v.
// The twin and the JAX package take J-dot v as a jvp of the Jacobian along
// the flow q' = v; here it is the closed form.  For a frame at world point
// p on the body of joint j, with vW_j = (v_O, w) the body's spatial
// velocity at the origin and a_j = sum over its ancestor dofs of
// (vW_body(d) x Sw_d) v_d the derivative of vW_j along the flow:
//   J_lwa v     = [v_O + w x p ; w]
//   J-dot_lwa v = [a_lin + a_ang x p + w x p-dot ; a_ang],  p-dot = v_O + w x p.
// (In LOCAL coordinates the rotation's derivative cancels the w x p-dot
// term, fulldyn.cuh:22-29; in LOCAL_WORLD_ALIGNED it stays.)  The base
// task's error uses log3 of stage.cuh (the same small-angle series as the
// twin's soa.log3).  After a barrier the block's threads fill the
// matrices: the cost rows Jr (posture, base, force regularization, contact
// motion: those whose weight is > 0, in that order), H = Jr' W Jr + 1e-8 I,
// g = Jr' W r0, and the constraint rows (base dynamics, the contact motion
// equalities with `contact_motion_equality`, inactive forces, friction
// pyramids, normal-force bounds, joint viability box, torque box) with the
// twin's bounds, +-1e20 where a row is off.
//
// What bounds it on the card: the rigid-body part is one thread's serial
// arithmetic (about 20 kFLOP for the Go2), then ~0.1 MFLOP of dense fill
// spread over the block; at B = 1 it is latency, at large B the bytes of
// the dense outputs (A alone is 66 x 30).  A tree-parallel FK and CRBA
// and sparse outputs are left for later work.
//
// Layouts (row-major, contiguous, leading robot axis b): q (B,nq) v (B,nv)
// q_t (B,nq) v_t a_t (B,nv) contacts (B,nk) f_t (B,nk,3); P the task
// constants (kernels.py `_id_params`, `IdParams` below); out H (B,nz,nz)
// g (B,nz) A (B,m,nz) l u (B,m) M (B,nv,nv) h (B,nv) JcT (B,nv,3nk).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "fulldyn.cuh"

// The contact force size: point feet (3) in this unit; csrc/id_wide.cu
// compiles it again with the size read from Dims (3 or 6).
#ifndef SMPC_ID_FS
#define SMPC_ID_FS 3
#endif

// Hooks for csrc/id_centroidal.cu (CentroidalID's CoM and swing-foot rows
// and its orientation-only base task), empty here: the rigid-body part's
// extra fields and their computation, the kernel's, the launcher's and the
// C entry point's extra parameters and arguments, the extra cost rows (their
// count, at most, and a statement before the kinodynamics rows that fills
// them), the base rows' weight mask and a call before the launch.
#ifndef SMPC_ID_RIGID_FIELDS
#define SMPC_ID_RIGID_FIELDS
#define SMPC_ID_RIGID_EXTRA
#define SMPC_ID_KERNEL_PARAMS
#define SMPC_ID_LAUNCH_PARAMS
#define SMPC_ID_LAUNCH_ARGS
#define SMPC_ID_CALL_ARGS
#define SMPC_ID_EXTRA_ROWS
#define SMPC_ID_EXTRA_ROWS_MAX
#define SMPC_ID_EXTRA_ROW
#define SMPC_ID_BASE_MASK
#define SMPC_ID_PRELAUNCH
#endif

namespace smpc {

// Offsets into the task constants P (kernels.py `_id_params`).
struct IdParams {
  enum {
    kp_base, kp_posture, kp_contact, kd_base, kd_posture, kd_contact, w_base,
    w_posture, w_contact_motion, w_contact_force, min_f, max_f, dt, dt2,
    cone  // then cone (n_cone x fs), vmax, qlo, qhi, taumax (nu each)
  };
};

constexpr int kIdC = SMPC_MAX_FORCE_SIZE * kMaxK;  // contact rows

// The rigid-body part of one robot.
template <class F>
struct IdRigid {
  F M[kMaxV * kMaxV];  // full, symmetric
  F h[kMaxV];
  F Jc[kIdC * kMaxV];  // feet, LWA rows (fs nk, nv): linear, then angular if fs = 6
  F jdv[kIdC];         // J-dot v of those rows
  F vf[kIdC];          // J v
  F Jb[6 * kMaxV];     // base frame, LWA [lin; ang] (6, nv)
  F jdvb[6], vb[6];    // its J-dot v and J v
  F e6[6];             // [p_t - p_b; R_b log3(R_b' R_t)]
  F vt[6], at[6];      // the base target velocity and acceleration, world-aligned
  SMPC_ID_RIGID_FIELDS
};

// LWA Jacobian rows (nrow = 3: linear; 6: [lin; ang]) of the frame at world
// point p on joint pj's body, J v and J-dot v
template <class F>
SMPC_HD void lwa_rows(const Dims& D, const FdKin<F>& K, const V6<F>* aW, int pj,
                      const V3<F>& p, int nrow, F* J, F* jv, F* jdv) {
  const int nv = D.nv;
  for (int d = 0; d < nv; ++d) {
    const bool on = joint_ancestor(D, dof_joint(d), pj);
    const V3<F> w = ang3(K.Sw[d]);
    const V3<F> lin = add3(lin3(K.Sw[d]), cross(w, p));
    for (int i = 0; i < 3; ++i) {
      J[i * nv + d] = on ? lin[i] : F(0);
      if (nrow == 6) J[(3 + i) * nv + d] = on ? w[i] : F(0);
    }
  }
  const V3<F> om = ang3(K.vW[pj]);
  const V3<F> pdot = add3(lin3(K.vW[pj]), cross(om, p));
  const V3<F> acc = add3(add3(lin3(aW[pj]), cross(ang3(aW[pj]), p)), cross(om, pdot));
  for (int i = 0; i < 3; ++i) {
    jv[i] = pdot[i];
    jdv[i] = acc[i];
    if (nrow == 6) {
      jv[3 + i] = om[i];
      jdv[3 + i] = aW[pj][3 + i];
    }
  }
}

// The rigid-body part of one robot (thread 0 of its block).  Selected
// frames: the nk feet, then the base at index nk.
template <class F>
SMPC_HD void id_rigid(const Dims& D, const F* C, const F* q, const F* v, const F* q_t,
                      const F* v_t, const F* a_t, IdRigid<F>& R) {
  const int nk = D.nk;
  FdKin<F> K;
  fd_kinematics(D, C, q, v, K);
  V6<F> aW[kMaxJ];
  const int nv = D.nv;
  mass_bias(
      D, C, K, v, [&](int i, int j, F m) { R.M[i * nv + j] = R.M[j * nv + i] = m; }, R.h, aW);
  for (int f = 0; f < nk; ++f)
    lwa_rows(D, K, aW, D.frame_parent[f], K.fpw[f], SMPC_ID_FS, R.Jc + SMPC_ID_FS * f * D.nv,
             R.vf + SMPC_ID_FS * f, R.jdv + SMPC_ID_FS * f);
  const V3<F> pb = frame_pos(D, C, K.k, nk);
  const M3<F> Rb = frame_rot(D, C, K.k, nk);
  lwa_rows(D, K, aW, D.frame_parent[nk], pb, 6, R.Jb, R.vb, R.jdvb);
  // base target pose: the base frame at the target configuration
  Kin<F> Kt;
  fk(D, C, q_t, Kt);
  const V3<F> pt = frame_pos(D, C, Kt, nk);
  const M3<F> Rt = frame_rot(D, C, Kt, nk);
  const V3<F> er = mv(Rb, log3(mtm(Rb, Rt)));
  const V3<F> vl = mv(Rb, load3<F>(v_t)), vw = mv(Rb, load3<F>(v_t + 3));
  const V3<F> al = mv(Rb, load3<F>(a_t)), aw = mv(Rb, load3<F>(a_t + 3));
  for (int i = 0; i < 3; ++i) {
    R.e6[i] = pt[i] - pb[i];
    R.e6[3 + i] = er[i];
    R.vt[i] = vl[i];
    R.vt[3 + i] = vw[i];
    R.at[i] = al[i];
    R.at[3 + i] = aw[i];
  }
  SMPC_ID_RIGID_EXTRA
}

}  // namespace smpc

namespace {

using smpc::Dims;
using smpc::IdParams;
using smpc::IdRigid;

constexpr int kThreads = 128;
constexpr double kInf = 1e20;  // the twin's _INF

template <class F>
__global__ void __launch_bounds__(kThreads)
id_assemble_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ P,
                   const F* __restrict__ q, const F* __restrict__ v,
                   const F* __restrict__ q_t, const F* __restrict__ v_t,
                   const F* __restrict__ a_t, const F* __restrict__ contacts,
                   const F* __restrict__ f_t, SMPC_ID_KERNEL_PARAMS int eq_mode, int n_cone, int m,
                   F* __restrict__ H, F* __restrict__ g, F* __restrict__ A,
                   F* __restrict__ l, F* __restrict__ u, F* __restrict__ Mo,
                   F* __restrict__ ho, F* __restrict__ JcT) {
  __shared__ IdRigid<F> R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = D.nq, nv = D.nv, nu = D.nu, nk = D.nk, nc = SMPC_ID_FS * nk, nz = nv + nc;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const F* qb = q + b * nq;
  const F* vb = v + b * nv;
  const F* qt = q_t + b * nq;
  const F* vt = v_t + b * nv;
  const F* at = a_t + b * nv;
  const F* cb = contacts + b * nk;
  const F* fb = f_t + b * nc;
  if (tid == 0) smpc::id_rigid(D, C, qb, vb, qt, vt, at, R);

  // which cost rows there are, in the twin's order
  const bool posture = P[IdParams::w_posture] > F(0);
  const bool base = P[IdParams::w_base] > F(0);
  const bool force = P[IdParams::w_contact_force] > F(0);
  const bool motion = !eq_mode && P[IdParams::w_contact_motion] > F(0);
  const int r_base = posture ? nu : 0;
  const int r_force = r_base + (base ? 6 : 0);
  const int r_motion = r_force + (force ? nc : 0);
  const int nr = r_motion + (motion ? nc : 0) SMPC_ID_EXTRA_ROWS;
  F* Jr = reinterpret_cast<F*>(smem_raw);  // nr x nz
  F* wr = Jr + (size_t)nr * nz;            // nr: w
  F* wr0 = wr + nr;                        // nr: w r0
  for (int i = tid; i < nr * nz; i += nth) Jr[i] = F(0);
  __syncthreads();

  const F kd_c = P[IdParams::kd_contact];
  for (int r = tid; r < nr; r += nth) {
    F w, r0;
    SMPC_ID_EXTRA_ROW
    if (r < r_base) {  // posture
      const F kp = P[IdParams::kp_posture], kd = P[IdParams::kd_posture];
      const F a_des = at[6 + r] + kp * (qt[7 + r] - qb[7 + r]) + kd * (vt[6 + r] - vb[6 + r]);
      Jr[r * nz + 6 + r] = F(1);
      w = P[IdParams::w_posture];
      r0 = -a_des;
    } else if (r < r_force) {  // base
      const int i = r - r_base;
      const F kp = P[IdParams::kp_base], kd = P[IdParams::kd_base];
      const F a_des = R.at[i] + kp * R.e6[i] + kd * (R.vt[i] - R.vb[i]);
      for (int d = 0; d < nv; ++d) Jr[r * nz + d] = R.Jb[i * nv + d];
      w = P[IdParams::w_base] SMPC_ID_BASE_MASK;
      r0 = R.jdvb[i] - a_des;
    } else if (r < r_motion) {  // force regularization
      const int i = r - r_force;
      Jr[r * nz + nv + i] = F(1);
      w = cb[i / SMPC_ID_FS] * P[IdParams::w_contact_force];
      r0 = -fb[i];
    } else {  // contact motion as a cost
      const int i = r - r_motion;
      for (int d = 0; d < nv; ++d) Jr[r * nz + d] = R.Jc[i * nv + d];
      w = cb[i / SMPC_ID_FS] * P[IdParams::w_contact_motion];
      r0 = R.jdv[i] + kd_c * R.vf[i];
    }
    wr[r] = w;
    wr0[r] = w * r0;
  }
  __syncthreads();

  F* Hb = H + b * nz * nz;
  for (int idx = tid; idx < nz * nz; idx += nth) {
    const int i = idx / nz, j = idx % nz;
    F s = F(0);
    for (int r = 0; r < nr; ++r) s += Jr[r * nz + i] * wr[r] * Jr[r * nz + j];
    Hb[idx] = s + (i == j ? F(1e-8) : F(0));
  }
  for (int i = tid; i < nz; i += nth) {
    F s = F(0);
    for (int r = 0; r < nr; ++r) s += Jr[r * nz + i] * wr0[r];
    g[b * nz + i] = s;
  }

  // constraint rows
  const F inf = F(kInf);
  const int c_eq = 6, c_f = c_eq + (eq_mode ? nc : 0), c_cone = c_f + nc;
  const int c_fz = c_cone + nk * n_cone, c_j = c_fz + nk, c_tau = c_j + nu;
  F* Ab = A + b * m * nz;
  for (int idx = tid; idx < m * nz; idx += nth) Ab[idx] = F(0);
  __syncthreads();
  const F* cone = P + IdParams::cone;
  const F* vmax = cone + SMPC_ID_FS * n_cone;
  const F* qlo = vmax + nu;
  const F* qhi = qlo + nu;
  const F* taumax = qhi + nu;
  for (int r = tid; r < m; r += nth) {
    F lo, hi;
    F* Ar = Ab + (size_t)r * nz;
    if (r < c_eq) {  // base dynamics: M6 ddq - (Jc'f)6 = -h6
      for (int d = 0; d < nv; ++d) Ar[d] = R.M[r * nv + d];
      for (int c = 0; c < nc; ++c) Ar[nv + c] = -R.Jc[c * nv + r];
      lo = hi = -R.h[r];
    } else if (r < c_f) {  // contact motion equality
      const int i = r - c_eq;
      for (int d = 0; d < nv; ++d) Ar[d] = R.Jc[i * nv + d];
      const bool act = cb[i / SMPC_ID_FS] > F(0.5);
      const F rhs = -(R.jdv[i] + kd_c * R.vf[i]);
      lo = act ? rhs : -inf;
      hi = act ? rhs : inf;
    } else if (r < c_cone) {  // inactive contact force = 0
      const int i = r - c_f;
      Ar[nv + i] = F(1);
      const bool act = cb[i / SMPC_ID_FS] > F(0.5);
      lo = act ? -inf : F(0);
      hi = act ? inf : F(0);
    } else if (r < c_fz) {  // friction pyramid (wrench cone) rows of foot k
      const int k = (r - c_cone) / n_cone, c = (r - c_cone) % n_cone;
      for (int j = 0; j < SMPC_ID_FS; ++j) Ar[nv + SMPC_ID_FS * k + j] = cone[SMPC_ID_FS * c + j];
      lo = -inf;
      hi = cb[k] > F(0.5) ? F(0) : inf;
    } else if (r < c_j) {  // normal-force bounds
      const int k = r - c_fz;
      Ar[nv + SMPC_ID_FS * k + 2] = F(1);
      const bool act = cb[k] > F(0.5);
      lo = act ? P[IdParams::min_f] : -inf;
      hi = act ? P[IdParams::max_f] : inf;
    } else if (r < c_tau) {  // joint position / velocity viability
      const int i = r - c_j;
      Ar[6 + i] = F(1);
      const F dt = P[IdParams::dt], dt2 = P[IdParams::dt2];
      const F qj = qb[7 + i], vj = vb[6 + i];
      const F h1 = (vmax[i] - vj) / dt, h2 = F(2) * (qhi[i] - qj - vj * dt) / dt2;
      const F l1 = (-vmax[i] - vj) / dt, l2 = F(2) * (qlo[i] - qj - vj * dt) / dt2;
      const F dd_hi = h2 < h1 ? h2 : h1, dd_lo = l2 > l1 ? l2 : l1;
      lo = dd_hi < dd_lo ? dd_hi : dd_lo;
      hi = dd_hi > dd_lo ? dd_hi : dd_lo;
    } else {  // torque box: tau = (M ddq + h - Jc'f) actuated rows
      const int i = r - c_tau;
      for (int d = 0; d < nv; ++d) Ar[d] = R.M[(6 + i) * nv + d];
      for (int c = 0; c < nc; ++c) Ar[nv + c] = -R.Jc[c * nv + 6 + i];
      lo = -taumax[i] - R.h[6 + i];
      hi = taumax[i] - R.h[6 + i];
    }
    l[b * m + r] = lo;
    u[b * m + r] = hi;
  }
  for (int i = tid; i < nv * nv; i += nth) Mo[b * nv * nv + i] = R.M[i];
  for (int i = tid; i < nv; i += nth) ho[b * nv + i] = R.h[i];
  for (int idx = tid; idx < nv * nc; idx += nth) {
    const int d = idx / nc, c = idx % nc;
    JcT[b * nv * nc + idx] = R.Jc[c * nv + d];
  }
}

template <class F>
int launch_id(const int* dims, const void* C, const void* P, const void* q, const void* v,
              const void* q_t, const void* v_t, const void* a_t, const void* contacts,
              const void* f_t, SMPC_ID_LAUNCH_PARAMS int nbatch, int eq_mode, int n_cone, int m,
              void* H, void* g, void* A, void* l, void* u, void* M, void* h, void* JcT,
              void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (D.nk > smpc::kMaxK || D.nv > smpc::kMaxV || SMPC_ID_FS > SMPC_MAX_FORCE_SIZE)
    return (int)cudaErrorInvalidValue;
  const int nz = D.nv + SMPC_ID_FS * D.nk;
  const int nr = D.nu + 6 + 2 * SMPC_ID_FS * D.nk SMPC_ID_EXTRA_ROWS_MAX;  // at most: every cost row
  const size_t smem = ((size_t)nr * nz + 2 * (size_t)nr) * sizeof(F);
  SMPC_ID_PRELAUNCH
  id_assemble_kernel<F><<<nbatch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(P), static_cast<const F*>(q),
      static_cast<const F*>(v), static_cast<const F*>(q_t), static_cast<const F*>(v_t),
      static_cast<const F*>(a_t), static_cast<const F*>(contacts),
      static_cast<const F*>(f_t), SMPC_ID_LAUNCH_ARGS eq_mode, n_cone, m, static_cast<F*>(H),
      static_cast<F*>(g), static_cast<F*>(A), static_cast<F*>(l), static_cast<F*>(u),
      static_cast<F*>(M), static_cast<F*>(h), static_cast<F*>(JcT));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SMPC_ID(sfx, F)                                                                    \
  int smpc_id_assemble_##sfx(const int* dims, const void* C, const void* P, const void* q, \
                             const void* v, const void* q_t, const void* v_t,              \
                             const void* a_t, const void* contacts, const void* f_t,       \
                             SMPC_ID_LAUNCH_PARAMS                                         \
                             int nbatch, int eq_mode, int n_cone, int m, void* H, void* g, \
                             void* A, void* l, void* u, void* M, void* h, void* JcT,       \
                             void* stream) {                                               \
    return launch_id<F>(dims, C, P, q, v, q_t, v_t, a_t, contacts, f_t, SMPC_ID_CALL_ARGS  \
                        nbatch, eq_mode,                                                   \
                        n_cone, m, H, g, A, l, u, M, h, JcT, stream);                      \
  }

SMPC_ID(f32, float)
SMPC_ID(f64, double)

}  // extern "C"
