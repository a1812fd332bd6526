// K8's assembly for CentroidalID: csrc/id.cu compiled again over
// csrc/stage_wide.cuh (32 joints, 8 feet of force size 3 or 6, read from
// Dims as in csrc/id_wide.cu), in the namespace smpc_wide, with its C entry
// points renamed smpc_centroidal_id_assemble_*, and id.cu's hooks filled
// with CentroidalID's tasks (simple_mpc_tpu/id/centroidal_id.py:70-126,
// reference centroidal-id.cpp:10-52, 105-139):
//   * the base task masked to its orientation rows (weight 0 on the three
//     position rows, JAX id/kinodynamics_id.py:93-94, :202);
//   * the CoM task (when w_com > 0): J = Ag[:3] / m = the mass-weighted mean
//     of the bodies' CoM Jacobians, its J-dot v the mass-weighted mean of the
//     bodies' CoM accelerations along the flow q' = v (the LOCAL_WORLD_ALIGNED
//     point formula of id.cu's lwa_rows at each body's CoM), and
//     a_des = kp (com_t - com) + kd (vcom_t - J v), kd = 2 sqrt(kp);
//   * a swing task per foot (when w_feet_tracking > 0), weighted
//     w_feet_tracking (1 - contact): the foot's LOCAL_WORLD_ALIGNED rows and
//     J-dot v that id.cu already forms for the contact rows (linear, then
//     angular for 6D feet), the error [p_t - p; R log3(R' R_t)] (the
//     position alone for point feet) and a_des = kp e + kd (v_t - J v).
// These rows follow the kinodynamics cost rows in the twin's order
// (`CentroidalID._extra_tasks` after the contact-motion rows).  Their
// constants (kp_com, kd_com, w_com, kp_feet, kd_feet, w_feet) follow the
// kinodynamics task constants in P (kernels.py `_id_params`); the targets
// come in five more arrays.  The row buffer grows by 3 + fs nk rows, which
// with the wide IdRigid takes the block past 48 KB of shared memory: the
// launcher opts the kernel in to the dynamic size it needs.
//
// Layouts: id.cu's, plus com_t, com_v_t (B,3) feet_p_t (B,nk,3) feet_R_t
// (B,nk,3,3) feet_v_t (B,nk,6).
#include "stage_wide.cuh"

#define smpc smpc_wide
#define SMPC_ID_FS (D.fs)
#include "fulldyn.cuh"

namespace smpc_wide {

// the extra task constants after the kinodynamics ones in P
struct CidParams {
  enum { kp_com, kd_com, w_com, kp_feet, kd_feet, w_feet };
};

// The CoM, its Jacobian J = Ag[:3] / m, J v and J-dot v, and the feet's
// world placements, from the rigid-body pass of id_rigid (thread 0).
template <class F, class Rigid>
SMPC_HD void cid_rigid(const Dims& D, const F* C, const F* v, const FdKin<F>& K,
                       const V6<F>* aW, Rigid& R) {
  const int nv = D.nv, nj = D.nj;
  const F M = C[D.o_scalars];
  V3<F> cj[kMaxJ];
  F msub[kMaxJ];
  V3<F> mc[kMaxJ];  // sum of m c over each body's subtree
  for (int i = 0; i < 3; ++i) R.com[i] = R.jdv_com[i] = F(0);
  for (int j = 0; j < nj; ++j) {
    const F m = C[D.o_mass + j];
    cj[j] = add3(K.k.op[j], mv(K.k.oR[j], load3<F>(C + D.o_com + 3 * j)));
    msub[j] = m;
    for (int i = 0; i < 3; ++i) mc[j][i] = m * cj[j][i];
    // the CoM's acceleration along the flow (lwa_rows' point formula)
    const V3<F> om = ang3(K.vW[j]);
    const V3<F> pdot = add3(lin3(K.vW[j]), cross(om, cj[j]));
    const V3<F> acc = add3(add3(lin3(aW[j]), cross(ang3(aW[j]), cj[j])), cross(om, pdot));
    for (int i = 0; i < 3; ++i) {
      R.com[i] += m * cj[j][i];
      R.jdv_com[i] += m * acc[i];
    }
  }
  for (int j = nj - 1; j > 0; --j) {
    const int p = D.parent[j];
    msub[p] += msub[j];
    for (int i = 0; i < 3; ++i) mc[p][i] += mc[j][i];
  }
  for (int i = 0; i < 3; ++i) {
    R.com[i] = R.com[i] / M;
    R.jdv_com[i] = R.jdv_com[i] / M;
    R.vcom[i] = F(0);
  }
  // column d: (m_sub lin(Sw_d) + ang(Sw_d) x sum m c) / M over dof d's subtree
  for (int d = 0; d < nv; ++d) {
    const int j = dof_joint(d);
    const V3<F> w = ang3(K.Sw[d]);
    const V3<F> c = cross(w, mc[j]);
    for (int i = 0; i < 3; ++i) {
      const F col = (msub[j] * K.Sw[d][i] + c[i]) / M;
      R.Jcom[i * nv + d] = col;
    }
  }
  for (int i = 0; i < 3; ++i) {
    F s = F(0);
    for (int d = 0; d < nv; ++d) s += R.Jcom[i * nv + d] * v[d];
    R.vcom[i] = s;
  }
  for (int f = 0; f < D.nk; ++f)
    for (int i = 0; i < 3; ++i) {
      R.fp[3 * f + i] = K.fpw[f][i];
      for (int c = 0; c < 3; ++c) R.fR[9 * f + 3 * i + c] = K.fRw[f](i, c);
    }
}

// extra cost rows: 3 CoM rows (w_com > 0), then fs rows a foot
// (w_feet > 0)
template <class F>
SMPC_HD int cid_rows(const Dims& D, const F* XP) {
  return (XP[CidParams::w_com] > F(0) ? 3 : 0) +
         (XP[CidParams::w_feet] > F(0) ? SMPC_ID_FS * D.nk : 0);
}

// extra row i of robot b: its Jacobian row (the first nv entries of Jrow),
// weight w and r0 = J-dot v - a_des
template <class F, class Rigid>
SMPC_HD void cid_row(const Dims& D, const F* XP, const Rigid& R, int i, size_t b,
                     const F* com_t, const F* com_v_t, const F* feet_p_t, const F* feet_R_t,
                     const F* feet_v_t, const F* cb, F* Jrow, F& w, F& r0) {
  const int nv = D.nv, fs = SMPC_ID_FS;
  if (XP[CidParams::w_com] > F(0)) {
    if (i < 3) {
      for (int d = 0; d < nv; ++d) Jrow[d] = R.Jcom[i * nv + d];
      const F a_des = XP[CidParams::kp_com] * (com_t[b * 3 + i] - R.com[i]) +
                      XP[CidParams::kd_com] * (com_v_t[b * 3 + i] - R.vcom[i]);
      w = XP[CidParams::w_com];
      r0 = R.jdv_com[i] - a_des;
      return;
    }
    i -= 3;
  }
  const int k = i / fs, c = i % fs, row = fs * k + c;
  for (int d = 0; d < nv; ++d) Jrow[d] = R.Jc[row * nv + d];
  F e;
  if (c < 3) {
    e = feet_p_t[(b * D.nk + k) * 3 + c] - R.fp[3 * k + c];
  } else {
    const M3<F> Rk = load33<F>(R.fR + 9 * k);
    const M3<F> Rt = load33<F>(feet_R_t + (b * D.nk + k) * 9);
    e = mv(Rk, log3(mtm(Rk, Rt)))[c - 3];
  }
  const F a_des = XP[CidParams::kp_feet] * e +
                  XP[CidParams::kd_feet] * (feet_v_t[(b * D.nk + k) * 6 + c] - R.vf[row]);
  w = XP[CidParams::w_feet] * (F(1) - cb[k]);
  r0 = R.jdv[row] - a_des;
}

}  // namespace smpc_wide

#define SMPC_ID_RIGID_FIELDS                                 \
  F com[3], vcom[3], jdv_com[3]; /* the CoM task's rows */ \
  F Jcom[3 * kMaxV];                                       \
  F fp[3 * kMaxK], fR[9 * kMaxK]; /* the feet's placements */
#define SMPC_ID_RIGID_EXTRA cid_rigid(D, C, v, K, aW, R);
#define SMPC_ID_KERNEL_PARAMS                                                              \
  const F *__restrict__ com_t, const F *__restrict__ com_v_t, const F *__restrict__ feet_p_t, \
      const F *__restrict__ feet_R_t, const F *__restrict__ feet_v_t,
#define SMPC_ID_LAUNCH_PARAMS \
  const void *com_t, const void *com_v_t, const void *feet_p_t, const void *feet_R_t, \
      const void *feet_v_t,
#define SMPC_ID_LAUNCH_ARGS                                                                \
  static_cast<const F*>(com_t), static_cast<const F*>(com_v_t),                           \
      static_cast<const F*>(feet_p_t), static_cast<const F*>(feet_R_t),                   \
      static_cast<const F*>(feet_v_t),
#define SMPC_ID_CALL_ARGS com_t, com_v_t, feet_p_t, feet_R_t, feet_v_t,
#define SMPC_ID_XP (P + IdParams::cone + SMPC_ID_FS * n_cone + 4 * nu)
#define SMPC_ID_EXTRA_ROWS +smpc::cid_rows(D, SMPC_ID_XP)
#define SMPC_ID_EXTRA_ROWS_MAX +3 + SMPC_ID_FS * D.nk
// a whole statement before id.cu's chain of kinodynamics rows: an extra
// row is filled and weighted here and skips the chain
#define SMPC_ID_EXTRA_ROW                                                                  \
  if (r >= r_motion + (motion ? nc : 0)) {                                                 \
    smpc::cid_row(D, SMPC_ID_XP, R, r - r_motion - (motion ? nc : 0), b, com_t, com_v_t,   \
                  feet_p_t, feet_R_t, feet_v_t, cb, Jr + (size_t)r * nz, w, r0);           \
    wr[r] = w;                                                                             \
    wr0[r] = w * r0;                                                                       \
    continue;                                                                              \
  }
#define SMPC_ID_BASE_MASK *(i < 3 ? F(0) : F(1))
#define SMPC_ID_PRELAUNCH                                                              \
  cudaFuncSetAttribute(id_assemble_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                       (int)smem);
#define smpc_id_assemble_f32 smpc_centroidal_id_assemble_f32
#define smpc_id_assemble_f64 smpc_centroidal_id_assemble_f64
#include "id.cu"
