// K10: one step of the rigid-contact simulator, one thread per robot.
//
// Replaces simple_mpc_tpu/sim/simulator.py Simulator.step (125-150) over
// ops/dynamics.py constrained_fwd_dynamics (375-465), which the JAX package
// jits as one XLA program; its twin is simple_mpc_tpu_torch/sim/simulator.py
// `Simulator.step_plain`.  For each robot, with the ground plane at height
// z0:
//   FK of the feet; pen = z0 - p_z; active0 = pen > -margin; anchors = the
//   feet with z pinned to z0;
//   (ddq, f) = the masked constrained dynamics (K7, csrc/fulldyn.cuh
//   `constrained_dynamics`, included as it is: LOCAL contact rows,
//   Baumgarte kd (J v) + kp R'(p - anchor), the proximal Delassus
//   diagonal); f_w = R f;
//   active1 = active0 * (f_w,z > 0) (drop the contacts that pull), solve
//   again, f_w = R f;
//   v' = v + dt ddq, q' = q (+) dt v' (the free-flyer's exp on SE(3)).
// The two masks are outputs too, so a check can compare them before the
// states.
//
// What bounds it on the card: one thread's serial arithmetic, twice K7
// (about 60 kFLOP for the Go2); at B = 1 a single thread runs it, so the
// step is the latency of that chain.  Spreading one robot's FK, CRBA and
// factorizations over a block (or the dofs over a warp) is left for later
// work.
//
// Layouts (row-major, contiguous, leading robot axis b): q (B,nq) v (B,nv)
// tau (B,nu); out q (B,nq) v (B,nv) f_w (B,nk,3) active (B,2,nk).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "fulldyn.cuh"

namespace smpc {

// One simulator step of one robot (see above).
template <class F>
SMPC_HD void sim_lane(const Dims& D, const F* C, const F* q, const F* v, const F* tau, F dt,
                      F ground, F margin, F* q_o, F* v_o, F* fw_o, F* act_o) {
  const int nq = D.nq, nv = D.nv, nk = D.nk;
  FdKin<F> K;
  fd_kinematics(D, C, q, v, K);
  F active0[kMaxK], active1[kMaxK], anchors[3 * kMaxK];
  for (int f = 0; f < nk; ++f) {
    active0[f] = (ground - K.fpw[f][2] > -margin) ? F(1) : F(0);
    anchors[3 * f] = K.fpw[f][0];
    anchors[3 * f + 1] = K.fpw[f][1];
    anchors[3 * f + 2] = ground;
  }
  F ddq[kMaxV], fl[kMaxC];
  constrained_dynamics(D, C, K, v, tau, active0, anchors, ddq, fl);
  for (int f = 0; f < nk; ++f) {
    const V3<F> fw = mv(K.fRw[f], load3<F>(fl + 3 * f));
    active1[f] = active0[f] * (fw[2] > F(0) ? F(1) : F(0));
  }
  constrained_dynamics(D, C, K, v, tau, active1, anchors, ddq, fl);
  for (int f = 0; f < nk; ++f) {
    const V3<F> fw = mv(K.fRw[f], load3<F>(fl + 3 * f));
    for (int i = 0; i < 3; ++i) fw_o[3 * f + i] = fw[i];
    act_o[f] = active0[f];
    act_o[nk + f] = active1[f];
  }
  F dq[kMaxV];
  for (int i = 0; i < nv; ++i) {
    v_o[i] = v[i] + dt * ddq[i];
    dq[i] = dt * v_o[i];
  }
  freeflyer_integrate(q, dq, q_o);
  for (int i = 7; i < nq; ++i) q_o[i] = q[i] + dq[i - 1];
}

}  // namespace smpc

namespace {

using smpc::Dims;

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
sim_step_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ q,
                const F* __restrict__ v, const F* __restrict__ tau, int n, F dt, F ground,
                F margin, F* __restrict__ q_o, F* __restrict__ v_o, F* __restrict__ fw,
                F* __restrict__ act) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const size_t nq = D.nq, nv = D.nv, nk = D.nk;
  smpc::sim_lane(D, C, q + b * nq, v + b * nv, tau + b * (nv - 6), dt, ground, margin,
                 q_o + b * nq, v_o + b * nv, fw + b * 3 * nk, act + b * 2 * nk);
}

template <class F>
int launch_sim(const int* dims, const void* C, const void* q, const void* v, const void* tau,
               int n, double dt, double ground, double margin, void* q_o, void* v_o,
               void* fw, void* act, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sim_step_kernel<F><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(q), static_cast<const F*>(v),
      static_cast<const F*>(tau), n, F(dt), F(ground), F(margin), static_cast<F*>(q_o),
      static_cast<F*>(v_o), static_cast<F*>(fw), static_cast<F*>(act));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SMPC_SIM(sfx, F)                                                                 \
  int smpc_sim_step_##sfx(const int* dims, const void* C, const void* q, const void* v,  \
                          const void* tau, int n, double dt, double ground,             \
                          double margin, void* q_o, void* v_o, void* fw, void* act,     \
                          void* stream) {                                               \
    return launch_sim<F>(dims, C, q, v, tau, n, dt, ground, margin, q_o, v_o, fw, act,  \
                         stream);                                                       \
  }

SMPC_SIM(f32, float)
SMPC_SIM(f64, double)

}  // extern "C"
