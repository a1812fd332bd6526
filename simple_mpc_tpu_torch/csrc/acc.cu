// K11: the kinodynamics state derivative [v; a] on N lanes, one thread a
// lane.
//
// Replaces simple_mpc_tpu/ocp/kinodynamics.py
// KinodynamicsOCP.state_derivative (531) over ode_acc (142-165), one jitted
// XLA program behind MPC.get_state_derivative; its twin is
// simple_mpc_tpu_torch/ocp/kinodynamics.py `_acc_soa` (kernels.py
// `state_derivative_plain`).  For one lane x = [q; v], u = [f; ddq_j] and
// the contact mask m:
//   FK, the world dof axes, the CoM and the body velocities;
//   the commanded centroidal wrench W = [m g + sum_k m_k f_k,
//   sum_k (p_k - c) x m_k f_k (+ sum_k m_k tau_k with 6D contacts)];
//   a = [Ag[:, :6]^-1 (W - Adot v - Ag[:, 6:] ddq_j); ddq_j]
// with the closed-form 6x6 centroidal solve of stage.cuh, as the stage
// kernels take the same acceleration inside their Euler step.
//
// This unit is the point-feet instance over stage.cuh at the Go2 units'
// limits (16 joints); csrc/acc_wide.cu compiles it again over
// csrc/stage_wide.cuh (32 joints, force size 3 or 6).  linearize.cu and
// stage.cuh's kinodynamics bundle are not touched: their machine code
// holds the Go2 fixture's f32 margin.
//
// What bounds it on the card: one thread's serial arithmetic (FK, the
// composite inertias, ~10 kFLOP for the Go2); the closed loop calls it at
// N = 1, so the kernel is its launch and that chain, in place of the
// ~1,500 small torch ops of the twin at N = 1.
//
// Layouts (row-major, contiguous, leading lane axis n): x (N,nq+nv)
// u (N,nu) active (N,nk); out xdot (N,2nv) = [v; a].
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "stage.cuh"

namespace smpc {

// [v; a] of one lane (see above)
template <class F>
SMPC_HD void kino_xdot(const Dims& D, const F* C, const F* x, const F* u, const F* active,
                       F* out) {
  const int nq = D.nq, nv = D.nv, nk = D.nk, fs = D.fs;
  const F* q = x;
  const F* v = x + nq;
  Kin<F> k;
  fk(D, C, q, k);
  V6<F> Sw[kMaxV];
  world_axes(D, C, k, Sw);
  const V3<F> com = com_world(D, C, k);
  V6<F> vW[kMaxJ];
  body_velocities(D, Sw, v, vW);
  const V6<F> bias = bias_hdot(D, C, k, Sw, vW, v, com);

  // the commanded (contact-masked) wrench about the CoM
  const F mass = C[D.o_scalars + 1];
  V6<F> Wr;
  for (int i = 0; i < 3; ++i) {
    F fsum = u[i] * active[0];
    for (int f = 1; f < nk; ++f) fsum += u[fs * f + i] * active[f];
    Wr[i] = mass * C[D.o_g + i] + fsum;
  }
  for (int f = 0; f < nk; ++f) {
    const F a = active[f];
    const V3<F> ff = {{u[fs * f] * a, u[fs * f + 1] * a, u[fs * f + 2] * a}};
    const V3<F> t = cross(sub3(frame_pos(D, C, k, f), com), ff);
    for (int i = 0; i < 3; ++i) Wr[3 + i] = (f == 0) ? t[i] : Wr[3 + i] + t[i];
  }
  if (fs == 6) {
    for (int i = 0; i < 3; ++i) {
      F tsum = u[3 + i] * active[0];
      for (int f = 1; f < nk; ++f) tsum += u[6 * f + 3 + i] * active[f];
      Wr[3 + i] = Wr[3 + i] + tsum;
    }
  }

  // the base from wrench consistency, the joints from the control
  const F* ddq = u + fs * nk;
  V6<F> vA[kMaxJ];
  {
    F acc[kMaxV];
    for (int d = 0; d < 6; ++d) acc[d] = F(0);
    for (int d = 6; d < nv; ++d) acc[d] = ddq[d - 6];
    body_velocities(D, Sw, acc, vA);
  }
  const V6<F> agj = agx(D, C, k, vA, com);
  V6<F> rhs;
  for (int i = 0; i < 6; ++i) rhs[i] = Wr[i] - bias[i] - agj[i];
  const V6<F> a_base = centroidal_solve6(D, C, k, com, rhs);
  for (int i = 0; i < nv; ++i) {
    out[i] = v[i];
    out[nv + i] = (i < 6) ? a_base[i] : ddq[i - 6];
  }
}

}  // namespace smpc

namespace {

using smpc::Dims;

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
state_derivative_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                        const F* __restrict__ u, const F* __restrict__ active, int n,
                        F* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t nx = D.nq + D.nv, nu = D.nu, nk = D.nk;
  smpc::kino_xdot(D, C, x + i * nx, u + i * nu, active + i * nk, out + i * 2 * (size_t)D.nv);
}

template <class F>
int launch_state_derivative(const int* dims, const void* C, const void* x, const void* u,
                            const void* active, int n, void* out, void* stream) {
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  if (D.nj > smpc::kMaxJ || D.nk > smpc::kMaxK || D.fs > SMPC_MAX_FORCE_SIZE)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  state_derivative_kernel<F><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x), static_cast<const F*>(u),
      static_cast<const F*>(active), n, static_cast<F*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SMPC_ACC(sfx, F)                                                                   \
  int smpc_state_derivative_##sfx(const int* dims, const void* C, const void* x,           \
                                  const void* u, const void* active, int n, void* out,     \
                                  void* stream) {                                          \
    return launch_state_derivative<F>(dims, C, x, u, active, n, out, stream);              \
  }

SMPC_ACC(f32, float)
SMPC_ACC(f64, double)

}  // extern "C"
