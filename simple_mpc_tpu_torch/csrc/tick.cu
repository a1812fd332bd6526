// K9: the per-tick bookkeeping of the fused MPC tick, one block per scenario.
//
// Replaces the arithmetic of simple_mpc_tpu/mpc/fused.py FusedMPC._step
// before the solve (183-246), with _queue_tick (156-170) and
// foot_trajectory.sample_swing (48):
//   * the measured-state FK of the base, the feet and the "<foot>_ref"
//     frames (stage.cuh, primal);
//   * walking = (now == WALKING) | (support of the last stage < nk);
//   * the takeoff and land event queues: append from the rotated plan's
//     tail edge (before the decrement), decrement (standing: only events
//     inside the horizon), pop a negative head; exact int32 semantics with
//     the EMPTY sentinel;
//   * land_head, the Raibert footstep, the swing endpoints p_init/p_final;
//   * the Bezier swing references of every (stage, foot) and com_ref.
// The rolls of the stage parameters, pools and plan, write_references and
// the warm-start shift are data movement and stay torch copies.
//
// What bounds it on the card: nothing but latency; a block does one FK
// (~13 joints) and T * nk = 400 Bezier samples.  Thread 0 does the serial
// part (FK, queues, footsteps) and the block's threads the samples, so a
// tick's bookkeeping is one launch instead of the ~300 small launches of
// its torch twin.
//
// Layouts (row-major, contiguous; ints are int32):
//   x (B,nx)  active_last (B,nk)  now (B)  plan (B,L,nk)
//   takeoff, land (B,nk,qmax)  p_init, p_final (B,nk,3)  vbase (B,6)  com0_z (B)
//   out: walking (B)  takeoff_o, land_o (B,nk,qmax)  p_init_o, p_final_o (B,nk,3)
//        refs (B,T,nk,3)  com_ref (B,3)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "stage.cuh"

namespace {

using smpc::Dims;

constexpr int kTickThreads = 128;
constexpr int kMaxQueue = 16;
constexpr int kWalking = 0;

__device__ void queue_tick(int* q, int qmax, bool walking, int nT, bool append,
                           int append_val, int empty) {
  bool dec[kMaxQueue];
  int n_valid = 0;
  for (int i = 0; i < qmax; ++i) {
    dec[i] = walking || q[i] < nT;
    n_valid += q[i] < empty / 2;
  }
  if (append && n_valid < qmax) q[n_valid] = append_val;
  for (int i = 0; i < qmax; ++i)
    if (q[i] < empty / 2 && dec[i]) q[i] -= 1;
  if (q[0] < 0) {
    for (int i = 0; i + 1 < qmax; ++i) q[i] = q[i + 1];
    q[qmax - 1] = empty;
  }
}

// sample t of the swing Bezier counting down from the landing time
template <class F>
__device__ void swing_sample(const F* pi, const F* pf, F apex, int land_head, int T_fly,
                             int t, F* out) {
  const F binom[9] = {1, 8, 28, 56, 70, 56, 28, 8, 1};
  const F tt = F(land_head) - F(t);
  F s = (F(T_fly) - tt) / F(T_fly);
  s = s < F(0) ? F(0) : (s > F(1) ? F(1) : s);
  F mid[3];
  for (int c = 0; c < 3; ++c) mid[c] = F(0.75) * pi[c] + F(0.25) * pf[c];
  mid[2] = mid[2] + apex;
  F curve[3] = {0, 0, 0};
  for (int i = 0; i < 9; ++i) {
    const F bi = binom[i] * smpc::mpow(s, F(i)) * smpc::mpow(F(1) - s, F(8 - i));
    const F* p = i < 4 ? pi : (i == 4 ? mid : pf);
    for (int c = 0; c < 3; ++c) curve[c] += bi * p[c];
  }
  for (int c = 0; c < 3; ++c) {
    F r = tt < F(0) ? pf[c] : curve[c];
    out[c] = tt > F(T_fly) ? pi[c] : r;
  }
}

template <class F>
__global__ void __launch_bounds__(kTickThreads)
tick_refs_kernel(Dims D, const F* __restrict__ C, const F* __restrict__ x,
                 const F* __restrict__ active_last, const int* __restrict__ now,
                 const F* __restrict__ plan, const int* __restrict__ takeoff,
                 const int* __restrict__ land, const F* __restrict__ p_init,
                 const F* __restrict__ p_final, const F* __restrict__ vbase,
                 const F* __restrict__ com0_z, int nT, int L, int qmax, int empty,
                 int T_fly, F step_time, F apex, int* __restrict__ walking_o,
                 int* __restrict__ takeoff_o, int* __restrict__ land_o,
                 F* __restrict__ p_init_o, F* __restrict__ p_final_o,
                 F* __restrict__ refs, F* __restrict__ com_ref) {
  __shared__ F s_pi[3 * smpc::kMaxK], s_pf[3 * smpc::kMaxK];
  __shared__ int s_head[smpc::kMaxK];
  const int nk = D.nk, nx = D.nq + D.nv;
  const size_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    F support = active_last[b * nk];
    for (int k = 1; k < nk; ++k) support += active_last[b * nk + k];
    const bool walking = now[b] == kWalking || support < F(nk);
    walking_o[b] = walking;

    smpc::Kin<F> kin;
    smpc::fk(D, C, x + b * nx, kin);
    const smpc::V3<F> base_p = smpc::frame_pos(D, C, kin, 2 * nk);
    const F* vb = vbase + b * 6;
    const F* tail_row = plan + (b * L + (walking ? 0 : L - 1)) * nk;
    const F* prev_row = plan + (b * L + (walking || L < 2 ? L - 1 : L - 2)) * nk;
    for (int k = 0; k < nk; ++k) {
      const bool tail = tail_row[k] > F(0.5), prev = prev_row[k] > F(0.5);
      int q[kMaxQueue];
      const size_t row = (b * nk + k) * qmax;
      for (int i = 0; i < qmax; ++i) q[i] = takeoff[row + i];
      queue_tick(q, qmax, walking, nT, walking && !tail && prev, L + nT, empty);
      for (int i = 0; i < qmax; ++i) takeoff_o[row + i] = q[i];
      for (int i = 0; i < qmax; ++i) q[i] = land[row + i];
      queue_tick(q, qmax, walking, nT, walking && tail && !prev, L + nT, empty);
      for (int i = 0; i < qmax; ++i) land_o[row + i] = q[i];

      const int head = q[0] < empty / 2 ? q[0] : -1;
      s_head[k] = head;
      const bool update = head >= T_fly;
      const smpc::V3<F> foot_p = smpc::frame_pos(D, C, kin, k);
      const smpc::V3<F> ref_p = smpc::frame_pos(D, C, kin, nk + k);
      // Raibert heuristic footstep (mpc.cpp:291-299)
      const F twist[2] = {-(ref_p[1] - base_p[1]), ref_p[0] - base_p[0]};
      for (int c = 0; c < 3; ++c) {
        const F nxt = c < 2 ? ref_p[c] + (vb[c] + vb[5] * twist[c]) * step_time : foot_p[2];
        const F pi = update ? foot_p[c] : p_init[(b * nk + k) * 3 + c];
        const F pf = update ? nxt : p_final[(b * nk + k) * 3 + c];
        s_pi[3 * k + c] = pi;
        s_pf[3 * k + c] = pf;
        p_init_o[(b * nk + k) * 3 + c] = pi;
        p_final_o[(b * nk + k) * 3 + c] = pf;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nT * nk; idx += blockDim.x) {
    const int t = idx / nk, k = idx % nk;
    swing_sample(s_pi + 3 * k, s_pf + 3 * k, apex, s_head[k], T_fly, t,
                 refs + ((b * nT + t) * nk + k) * 3);
  }
  if (threadIdx.x == 0) {
    F sum[3] = {0, 0, 0};
    for (int k = 0; k < nk; ++k) {
      F r[3];
      swing_sample(s_pi + 3 * k, s_pf + 3 * k, apex, s_head[k], T_fly, nT - 1, r);
      for (int c = 0; c < 3; ++c) sum[c] += r[c];
    }
    for (int c = 0; c < 3; ++c) com_ref[b * 3 + c] = sum[c] / F(nk);
    com_ref[b * 3 + 2] = com_ref[b * 3 + 2] + com0_z[b];
  }
}

template <class F>
int launch_tick(const int* dims, const void* C, const void* x, const void* active_last,
                const void* now, const void* plan, const void* takeoff, const void* land,
                const void* p_init, const void* p_final, const void* vbase,
                const void* com0_z, int nbatch, int nT, int L, int qmax, int empty,
                int T_fly, double step_time, double apex, void* walking_o,
                void* takeoff_o, void* land_o, void* p_init_o, void* p_final_o,
                void* refs, void* com_ref, void* stream) {
  if (qmax > kMaxQueue) return static_cast<int>(cudaErrorInvalidValue);
  Dims D;
  std::memcpy(&D, dims, sizeof(Dims));
  tick_refs_kernel<F><<<nbatch, kTickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, static_cast<const F*>(C), static_cast<const F*>(x),
      static_cast<const F*>(active_last), static_cast<const int*>(now),
      static_cast<const F*>(plan), static_cast<const int*>(takeoff),
      static_cast<const int*>(land), static_cast<const F*>(p_init),
      static_cast<const F*>(p_final), static_cast<const F*>(vbase),
      static_cast<const F*>(com0_z), nT, L, qmax, empty, T_fly, F(step_time), F(apex),
      static_cast<int*>(walking_o), static_cast<int*>(takeoff_o),
      static_cast<int*>(land_o), static_cast<F*>(p_init_o), static_cast<F*>(p_final_o),
      static_cast<F*>(refs), static_cast<F*>(com_ref));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define SMPC_TICK(sfx, F)                                                              \
  int smpc_tick_refs_##sfx(                                                            \
      const int* dims, const void* C, const void* x, const void* active_last,          \
      const void* now, const void* plan, const void* takeoff, const void* land,        \
      const void* p_init, const void* p_final, const void* vbase, const void* com0_z,  \
      int nbatch, int nT, int L, int qmax, int empty, int T_fly, double step_time,     \
      double apex, void* walking_o, void* takeoff_o, void* land_o, void* p_init_o,     \
      void* p_final_o, void* refs, void* com_ref, void* stream) {                      \
    return launch_tick<F>(dims, C, x, active_last, now, plan, takeoff, land, p_init,   \
                          p_final, vbase, com0_z, nbatch, nT, L, qmax, empty, T_fly,   \
                          step_time, apex, walking_o, takeoff_o, land_o, p_init_o,     \
                          p_final_o, refs, com_ref, stream);                           \
  }

SMPC_TICK(f32, float)
SMPC_TICK(f64, double)

}  // extern "C"
