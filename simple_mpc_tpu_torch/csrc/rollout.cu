// K4: linear rollout of the ProxDDP line search, one block per
// (scenario, step size).
//
// Replaces simple_mpc_tpu/solver/proxddp.py ProxDDPSolver._candidate (the
// lax.scan `step`, vmapped over the alpha ladder and the scenario batch):
//   du_t      = alpha k_t + K_t dx_t
//   dx_{t+1}  = A_t dx_t + B_t du_t + alpha d_t,   dx_0 given
// The Lie integrate of the candidate states and the merit evaluation stay in
// PyTorch.
//
// What bounds it on the card: each step is two mat-vecs (36x36, 36x24) plus
// one 24x36, about 5 KFLOP, and depends on the previous step, so the pass is
// latency-bound; per (scenario, alpha) it streams the stage's A, B, d, k, K
// (about 20 KB a stage in f64) from device memory, and the n_alpha blocks of
// one scenario read the same stage data, which L2 serves after the first.
// The design keeps dx and du in shared memory across the T loop, one thread
// per output row, and launches B * n_alpha independent blocks.
//
// Layouts (row-major, contiguous):
//   A (B,T,nx,nx)  Bm (B,T,nx,nu)  d (B,T,nx)  ks (B,T,nu)  Ks (B,T,nu,nx)
//   dx0 (B,nx)  alphas (n_alpha)
//   out: dxs (B,n_alpha,T+1,nx)  dus (B,n_alpha,T,nu)
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ d, const T* __restrict__ ks,
                      const T* __restrict__ Ks, const T* __restrict__ dx0,
                      const T* __restrict__ alphas, int nT, int nx, int nu,
                      int n_alpha, T* __restrict__ dxs, T* __restrict__ dus) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dx = reinterpret_cast<T*>(smem_raw);  // nx
  T* du = dx + nx;                         // nu
  T* dxn = du + nu;                        // nx

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const size_t b = blockIdx.x;
  const size_t a = blockIdx.y;
  const T alpha = alphas[a];
  T* dxs_o = dxs + (b * n_alpha + a) * (size_t)(nT + 1) * nx;
  T* dus_o = dus + (b * n_alpha + a) * (size_t)nT * nu;

  for (int i = tid; i < nx; i += nth) dx[i] = dx0[b * nx + i];
  __syncthreads();

  for (int t = 0; t < nT; ++t) {
    const size_t bt = b * nT + t;
    const T* At = A + bt * nx * nx;
    const T* Bt = Bm + bt * nx * nu;
    const T* dt = d + bt * nx;
    const T* kt = ks + bt * nu;
    const T* Kt = Ks + bt * nu * nx;
    for (int i = tid; i < nu; i += nth) {
      T s = 0;
      for (int j = 0; j < nx; ++j) s += Kt[i * nx + j] * dx[j];
      const T v = alpha * kt[i] + s;
      du[i] = v;
      dus_o[(size_t)t * nu + i] = v;
    }
    for (int i = tid; i < nx; i += nth) dxs_o[(size_t)t * nx + i] = dx[i];
    __syncthreads();
    for (int i = tid; i < nx; i += nth) {
      T sa = 0, sb = 0;
      for (int j = 0; j < nx; ++j) sa += At[i * nx + j] * dx[j];
      for (int j = 0; j < nu; ++j) sb += Bt[i * nu + j] * du[j];
      dxn[i] = sa + sb + alpha * dt[i];
    }
    __syncthreads();
    for (int i = tid; i < nx; i += nth) dx[i] = dxn[i];
    __syncthreads();
  }
  for (int i = tid; i < nx; i += nth) dxs_o[(size_t)nT * nx + i] = dx[i];
}

template <typename T>
int launch_rollout(const void* A, const void* Bm, const void* d, const void* ks,
                   const void* Ks, const void* dx0, const void* alphas,
                   int nbatch, int n_alpha, int nT, int nx, int nu, void* dxs,
                   void* dus, void* stream) {
  const size_t smem = (2 * (size_t)nx + nu) * sizeof(T);
  const dim3 grid(nbatch, n_alpha);
  linear_rollout_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(d), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(dx0),
      static_cast<const T*>(alphas), nT, nx, nu, n_alpha,
      static_cast<T*>(dxs), static_cast<T*>(dus));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smpc_linear_rollout_f32(const void* A, const void* Bm, const void* d,
                            const void* ks, const void* Ks, const void* dx0,
                            const void* alphas, int nbatch, int n_alpha, int nT,
                            int nx, int nu, void* dxs, void* dus, void* stream) {
  return launch_rollout<float>(A, Bm, d, ks, Ks, dx0, alphas, nbatch, n_alpha,
                               nT, nx, nu, dxs, dus, stream);
}

int smpc_linear_rollout_f64(const void* A, const void* Bm, const void* d,
                            const void* ks, const void* Ks, const void* dx0,
                            const void* alphas, int nbatch, int n_alpha, int nT,
                            int nx, int nu, void* dxs, void* dus, void* stream) {
  return launch_rollout<double>(A, Bm, d, ks, Ks, dx0, alphas, nbatch, n_alpha,
                                nT, nx, nu, dxs, dus, stream);
}

}  // extern "C"
