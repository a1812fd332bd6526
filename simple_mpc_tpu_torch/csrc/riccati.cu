// K3: serial Riccati backward pass of the ProxDDP solver, one block per
// scenario.
//
// Replaces simple_mpc_tpu/solver/proxddp.py ProxDDPSolver._backward (the
// lax.scan `step`) together with ops/soa_dyn.py chol_unrolled /
// chol_solve_unrolled, which the JAX package leaves to XLA as a scan of
// small fused matrix products.
//
// Per stage t = T-1 .. 0, for one scenario:
//   AB = [A B], Vx_g = Vx + Vxx d, VAB = Vxx AB, H = AB' VAB, gq = AB' Vx_g
//   Q = [Qxx Qux'; Qux Quu] + H, [Qx; Qu] = [qx; qu] + gq
//   dscale = sqrt(|diag Quu| + eps), Qs = D^-1/2 Quu D^-1/2 + reg I
//   L L' = Qs (pivot floored at 1e-30), sol = D^-1/2 Qs^-1 D^-1/2 [Qu Qux]
//   k = -sol[:, 0], K = -sol[:, 1:]
//   explicit PSD value update as in proxddp.py:430-444 (never the condensed
//   form, which loses positive-semidefiniteness in f32 at contact switches):
//   Vx  = Qx + K'Qu + Qux'k + K'Quu k
//   Vxx = sym(Qxx + Qux'K + K'Qux + K'Quu K)
//
// What bounds it on the card: the recursion is serial in T and each stage is
// a chain of dependent 36..60-wide products (about 0.5 MFLOP a stage), so
// one scenario cannot fill an SM; the whole pass is latency-bound, not
// bandwidth-bound (a stage reads ~30 KB).  The design keeps the value
// function (Vx, Vxx) and every per-stage intermediate in shared memory
// across the T loop, so nothing but the stage's inputs and the gains touches
// device memory, and runs the B scenarios as B independent blocks.  The
// 24x24 Cholesky is right-looking with the column loop serial and the
// trailing update spread over the threads; the 37 right-hand sides are
// solved one per thread.  Tensor cores, TMA and several blocks per scenario
// are left for later work.
//
// Layouts (row-major, contiguous, leading scenario axis b, stage axis t):
//   A (B,T,nx,nx)  Bm (B,T,nx,nu)  d (B,T,nx)  qx (B,T,nx)  qu (B,T,nu)
//   Qxx (B,T,nx,nx)  Quu (B,T,nu,nu)  Qux (B,T,nu,nx)
//   Vx_T (B,nx)  Vxx_T (B,nx,nx)
//   out: ks (B,T,nu)  Ks (B,T,nu,nx)  Qus (B,T,nu)
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t riccati_alias(int nx, int nu) {
  const size_t nz = nx + nu, nr = 1 + nx;
  const size_t ab = 2 * (size_t)nx * nz;           // AB + VAB
  const size_t post = nr * ((size_t)nu + 2 * nx);  // QuuP + QuxtP + PtQP
  return ab > post ? ab : post;
}

__host__ __device__ inline size_t riccati_smem_elems(int nx, int nu) {
  const size_t nz = nx + nu, nr = 1 + nx;
  return nx + (size_t)nx * nx + riccati_alias(nx, nu) + nz * nz + nz + nx +
         nu + (size_t)nu * nu + (size_t)nu * nr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ d, const T* __restrict__ qx,
                        const T* __restrict__ qu, const T* __restrict__ Qxx,
                        const T* __restrict__ Quu, const T* __restrict__ Qux,
                        const T* __restrict__ Vx_T, const T* __restrict__ Vxx_T,
                        T reg, T eps, int nT, int nx, int nu,
                        T* __restrict__ ks, T* __restrict__ Ks,
                        T* __restrict__ Qus) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nz = nx + nu;  // [dx; du] width
  const int nr = 1 + nx;   // right-hand sides: [Qu | Qux]
  T* Vx = smem;                              // nx
  T* Vxx = Vx + nx;                          // nx*nx
  T* AB = Vxx + nx * nx;                     // nx*nz, row i = [A_i B_i]
  T* VAB = AB + nx * nz;                     // nx*nz
  T* Q = AB + riccati_alias(nx, nu);         // nz*nz
  T* Qv = Q + nz * nz;                       // nz: [Qx; Qu]
  T* Vxg = Qv + nz;                          // nx
  T* dsc = Vxg + nx;                         // nu
  T* Ls = dsc + nu;                          // nu*nu
  T* sol = Ls + nu * nu;                     // nu*nr
  // after Q is assembled AB/VAB are dead; the value update reuses them
  T* QuuP = AB;                              // nu*nr:  Quu sol
  T* QuxtP = QuuP + nu * nr;                 // nx*nr:  Qux' sol
  T* PtQP = QuxtP + nx * nr;                 // nx*nr:  (sol' Quu sol)[1:, :]

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const size_t b = blockIdx.x;

  for (int e = tid; e < nx; e += nth) Vx[e] = Vx_T[b * nx + e];
  for (int e = tid; e < nx * nx; e += nth) Vxx[e] = Vxx_T[b * nx * nx + e];
  __syncthreads();

  for (int t = nT - 1; t >= 0; --t) {
    const size_t bt = b * nT + t;
    const T* At = A + bt * nx * nx;
    const T* Bt = Bm + bt * nx * nu;
    const T* dt = d + bt * nx;
    const T* qxt = qx + bt * nx;
    const T* qut = qu + bt * nu;
    const T* Qxxt = Qxx + bt * nx * nx;
    const T* Quut = Quu + bt * nu * nu;
    const T* Quxt = Qux + bt * nu * nx;

    // 1. AB = [A B]; gap folding Vx_g = Vx + Vxx d
    for (int e = tid; e < nx * nz; e += nth) {
      const int i = e / nz, c = e % nz;
      AB[e] = c < nx ? At[i * nx + c] : Bt[i * nu + (c - nx)];
    }
    for (int i = tid; i < nx; i += nth) {
      T s = 0;
      for (int j = 0; j < nx; ++j) s += Vxx[i * nx + j] * dt[j];
      Vxg[i] = Vx[i] + s;
    }
    __syncthreads();

    // 2. VAB = Vxx AB
    for (int e = tid; e < nx * nz; e += nth) {
      const int i = e / nz, c = e % nz;
      T s = 0;
      for (int j = 0; j < nx; ++j) s += Vxx[i * nx + j] * AB[j * nz + c];
      VAB[e] = s;
    }
    __syncthreads();

    // 3. Q = stage + AB' VAB, Qv = [qx; qu] + AB' Vx_g
    for (int e = tid; e < nz * nz; e += nth) {
      const int a = e / nz, c = e % nz;
      T s = 0;
      for (int i = 0; i < nx; ++i) s += AB[i * nz + a] * VAB[i * nz + c];
      T st;
      if (a < nx && c < nx) {
        st = Qxxt[a * nx + c];
      } else if (a >= nx && c >= nx) {
        st = Quut[(a - nx) * nu + (c - nx)];
      } else if (a >= nx) {
        st = Quxt[(a - nx) * nx + c];
      } else {
        st = Quxt[(c - nx) * nx + a];
      }
      Q[e] = st + s;
    }
    for (int a = tid; a < nz; a += nth) {
      T s = 0;
      for (int i = 0; i < nx; ++i) s += AB[i * nz + a] * Vxg[i];
      Qv[a] = (a < nx ? qxt[a] : qut[a - nx]) + s;
    }
    __syncthreads();

    // 4. Jacobi scaling: Qs = D^-1/2 Quu D^-1/2 + reg I, rhs = D^-1/2 [Qu Qux]
    for (int i = tid; i < nu; i += nth)
      dsc[i] = sqrt(fabs(Q[(nx + i) * nz + nx + i]) + eps);
    __syncthreads();
    for (int e = tid; e < nu * nu; e += nth) {
      const int i = e / nu, j = e % nu;
      T v = Q[(nx + i) * nz + nx + j] / (dsc[i] * dsc[j]);
      if (i == j) v += reg;
      Ls[e] = v;
    }
    for (int e = tid; e < nu * nr; e += nth) {
      const int i = e / nr, c = e % nr;
      const T v = c == 0 ? Qv[nx + i] : Q[(nx + i) * nz + (c - 1)];
      sol[e] = v / dsc[i];
    }
    __syncthreads();

    // 5. right-looking Cholesky of Qs, lower triangle in place
    for (int k = 0; k < nu; ++k) {
      if (tid == 0) {
        const T p = Ls[k * nu + k];
        // pivot floor max(s, 1e-30); a NaN pivot propagates as in the twin
        Ls[k * nu + k] = sqrt((p != p || p > T(1e-30)) ? p : T(1e-30));
      }
      __syncthreads();
      for (int i = k + 1 + tid; i < nu; i += nth) Ls[i * nu + k] /= Ls[k * nu + k];
      __syncthreads();
      const int m = nu - k - 1;
      for (int e = tid; e < m * m; e += nth) {
        const int i = k + 1 + e / m, j = k + 1 + e % m;
        if (j <= i) Ls[i * nu + j] -= Ls[i * nu + k] * Ls[j * nu + k];
      }
      __syncthreads();
    }

    // 6. L L' X = rhs, one right-hand side per thread; then unscale
    for (int c = tid; c < nr; c += nth) {
      for (int i = 0; i < nu; ++i) {
        T s = sol[i * nr + c];
        for (int k = 0; k < i; ++k) s -= Ls[i * nu + k] * sol[k * nr + c];
        sol[i * nr + c] = s / Ls[i * nu + i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        T s = sol[i * nr + c];
        for (int k = i + 1; k < nu; ++k) s -= Ls[k * nu + i] * sol[k * nr + c];
        sol[i * nr + c] = s / Ls[i * nu + i];
      }
      for (int i = 0; i < nu; ++i) sol[i * nr + c] /= dsc[i];
    }
    __syncthreads();

    // 7. gains and the stage's Qu (dual residual)
    T* kst = ks + bt * nu;
    T* Kst = Ks + bt * nu * nx;
    for (int e = tid; e < nu * nr; e += nth) {
      const int i = e / nr, c = e % nr;
      if (c == 0) {
        kst[i] = -sol[e];
      } else {
        Kst[i * nx + (c - 1)] = -sol[e];
      }
    }
    for (int i = tid; i < nu; i += nth) Qus[bt * nu + i] = Qv[nx + i];

    // 8. explicit PSD value update
    for (int e = tid; e < nu * nr; e += nth) {
      const int i = e / nr, c = e % nr;
      T s = 0;
      for (int j = 0; j < nu; ++j) s += Q[(nx + i) * nz + nx + j] * sol[j * nr + c];
      QuuP[e] = s;
    }
    for (int e = tid; e < nx * nr; e += nth) {
      const int x = e / nr, c = e % nr;
      T s = 0;
      for (int i = 0; i < nu; ++i) s += Q[(nx + i) * nz + x] * sol[i * nr + c];
      QuxtP[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < nx * nr; e += nth) {
      const int x = e / nr, c = e % nr;
      T s = 0;
      for (int i = 0; i < nu; ++i) s += sol[i * nr + 1 + x] * QuuP[i * nr + c];
      PtQP[e] = s;
    }
    __syncthreads();
    for (int x = tid; x < nx; x += nth) {
      T s = 0;
      for (int i = 0; i < nu; ++i) s += sol[i * nr + 1 + x] * Qv[nx + i];
      Vx[x] = Qv[x] - s - QuxtP[x * nr] + PtQP[x * nr];
    }
    for (int e = tid; e < nx * nx; e += nth) {
      const int x = e / nx, y = e % nx;
      const T mxy = Q[x * nz + y] - QuxtP[x * nr + 1 + y] - QuxtP[y * nr + 1 + x] +
                    PtQP[x * nr + 1 + y];
      const T myx = Q[y * nz + x] - QuxtP[y * nr + 1 + x] - QuxtP[x * nr + 1 + y] +
                    PtQP[y * nr + 1 + x];
      Vxx[e] = T(0.5) * (mxy + myx);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_riccati(const void* A, const void* Bm, const void* d, const void* qx,
                   const void* qu, const void* Qxx, const void* Quu,
                   const void* Qux, const void* Vx_T, const void* Vxx_T,
                   double reg, double eps, int nbatch, int nT, int nx, int nu,
                   void* ks, void* Ks, void* Qus, void* stream) {
  const size_t smem = riccati_smem_elems(nx, nu) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      riccati_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_backward_kernel<T><<<nbatch, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(d), static_cast<const T*>(qx),
      static_cast<const T*>(qu), static_cast<const T*>(Qxx),
      static_cast<const T*>(Quu), static_cast<const T*>(Qux),
      static_cast<const T*>(Vx_T), static_cast<const T*>(Vxx_T),
      static_cast<T>(reg), static_cast<T>(eps), nT, nx, nu,
      static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(Qus));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smpc_riccati_backward_f32(const void* A, const void* Bm, const void* d,
                              const void* qx, const void* qu, const void* Qxx,
                              const void* Quu, const void* Qux,
                              const void* Vx_T, const void* Vxx_T, double reg,
                              double eps, int nbatch, int nT, int nx, int nu,
                              void* ks, void* Ks, void* Qus, void* stream) {
  return launch_riccati<float>(A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T, Vxx_T,
                               reg, eps, nbatch, nT, nx, nu, ks, Ks, Qus,
                               stream);
}

int smpc_riccati_backward_f64(const void* A, const void* Bm, const void* d,
                              const void* qx, const void* qu, const void* Qxx,
                              const void* Quu, const void* Qux,
                              const void* Vx_T, const void* Vxx_T, double reg,
                              double eps, int nbatch, int nT, int nx, int nu,
                              void* ks, void* Ks, void* Qus, void* stream) {
  return launch_riccati<double>(A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T, Vxx_T,
                                reg, eps, nbatch, nT, nx, nu, ks, Ks, Qus,
                                stream);
}

}  // extern "C"
