// K6: parallel-in-time Riccati backward pass of the ProxDDP solver.
//
// Replaces simple_mpc_tpu/solver/parallel_riccati.py parallel_backward
// (with _combine / _combine_batched), which the JAX package leaves to XLA as
// a batched Cholesky, a lax.associative_scan of 36x36 solves and a vmapped
// gain recovery.  It computes the same function: the serial value recursion
// rewritten as a suffix composition of per-stage elements
//   e_t = (A, b, C, eta, J):  A - B U^-1 Qux,  d - B U^-1 qu,
//         sym(B U^-1 B'),  -(qx - Qux' U^-1 qu),  sym(Qxx - Qux' U^-1 Qux)
// with U = sym(Quu) + reg I (no Jacobi scaling, unlike K3), and the terminal
// element (0, 0, 0, -Vx_T, Vxx_T).  Composing earlier o later:
//   M  = (I + C1 J2)^-1 [A1 | b1 + C1 eta2 | C1]
//   A12 = A2 M_A,  b12 = A2 M_b + b2,  C12 = sym(A2 M_C A2' + C2)
//   N  = (I + J2 C1)^-1 [eta2 - J2 b1 | J2 A1]
//   eta12 = A1' N_eta + eta1,  J12 = sym(A1' N_J + J1)
// The suffix at t gives Vxx_t = J and Vx_t = -eta; the gains follow from
// the value function at t+1:
//   Vx_g = v1 + S1 d,  Qu = qu + B' Vx_g,  Qux^ = Qux + (B' S1) A,
//   Quu^ = sym(Quu + (B' S1) B + reg I),  [k K] = -Quu^^-1 [Qu Qux^].
// Failures are those of the JAX functions: a Cholesky with a pivot that is
// not positive gives an all-NaN factor (jnp.linalg.cholesky), LU solves use
// partial pivoting (jnp.linalg.solve), so a singular one runs into inf/NaN.
//
// Three kernels, launched in order by one C call:
//   eliminate  one block per (scenario, stage t <= T): the 24x24 Cholesky,
//              the 73 right-hand sides [Qux | qu | B'] one thread each, the
//              element products; block T writes the terminal element.
//   combine    one launch per scan level (ceil(log2(T+1)), 7 at T=100), in
//              Hillis-Steele order between two buffers: block (b, t)
//              composes e_t with e_t+2^k where that partner exists and
//              copies e_t otherwise, so nothing reads past element T.
//   gains      one block per (scenario, stage).
//
// What bounds it on the card: at B=1 the serial K3 is a chain of T dependent
// stages on one SM; here the depth is 7 levels of independent blocks, each a
// combine of two 36x36 LU factorizations and ~1 MFLOP of small products in
// shared memory, so the pass is bound by the latency of those in-block
// chains (about 100 barriers per LU), not by HBM (the elements are 3,960
// scalars a stage) nor by the FP32 rate.  At large B the parallel form does
// about 3x the serial pass's arithmetic and the card is full either way, so
// the serial K3 stays the batched path's kernel.  Everything of a block
// lives in shared memory (combine: 7 n^2 + 3 n scalars, 37 KB f32 and 73 KB
// f64 at n=36, which opts in above 48 KB).  Tensor cores, TMA and splitting
// a combine over several blocks are later work.
//
// Layouts (row-major, contiguous, leading scenario axis b, stage axis t):
//   A (B,T,nx,nx)  Bm (B,T,nx,nu)  d (B,T,nx)  qx (B,T,nx)  qu (B,T,nu)
//   Qxx (B,T,nx,nx)  Quu (B,T,nu,nu)  Qux (B,T,nu,nx)
//   Vx_T (B,nx)  Vxx_T (B,nx,nx)
//   work: 2 element buffers (B,T+1,E), E = 3 nx^2 + 2 nx, element layout
//         [A (nx*nx) | b (nx) | C (nx*nx) | eta (nx) | J (nx*nx)]
//   out: ks (B,T,nu)  Ks (B,T,nu,nx)  Qus (B,T,nu)
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t elem_size(int n) { return 3 * (size_t)n * n + 2 * n; }
__host__ __device__ inline size_t off_b(int n) { return (size_t)n * n; }
__host__ __device__ inline size_t off_C(int n) { return (size_t)n * n + n; }
__host__ __device__ inline size_t off_eta(int n) { return 2 * (size_t)n * n + n; }
__host__ __device__ inline size_t off_J(int n) { return 2 * (size_t)n * n + 2 * n; }

__host__ __device__ inline size_t eliminate_smem_elems(int nx, int nu) {
  const size_t nr = 2 * (size_t)nx + 1;
  return (size_t)nu * nu + nu * nr + 2 * (size_t)nx * nu + (size_t)nx * nx + nu;
}
__host__ __device__ inline size_t combine_smem_elems(int n) {
  return 7 * (size_t)n * n + 3 * (size_t)n;
}
__host__ __device__ inline size_t gains_smem_elems(int nx, int nu) {
  return 2 * (size_t)nx * nx + 2 * (size_t)nx * nu + nx + (size_t)nu * nu +
         (size_t)nu * (nx + 1);
}

// Right-looking Cholesky of the n x n matrix in L (lower triangle read and
// written, upper untouched), in place.  Returns, to every thread, whether a
// pivot was not positive (LAPACK potrf's failure).
template <typename T>
__device__ bool block_cholesky(T* L, int n, int* flag) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (tid == 0) *flag = 0;
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      const T p = L[k * n + k];
      if (!(p > T(0))) *flag = 1;
      L[k * n + k] = sqrt(p);
    }
    __syncthreads();
    for (int i = k + 1 + tid; i < n; i += nth) L[i * n + k] /= L[k * n + k];
    __syncthreads();
    const int m = n - k - 1;
    for (int e = tid; e < m * m; e += nth) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) L[i * n + j] -= L[i * n + k] * L[j * n + k];
    }
    __syncthreads();
  }
  return *flag != 0;
}

// L L' X = X for the n x nc right-hand sides in X (row-major), one column
// per thread.
template <typename T>
__device__ void block_cho_solve(const T* L, int n, T* X, int nc) {
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      T s = X[i * nc + c];
      for (int k = 0; k < i; ++k) s -= L[i * n + k] * X[k * nc + c];
      X[i * nc + c] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      T s = X[i * nc + c];
      for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * X[k * nc + c];
      X[i * nc + c] = s / L[i * n + i];
    }
  }
  __syncthreads();
}

// G X = R by LU with partial pivoting (the first row of largest |pivot|),
// G (n x n) and R (n x nc) in place: R becomes X, G its LU factors.
template <typename T>
__device__ void block_lu_solve(T* G, int n, T* R, int nc, int* piv) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      int p = k;
      T best = fabs(G[k * n + k]);
      for (int i = k + 1; i < n; ++i) {
        const T v = fabs(G[i * n + k]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      *piv = p;
    }
    __syncthreads();
    const int p = *piv;
    if (p != k) {  // uniform across the block
      for (int j = tid; j < n; j += nth) {
        const T g = G[k * n + j];
        G[k * n + j] = G[p * n + j];
        G[p * n + j] = g;
      }
      for (int j = tid; j < nc; j += nth) {
        const T r = R[k * nc + j];
        R[k * nc + j] = R[p * nc + j];
        R[p * nc + j] = r;
      }
      __syncthreads();
    }
    for (int i = k + 1 + tid; i < n; i += nth) G[i * n + k] /= G[k * n + k];
    __syncthreads();
    const int m = n - k - 1;
    for (int e = tid; e < m * m; e += nth) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      G[i * n + j] -= G[i * n + k] * G[k * n + j];
    }
    for (int e = tid; e < m * nc; e += nth) {
      const int i = k + 1 + e / nc, c = e % nc;
      R[i * nc + c] -= G[i * n + k] * R[k * nc + c];
    }
    __syncthreads();
  }
  for (int c = tid; c < nc; c += nth) {
    for (int i = n - 1; i >= 0; --i) {
      T s = R[i * nc + c];
      for (int j = i + 1; j < n; ++j) s -= G[i * n + j] * R[j * nc + c];
      R[i * nc + c] = s / G[i * n + i];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
eliminate_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ d, const T* __restrict__ qx,
                 const T* __restrict__ qu, const T* __restrict__ Qxx,
                 const T* __restrict__ Quu, const T* __restrict__ Qux,
                 const T* __restrict__ Vx_T, const T* __restrict__ Vxx_T, T reg,
                 int nT, int nx, int nu, T* __restrict__ elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n = nx, nr = 2 * nx + 1;  // right-hand sides [Qux | qu | B']
  T* L = smem;             // nu*nu
  T* X = L + nu * nu;      // nu*nr
  T* sB = X + nu * nr;     // nx*nu
  T* sQux = sB + nx * nu;  // nu*nx
  T* Y = sQux + nu * nx;   // nx*nx
  T* squ = Y + nx * nx;    // nu

  const int tid = threadIdx.x, nth = blockDim.x;
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  T* e = elems + (b * (nT + 1) + t) * elem_size(n);
  if (t == nT) {  // terminal element (0, 0, 0, -Vx_T, Vxx_T)
    for (size_t i = tid; i < off_eta(n); i += nth) e[i] = T(0);
    for (int i = tid; i < n; i += nth) e[off_eta(n) + i] = -Vx_T[b * n + i];
    for (int i = tid; i < n * n; i += nth) e[off_J(n) + i] = Vxx_T[b * n * n + i];
    return;
  }
  const size_t bt = b * nT + t;
  const T* At = A + bt * nx * nx;
  const T* Bt = Bm + bt * nx * nu;
  const T* Quut = Quu + bt * nu * nu;
  for (int i = tid; i < nx * nu; i += nth) {
    sB[i] = Bt[i];
    sQux[i] = Qux[bt * nu * nx + i];
  }
  for (int i = tid; i < nu; i += nth) squ[i] = qu[bt * nu + i];
  for (int x = tid; x < nu * nu; x += nth) {  // sym(Quu + reg I)
    const int i = x / nu, j = x % nu;
    L[x] = T(0.5) * (Quut[i * nu + j] + Quut[j * nu + i]) + (i == j ? reg : T(0));
  }
  __syncthreads();
  for (int x = tid; x < nu * nr; x += nth) {
    const int i = x / nr, c = x % nr;
    X[x] = c < nx ? sQux[i * nx + c] : c == nx ? squ[i] : sB[(c - nx - 1) * nu + i];
  }
  const bool bad = block_cholesky(L, nu, &flag);
  block_cho_solve(L, nu, X, nr);
  if (bad) {
    for (int x = tid; x < nu * nr; x += nth) X[x] = T(NAN);
    __syncthreads();
  }

  // A_e, b_e, eta_e; Y = B U^-1 B'
  for (int x = tid; x < nx * nx; x += nth) {
    const int i = x / nx, j = x % nx;
    T s = 0, y = 0;
    for (int a = 0; a < nu; ++a) {
      s += sB[i * nu + a] * X[a * nr + j];
      y += sB[i * nu + a] * X[a * nr + nx + 1 + j];
    }
    e[x] = At[x] - s;
    Y[x] = y;
  }
  for (int i = tid; i < nx; i += nth) {
    T s = 0, h = 0;
    for (int a = 0; a < nu; ++a) {
      s += sB[i * nu + a] * X[a * nr + nx];
      h += X[a * nr + i] * squ[a];
    }
    e[off_b(n) + i] = d[bt * nx + i] - s;
    e[off_eta(n) + i] = -(qx[bt * nx + i] - h);
  }
  __syncthreads();
  for (int x = tid; x < nx * nx; x += nth) {
    const int i = x / nx, j = x % nx;
    e[off_C(n) + x] = T(0.5) * (Y[x] + Y[j * nx + i]);
  }
  __syncthreads();
  // Y = Qxx - Qux' U^-1 Qux
  for (int x = tid; x < nx * nx; x += nth) {
    const int i = x / nx, j = x % nx;
    T s = 0;
    for (int a = 0; a < nu; ++a) s += sQux[a * nx + i] * X[a * nr + j];
    Y[x] = Qxx[bt * nx * nx + x] - s;
  }
  __syncthreads();
  for (int x = tid; x < nx * nx; x += nth) {
    const int i = x / nx, j = x % nx;
    e[off_J(n) + x] = T(0.5) * (Y[x] + Y[j * nx + i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ src, T* __restrict__ dst, int n1, int n,
               int off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int piv;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nn = n * n, nr = 2 * n + 1;
  T* A1 = smem;       // n*n
  T* C1 = A1 + nn;    // n*n
  T* J2 = C1 + nn;    // n*n
  T* A2 = J2 + nn;    // n*n
  T* G = A2 + nn;     // n*n: LU matrix, then scratch
  T* R = G + nn;      // n*nr: right-hand sides, then scratch
  T* b1 = R + n * nr; // n
  T* eta2 = b1 + n;   // n

  const int tid = threadIdx.x, nth = blockDim.x;
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t E = elem_size(n);
  const T* e1 = src + (b * n1 + t) * E;
  T* out = dst + (b * n1 + t) * E;
  if (t + off >= n1) {  // no partner at this level
    for (size_t i = tid; i < E; i += nth) out[i] = e1[i];
    return;
  }
  const T* e2 = src + (b * n1 + t + off) * E;
  for (int x = tid; x < nn; x += nth) {
    A1[x] = e1[x];
    C1[x] = e1[off_C(n) + x];
    J2[x] = e2[off_J(n) + x];
    A2[x] = e2[x];
  }
  for (int i = tid; i < n; i += nth) {
    b1[i] = e1[off_b(n) + i];
    eta2[i] = e2[off_eta(n) + i];
  }
  __syncthreads();

  // M = (I + C1 J2)^-1 [A1 | b1 + C1 eta2 | C1]
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    T s = i == j ? T(1) : T(0);
    for (int k = 0; k < n; ++k) s += C1[i * n + k] * J2[k * n + j];
    G[x] = s;
  }
  for (int x = tid; x < n * nr; x += nth) {
    const int i = x / nr, c = x % nr;
    T v;
    if (c < n) {
      v = A1[i * n + c];
    } else if (c == n) {
      v = b1[i];
      for (int k = 0; k < n; ++k) v += C1[i * n + k] * eta2[k];
    } else {
      v = C1[i * n + (c - n - 1)];
    }
    R[x] = v;
  }
  __syncthreads();
  block_lu_solve(G, n, R, nr, &piv);

  // A12 = A2 M_A, b12 = A2 M_b + b2; G = A2 M_C
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    T s = 0, g = 0;
    for (int k = 0; k < n; ++k) {
      s += A2[i * n + k] * R[k * nr + j];
      g += A2[i * n + k] * R[k * nr + n + 1 + j];
    }
    out[x] = s;
    G[x] = g;
  }
  for (int i = tid; i < n; i += nth) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += A2[i * n + k] * R[k * nr + n];
    out[off_b(n) + i] = s + e2[off_b(n) + i];
  }
  __syncthreads();
  // C12 = sym(G A2' + C2), G A2' + C2 staged in R
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    T s = 0;
    for (int k = 0; k < n; ++k) s += G[i * n + k] * A2[j * n + k];
    R[x] = s + e2[off_C(n) + x];
  }
  __syncthreads();
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    out[off_C(n) + x] = T(0.5) * (R[x] + R[j * n + i]);
  }
  __syncthreads();

  // N = (I + J2 C1)^-1 [eta2 - J2 b1 | J2 A1]
  const int nc = n + 1;
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    T s = i == j ? T(1) : T(0), a = 0;
    for (int k = 0; k < n; ++k) {
      s += J2[i * n + k] * C1[k * n + j];
      a += J2[i * n + k] * A1[k * n + j];
    }
    G[x] = s;
    R[i * nc + 1 + j] = a;
  }
  for (int i = tid; i < n; i += nth) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += J2[i * n + k] * b1[k];
    R[i * nc] = eta2[i] - s;
  }
  __syncthreads();
  block_lu_solve(G, n, R, nc, &piv);

  // eta12 = A1' N_eta + eta1; J12 = sym(A1' N_J + J1), staged in G
  for (int i = tid; i < n; i += nth) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += A1[k * n + i] * R[k * nc];
    out[off_eta(n) + i] = s + e1[off_eta(n) + i];
  }
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    T s = 0;
    for (int k = 0; k < n; ++k) s += A1[k * n + i] * R[k * nc + 1 + j];
    G[x] = s + e1[off_J(n) + x];
  }
  __syncthreads();
  for (int x = tid; x < nn; x += nth) {
    const int i = x / n, j = x % n;
    out[off_J(n) + x] = T(0.5) * (G[x] + G[j * n + i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gains_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ d, const T* __restrict__ qu,
             const T* __restrict__ Quu, const T* __restrict__ Qux,
             const T* __restrict__ elems, T reg, int nT, int nx, int nu,
             T* __restrict__ ks, T* __restrict__ Ks, T* __restrict__ Qus) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n = nx, nc = nx + 1;  // right-hand sides [Qu | Qux^]
  T* S1 = smem;          // nx*nx
  T* sA = S1 + nx * nx;  // nx*nx
  T* sB = sA + nx * nx;  // nx*nu
  T* BtS = sB + nx * nu; // nu*nx
  T* Vxg = BtS + nu * nx;// nx
  T* L = Vxg + nx;       // nu*nu
  T* X = L + nu * nu;    // nu*nc

  const int tid = threadIdx.x, nth = blockDim.x;
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t bt = b * nT + t;
  const T* e = elems + (b * (nT + 1) + t + 1) * elem_size(n);  // suffix at t+1
  for (int x = tid; x < nx * nx; x += nth) {
    S1[x] = e[off_J(n) + x];
    sA[x] = A[bt * nx * nx + x];
  }
  for (int x = tid; x < nx * nu; x += nth) sB[x] = Bm[bt * nx * nu + x];
  __syncthreads();
  for (int i = tid; i < nx; i += nth) {  // Vx_g = v1 + S1 d, v1 = -eta
    T s = 0;
    for (int j = 0; j < nx; ++j) s += S1[i * nx + j] * d[bt * nx + j];
    Vxg[i] = -e[off_eta(n) + i] + s;
  }
  for (int x = tid; x < nu * nx; x += nth) {  // B' S1
    const int a = x / nx, j = x % nx;
    T s = 0;
    for (int i = 0; i < nx; ++i) s += sB[i * nu + a] * S1[i * nx + j];
    BtS[x] = s;
  }
  __syncthreads();
  for (int a = tid; a < nu; a += nth) {  // Qu^ = qu + B' Vx_g
    T s = 0;
    for (int i = 0; i < nx; ++i) s += sB[i * nu + a] * Vxg[i];
    const T v = qu[bt * nu + a] + s;
    X[a * nc] = v;
    Qus[bt * nu + a] = v;
  }
  for (int x = tid; x < nu * nx; x += nth) {  // Qux^ = Qux + (B' S1) A
    const int a = x / nx, j = x % nx;
    T s = 0;
    for (int i = 0; i < nx; ++i) s += BtS[a * nx + i] * sA[i * nx + j];
    X[a * nc + 1 + j] = Qux[bt * nu * nx + x] + s;
  }
  for (int x = tid; x < nu * nu; x += nth) {  // Quu + (B' S1) B + reg I
    const int a = x / nu, c = x % nu;
    T s = 0;
    for (int i = 0; i < nx; ++i) s += BtS[a * nx + i] * sB[i * nu + c];
    L[x] = Quu[bt * nu * nu + x] + s + (a == c ? reg : T(0));
  }
  __syncthreads();
  for (int x = tid; x < nu * nu; x += nth) {  // symmetrize the lower triangle
    const int a = x / nu, c = x % nu;
    if (c < a) L[x] = T(0.5) * (L[x] + L[c * nu + a]);
  }
  __syncthreads();
  const bool bad = block_cholesky(L, nu, &flag);
  block_cho_solve(L, nu, X, nc);
  for (int x = tid; x < nu * nc; x += nth) {
    const int a = x / nc, c = x % nc;
    const T v = bad ? T(NAN) : -X[x];
    if (c == 0) {
      ks[bt * nu + a] = v;
    } else {
      Ks[(bt * nu + a) * nx + (c - 1)] = v;
    }
  }
}

template <typename T>
int launch_parallel_riccati(const void* A, const void* Bm, const void* d,
                            const void* qx, const void* qu, const void* Qxx,
                            const void* Quu, const void* Qux, const void* Vx_T,
                            const void* Vxx_T, double reg, int nbatch, int nT,
                            int nx, int nu, void* work, void* ks, void* Ks,
                            void* Qus, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t s_elim = eliminate_smem_elems(nx, nu) * sizeof(T);
  const size_t s_comb = combine_smem_elems(nx) * sizeof(T);
  const size_t s_gain = gains_smem_elems(nx, nu) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      eliminate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_elim));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s_comb));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gains_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s_gain));
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n1 = nT + 1;
  T* buf[2] = {static_cast<T*>(work),
               static_cast<T*>(work) + (size_t)nbatch * n1 * elem_size(nx)};
  eliminate_kernel<T><<<dim3(n1, nbatch), kThreads, s_elim, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(d), static_cast<const T*>(qx),
      static_cast<const T*>(qu), static_cast<const T*>(Qxx),
      static_cast<const T*>(Quu), static_cast<const T*>(Qux),
      static_cast<const T*>(Vx_T), static_cast<const T*>(Vxx_T),
      static_cast<T>(reg), nT, nx, nu, buf[0]);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int cur = 0;  // the buffer that holds the latest level
  for (int off = 1; off < n1; off *= 2) {
    combine_kernel<T><<<dim3(n1, nbatch), kThreads, s_comb, stream>>>(
        buf[cur], buf[1 - cur], n1, nx, off);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    cur = 1 - cur;
  }
  gains_kernel<T><<<dim3(nT, nbatch), kThreads, s_gain, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(d), static_cast<const T*>(qu),
      static_cast<const T*>(Quu), static_cast<const T*>(Qux), buf[cur],
      static_cast<T>(reg), nT, nx, nu, static_cast<T*>(ks),
      static_cast<T*>(Ks), static_cast<T*>(Qus));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smpc_parallel_riccati_backward_f32(
    const void* A, const void* Bm, const void* d, const void* qx,
    const void* qu, const void* Qxx, const void* Quu, const void* Qux,
    const void* Vx_T, const void* Vxx_T, double reg, int nbatch, int nT,
    int nx, int nu, void* work, void* ks, void* Ks, void* Qus, void* stream) {
  return launch_parallel_riccati<float>(A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T,
                                        Vxx_T, reg, nbatch, nT, nx, nu, work,
                                        ks, Ks, Qus, stream);
}

int smpc_parallel_riccati_backward_f64(
    const void* A, const void* Bm, const void* d, const void* qx,
    const void* qu, const void* Qxx, const void* Quu, const void* Qux,
    const void* Vx_T, const void* Vxx_T, double reg, int nbatch, int nT,
    int nx, int nu, void* work, void* ks, void* Ks, void* Qus, void* stream) {
  return launch_parallel_riccati<double>(A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T,
                                         Vxx_T, reg, nbatch, nT, nx, nu, work,
                                         ks, Ks, Qus, stream);
}

}  // extern "C"
