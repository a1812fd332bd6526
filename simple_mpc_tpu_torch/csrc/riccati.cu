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
//   L L' = Qs (pivot floored at 1e-30, a NaN pivot propagates),
//   sol = D^-1/2 Qs^-1 D^-1/2 [Qux' | Qu]  (K's columns first, k's last)
//   K = -sol[:, :nx], k = -sol[:, nx]
//   explicit PSD value update as in proxddp.py:430-444 (never the condensed
//   form, which loses positive-semidefiniteness in f32 at contact switches):
//   Vx  = Qx + K'Qu + Qux'k + K'Quu k
//   Vxx = sym(Qxx + Qux'K + K'Qux + K'Quu K)
//
// What bounds it on the card: the recursion is serial in T, and a stage is
// a chain of dependent products 36..90 wide (0.64 MFLOP a stage at nx=36,
// nu=24) with a nu x nu factorization and two triangular solves in the
// middle, so one scenario cannot fill an SM and the pass is latency-bound
// at B=1 and B=128 alike (B blocks on 132 SMs).  A stage's time is the
// length of its dependency chain: block barriers, the factorization's and
// the solves' serial steps, shared-memory round trips, the SM's one pipe for
// shared-memory loads and shuffles, and instruction fetch: the loop over the
// stages runs its whole body once a stage, so code that does not fit the
// instruction cache is fetched anew every stage.  The design (PERF.md §6
// has the phase profiles it rests on):
//   (a) the solves: a right-hand side of [Qux' | Qu] a thread; the forward
//       pass by columns, the vector in registers as a window that slides
//       one place a step, so that one step's code serves every step, L's
//       columns read with 16-byte loads at one address in all lanes (a
//       broadcast); the back pass by rows (the plain version's order) over
//       the thread's own column of sol, each sum of its own length.  The
//       solving warps (1 to ws) run behind the factorization, column by
//       column: warp 0 publishes a count of finished columns in shared
//       memory, which a solve spins on before its step k, so the forward
//       pass overlaps the factorization and only the back pass follows it.
//       Lanes over rows with a __shfl_sync a step took 5,000-18,000 cycles
//       a stage: every warp's shuffles share the pipe;
//   (b) the factorization: the Jacobi-scaled nu x nu Cholesky runs in one
//       warp with a row of the matrix in each lane's registers (two rows a
//       lane for 32 < nu <= 40), right-looking, the row a sliding window
//       too: a column costs one store of its entries, a __syncwarp and a
//       few 16-byte broadcast loads; each lane tracks the diagonal ahead, so
//       the pivot needs no exchange.  A __shfl_sync an entry took 30-45
//       cycles each.  The Jacobi scale, the scaled matrix (into shared
//       memory, loaded into the registers from there) and the scaled
//       right-hand sides are formed before, by all threads, an entry each:
//       in the factorizing warp, unrolled, the matrix's nu^2 divisions were
//       ~1,400 instructions fetched anew every stage, and a loop of them
//       still ~5,400 cycles.  The zero rows past nu skip the division
//       (0 / L[k][k] = 0: it took the division's slow path);
//   (c) the products (VAB, Q, Quu sol, Qux' sol, sol' Quu sol) are register
//       tiles: a thread keeps a 4x4 tile of independent FP32 (FP64) FMA
//       accumulators and reads its operands with 16-byte vector loads from
//       shared memory.  No tensor cores: TF32 is barred by the solver's
//       full-precision rule.  Q is split so that the factorization starts
//       as soon as the control rows [Qux | Quu | Qu] are done: the state
//       rows [Qxx | Qx], read only by the value update, are computed by the
//       warps that neither factor nor solve;
//   (d) a stage's inputs are copied into shared memory with cp.async (16,
//       8 or 4 bytes, as the source's alignment allows) in the layout the
//       products read, so that the products add them in place, each by
//       warps the phase before its use leaves idle: stage t-1's [A B d]
//       while stage t forms Quu sol, its Q control rows while stage t forms
//       Vxx, its Q state rows while stage t-1 forms VAB.  An L2 prefetch one
//       stage ahead measured slower;
//   (e) eight block barriers a stage (8 + 3 nu before).
// Every sum is k-ascending with one FMA a term, every entry is formed as
// the straightforward formulation forms it (L[i][k] = s / L[k][k], y_i =
// s / L[i][i], sol = x / dscale, Vxx = 0.5 (mxy + myx)), so the results do
// not depend on the tiling: the f32 Go2 fixture gate sits at the f32
// rounding margin (ROADMAP, the FMA rule), and a reordered variant of this
// kernel moved it past the gate (PERF.md §6).
// Wider nu (none of the formulations), or a width whose plan exceeds the
// device's shared memory, takes the staged kernel (`staged_pass`): the
// plain version's steps one after another with a block barrier between
// them, a Cholesky column three barriers, a right-hand side a thread, in a
// smaller plan (`riccati_staged_elems`).
// d rides in [A B d] as column oz, so VAB's column oz is Vxx d + Vx = Vx_g
// and Q's column oz is [qx; qu] + AB' Vx_g: the gap folding and [Qx; Qu]
// come out of the same two products.  The control block of [A B d] and of
// Q starts at column (and row) ox = nx rounded up to 4, so that every tile
// starts 16-byte aligned.
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
constexpr int kWarps = kThreads / 32;

// Profiling marks, compiled in only with -DSMPC_RICCATI_PROF (chip_smoke.py
// --phases riccati_phases): threads 0 and 32 of block 0 add the clock64()
// cycles since their previous mark to marks_[n], summed over the stages, and
// leave them in g_marks for smpc_riccati_marks: thread 0's marks 0-12 (the
// phases and warp 0's factorization), thread 32's 13-15 (its solve)
#ifdef SMPC_RICCATI_PROF
__device__ long long g_marks[16];
struct Marks {
  long long sum[16];
  long long last;
};
#define SMPC_MARKS_START \
  Marks marks_ = {};     \
  marks_.last = clock64();
#define SMPC_MARK(n)                                   \
  if ((threadIdx.x & ~32u) == 0 && blockIdx.x == 0) {  \
    const long long now_ = clock64();                  \
    marks_.sum[n] += now_ - marks_.last;               \
    marks_.last = now_;                                \
  }
#define SMPC_MARKS_SAVE                                            \
  if ((threadIdx.x & ~32u) == 0 && blockIdx.x == 0)                \
    for (int q = threadIdx.x ? 13 : 0; q < (threadIdx.x ? 16 : 13); ++q) g_marks[q] = marks_.sum[q];
// the marks passed on to the functions that mark
#define SMPC_MARKS_PARAM , Marks& marks_
#define SMPC_MARKS_ARG , marks_
#else
#define SMPC_MARKS_START
#define SMPC_MARK(n)
#define SMPC_MARKS_SAVE
#define SMPC_MARKS_PARAM
#define SMPC_MARKS_ARG
#endif

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline size_t take(size_t& at, size_t n) {
  const size_t here = at;
  at += (n + 3) & ~static_cast<size_t>(3);
  return here;
}

__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// The factorization's width: nu rounded up to 16, 24, 32 or 40, the tiled
// kernel's instance (the loops over the factor's rows and columns unrolled
// to it), or 0 for wider nu: the staged kernel
__host__ __device__ inline int riccati_nb(int nu) {
  return nu <= 16 ? 16 : nu <= 24 ? 24 : nu <= 32 ? 32 : nu <= 40 ? 40 : 0;
}

// a leading dimension >= n, a multiple of 4 elements, whose rows start 16
// bytes apart modulo 128: lanes that read a row each with 16-byte loads, or a
// column each, spread over the banks
__host__ __device__ inline int spread(int n, int bytes) {
  int ld = r4(n);
  while ((ld * bytes) % 128 != 16) ld += 16 / bytes;
  return ld;
}

// The tiled kernel's shared-memory plan, in elements of the scalar type of
// `bytes` bytes; every region starts on a 4-element boundary, so its 16-byte
// vector loads are aligned.  kernels.py `riccati_smem` mirrors it.
struct Plan {
  int ox, oz, ldv, ldab, ldq, ldsol, ldp, ldl, nl;
  size_t vxx, vx, ab, vab, q, sol, lc, lw, ld, dsc, flag, total;
};

__host__ __device__ inline Plan riccati_plan(int nx, int nu, int bytes) {
  Plan p;
  p.ox = r4(nx);        // first column of B in [A B d], first control row of Q
  p.oz = p.ox + nu;     // the column of d in [A B d], of [Qx; Qu] in Q
  p.ldv = r4(nx);       // Vxx
  p.ldab = r4(p.oz + 1);
  p.ldq = spread(p.oz + 1, bytes);
  p.ldsol = r4(nx + 1);  // sol, Qux' sol
  p.ldp = r4(nx + 2);    // Quu sol with Qu beside it, sol' [Quu sol | Qu]
  // the factor by columns, Lc[k][j] = L[k + j][k], and the scaled matrix by
  // rows, Lw, nl x nl each, zero past nu
  p.nl = riccati_nb(nu);
  p.ldl = spread(p.nl, bytes);
  // Vxx (phase A, written in G), the factor (C-D), Quu sol (E-F)
  const size_t nf = r4(p.nl * p.ldl);
  size_t at = 0;
  p.vxx = take(at, larger(larger(static_cast<size_t>(p.ox) * p.ldv,
                                 static_cast<size_t>(nu) * p.ldp), 2 * nf));
  p.lc = p.vxx;
  p.lw = p.vxx + nf;
  p.vx = take(at, nx);
  p.ab = take(at, static_cast<size_t>(nx) * p.ldab);
  // VAB (A-C), then Qux' sol and sol' [Quu sol | Qu] (F-G)
  p.vab = take(at, larger(static_cast<size_t>(nx) * p.ldab,
                          static_cast<size_t>(p.ox) * (p.ldsol + p.ldp)));
  p.q = take(at, static_cast<size_t>(p.ox + r4(nu)) * p.ldq);
  p.sol = take(at, static_cast<size_t>(nu) * p.ldsol);
  p.ld = take(at, p.nl);
  p.dsc = take(at, p.nl);
  p.flag = take(at, 4);  // an int: columns of the factor published
  p.total = at;
  return p;
}

// The staged kernel's plan, in elements (kernels.py `riccati_smem` mirrors
// it): AB and VAB share their room with the value update's products
__host__ __device__ inline size_t riccati_alias(int nx, int nu) {
  const size_t nz = nx + nu, nr = 1 + nx;
  const size_t ab = 2 * (size_t)nx * nz;           // AB + VAB
  const size_t post = nr * ((size_t)nu + 2 * nx);  // QuuP + QuxtP + PtQP
  return ab > post ? ab : post;
}

__host__ __device__ inline size_t riccati_staged_elems(int nx, int nu) {
  const size_t nz = nx + nu, nr = 1 + nx;
  return nx + (size_t)nx * nx + riccati_alias(nx, nu) + nz * nz + nz + nx +
         nu + (size_t)nu * nu + (size_t)nu * nr;
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// acc[a][c] += sum_k X(k, m0 + a) * Y[k][n0 + c], k ascending, one FMA a
// term (the plain version's order): a 4x4 register tile of X' Y, Y
// row-major in shared memory with the reduction index k along its rows;
// X(k, m) = X[k * ldx + m] (vector loads), or with kXT X[m * ldx + k]
// (scalar loads)
template <typename T, bool kXT>
__device__ __forceinline__ void tile_tn(const T* X, int ldx, const T* Y, int ldy, int K,
                                        int m0, int n0, T acc[4][4]) {
  X += kXT ? static_cast<size_t>(m0) * ldx : m0;
  Y += n0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    T x[4], y[4];
    if constexpr (kXT) {
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = X[static_cast<size_t>(a) * ldx + k];
    } else {
      load4(X + static_cast<size_t>(k) * ldx, x);
    }
    load4(Y + static_cast<size_t>(k) * ldy, y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = x[a] * y[c] + acc[a][c];
  }
}

// cp.async of V elements, 4, 8 or 16 bytes
template <typename T, int V>
__device__ __forceinline__ void cp_async_v(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V * sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(V * sizeof(T))
                 : "memory");
#else
  for (int e = 0; e < V; ++e) dst[e] = src[e];
#endif
}

template <typename T, int V>
__device__ void copy_rows_v(T* dst, int ldd, const T* src, int rows, int cols, int rank,
                            int nthreads) {
  const int nv = cols / V;
  for (int e = rank; e < rows * nv; e += nthreads) {
    const int i = e / nv, j = (e - i * nv) * V;
    cp_async_v<T, V>(dst + static_cast<size_t>(i) * ldd + j, src + static_cast<size_t>(i) * cols + j);
  }
}

// cp.async of a rows x cols row-major block into rows of stride ldd (each
// starting 16-byte aligned), threads rank = 0 .. nthreads - 1, in the widest
// copies of 16, 8 bytes or one element that the source's alignment and the
// row length allow: a copy is one memory instruction, whatever its width
template <typename T>
__device__ __noinline__ void copy_rows(T* dst, int ldd, const T* src, int rows, int cols,
                                       int rank, int nthreads) {
  const size_t at = reinterpret_cast<size_t>(src);
  if (sizeof(T) == 4 && cols % 4 == 0 && at % 16 == 0)
    copy_rows_v<T, 16 / sizeof(T)>(dst, ldd, src, rows, cols, rank, nthreads);
  else if (cols % (8 / sizeof(T)) == 0 && at % 8 == 0)
    copy_rows_v<T, 8 / sizeof(T)>(dst, ldd, src, rows, cols, rank, nthreads);
  else
    copy_rows_v<T, 1>(dst, ldd, src, rows, cols, rank, nthreads);
}

// cp.async of n elements into a column of stride ldd
template <typename T>
__device__ __forceinline__ void copy_col(T* dst, int ldd, const T* src, int n, int rank,
                                         int nthreads) {
  for (int i = rank; i < n; i += nthreads) cp_async_v<T, 1>(dst + static_cast<size_t>(i) * ldd, src + i);
}

// stage bt's [A B d] into AB
template <typename T>
__device__ void copy_ab(const Plan& p, T* AB, int nx, int nu, size_t bt, const T* A,
                        const T* Bm, const T* d, int rank, int nthreads) {
  copy_rows(AB, p.ldab, A + bt * nx * nx, nx, nx, rank, nthreads);
  copy_rows(AB + p.ox, p.ldab, Bm + bt * nx * nu, nx, nu, rank, nthreads);
  copy_col(AB + p.oz, p.ldab, d + bt * nx, nx, rank, nthreads);
}

// stage bt's Q blocks into the control rows of Q, rows ox + i [Qux_i | .
// | Quu_i | qu_i]
template <typename T>
__device__ void copy_q_ctrl(const Plan& p, T* Q, int nx, int nu, size_t bt, const T* qu,
                            const T* Quu, const T* Qux, int rank, int nthreads) {
  T* Qu = Q + static_cast<size_t>(p.ox) * p.ldq;
  copy_rows(Qu, p.ldq, Qux + bt * nu * nx, nu, nx, rank, nthreads);
  copy_rows(Qu + p.ox, p.ldq, Quu + bt * nu * nu, nu, nu, rank, nthreads);
  copy_col(Qu + p.oz, p.ldq, qu + bt * nu, nu, rank, nthreads);
}

// and into the state rows, rows < nx [Qxx | . | qx]
template <typename T>
__device__ void copy_q_state(const Plan& p, T* Q, int nx, size_t bt, const T* qx,
                             const T* Qxx, int rank, int nthreads) {
  copy_rows(Q, p.ldq, Qxx + bt * nx * nx, nx, nx, rank, nthreads);
  copy_col(Q + p.oz, p.ldq, qx + bt * nx, nx, rank, nthreads);
}

// the warps a phase of n tiles leaves idle, from the first, or all of them
__device__ __forceinline__ int idle_from(int n) {
  const int w = (n + 31) / 32;
  return w < kWarps ? w : 0;
}

// the columns of the factor published so far, more than k: spins on the
// count warp 0 leaves in `ready` after each column (counted from `base`)
__device__ __forceinline__ int wait_column(const int* ready, int base, int k) {
  int n;
  while ((n = *reinterpret_cast<const volatile int*>(ready) - base) <= k) {
  }
  __threadfence_block();
  return n;
}

// Phase C, one warp, nu <= NB <= 40: the Cholesky of Qs = D^-1/2 Quu D^-1/2
// + reg I, with the plain version's operations in its order (the same
// divisions, square roots and FMAs, so that the factor, and the whole pass,
// round as they did).  Row lane + 32 r (r < R) of Qs (Lw, phase B') is
// loaded into lane `lane`'s registers a[r][.].  Right-looking, the row held
// as a window that starts at the current column: at column k, a[r][j] =
// S[row][k + j]; every lane also keeps the diagonal ahead, dg[j] = S[k +
// j][k + j], updated with the same FMAs as the row that owns it, so the
// pivot needs no exchange.  At column k each lane divides its entry by
// sqrt(pivot), writes it to row k of Lc (Lc[k][j] = L[k + j][k]), and after
// a __syncwarp reads the whole column back with 16-byte loads at one address
// in all lanes (a broadcast) to update a[i][j] -= L[i][k] L[k + j][k],
// written one place down: the window slides as it updates.  One store, one
// warp barrier and a few loads a column: a __shfl_sync for each entry
// measured ~30-45 cycles apiece (PERF.md §6).  The column loop is not
// unrolled: one column's code serves every column, which keeps the loop
// over the stages in the instruction cache.  Writes Lc and Ld[k] = L[k][k],
// and publishes each column in `ready` for the solves.
template <typename T, int NB>
__device__ void factor_regs(const Plan& p, int nu, T* Lc, const T* Lw, T* Ld, int lane, int* ready,
                            int base SMPC_MARKS_PARAM) {
  constexpr int R = (NB + 31) / 32;
  int row[R];
  T a[R][NB], dg[NB];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = lane + 32 * r;
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += 4) {
      if (row[r] < NB) {
        load4(Lw + static_cast<size_t>(row[r]) * p.ldl + j0, a[r] + j0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[r][j0 + e] = T(0);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) dg[j] = Lw[static_cast<size_t>(j) * (p.ldl + 1)];
#pragma unroll 1
  for (int k = 0; k < nu; ++k) {
    // pivot floor max(s, 1e-30); a NaN pivot propagates as in the twin
    const T lkk = sqrt((dg[0] != dg[0] || dg[0] > T(1e-30)) ? dg[0] : T(1e-30));
    if (lane == 0) Ld[k] = lkk;
    T l[R];
    T* col = Lc + static_cast<size_t>(k) * p.ldl;  // col[j] = L[k + j][k]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = row[r] > k && row[r] < nu ? a[r][0] / lkk : T(0);  // zero rows past nu: 0
      if (row[r] > k && row[r] < NB) col[row[r] - k] = l[r];
    }
    __syncwarp();
    if (lane == 0) {  // publish column k (and Ld[k]) to the solves
      __threadfence_block();
      *reinterpret_cast<volatile int*>(ready) = base + k + 1;
    }
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += 4) {
      T v[4];
      load4(col + j0, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (j == 0) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) a[r][j - 1] = a[r][j] - l[r] * v[e];
        dg[j - 1] = dg[j] - v[e] * v[e];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) a[r][NB - 1] = T(0);
    dg[NB - 1] = T(0);
  }
}

// Phase C, behind the factorization: one right-hand side c of L L' X =
// D^-1/2 [Qux' | Qu] a thread, with the plain version's operations in its
// order, from column c of sol (phase B').  Forward, column by
// column, each column once warp 0 has published it: y_k = b_k / L[k][k],
// then b_i -= L[i][k] y_k for i > k, b held in registers as a window that
// slides one place a step (a step's code serves every step), the column read
// from Lc with 16-byte loads at one address in all lanes (a broadcast); y_k
// goes to sol.  Back, row by row: x_i = (y_i - sum_{k > i} L[k][i] x_k) /
// L[i][i], k ascending, over sol, which ends holding X (phase D divides it
// by dscale).  A back step is the chain of its own sum and a division: a
// register window there took a fixed-length predicated chain and a slide of
// the window a step, ~160 instructions a step for one warp to issue.
// Lanes over rows with a shuffle a step measured slower (every warp's
// shuffles share the SM's shared-memory pipe: PERF.md §6).
template <typename T, int NB>
__device__ void solve_regs(const Plan& p, const T* Lc, const T* Ld, int nu, int c, T* sol,
                           const int* ready, int base SMPC_MARKS_PARAM) {
  T* sc = sol + c;  // sc[i * ldsol]: row i of this right-hand side
  T w[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) w[j] = j < nu ? sc[static_cast<size_t>(j) * p.ldsol] : T(0);
  SMPC_MARK(13);
  int avail = 0;
#pragma unroll 1
  for (int k = 0; k < nu; ++k) {
    if (k >= avail) avail = wait_column(ready, base, k);
    const T y = w[0] / Ld[k];
    sc[static_cast<size_t>(k) * p.ldsol] = y;
    const T* col = Lc + static_cast<size_t>(k) * p.ldl;  // col[j] = L[k + j][k]
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += 4) {
      T l4[4];
      load4(col + j0, l4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e >= 1) w[j0 + e - 1] = w[j0 + e] - l4[e] * y;
    }
    w[NB - 1] = T(0);
  }
  SMPC_MARK(14);
  // back, x_k over y_k in sc; the sum runs over the rows below k alone
#pragma unroll 1
  for (int k = nu - 1; k >= 0; --k) {
    T s = sc[static_cast<size_t>(k) * p.ldsol];
    const T* col = Lc + static_cast<size_t>(k) * p.ldl;  // col[j] = L[k + j][k]
#pragma unroll 4
    for (int j = 1; j < nu - k; ++j) s = s - col[j] * sc[static_cast<size_t>(k + j) * p.ldsol];
    sc[static_cast<size_t>(k) * p.ldsol] = s / Ld[k];
  }
  SMPC_MARK(15);
}

// The staged kernel, for nu > 40 or a width whose tiled plan exceeds the
// device's shared memory: the plain version's steps in its order, one
// after another, a block barrier between them; right-looking Cholesky with
// the column loop serial and the trailing update spread over the threads;
// a right-hand side a thread.  Its plan: riccati_staged_elems.
template <typename T>
__device__ __forceinline__ void staged_pass(T* smem, const T* __restrict__ A,
                                            const T* __restrict__ Bm, const T* __restrict__ d,
                                            const T* __restrict__ qx, const T* __restrict__ qu,
                                            const T* __restrict__ Qxx, const T* __restrict__ Quu,
                                            const T* __restrict__ Qux, const T* __restrict__ Vx_T,
                                            const T* __restrict__ Vxx_T, T reg, T eps, int nT,
                                            int nx, int nu, T* __restrict__ ks,
                                            T* __restrict__ Ks, T* __restrict__ Qus) {
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

// The tiled kernel, nu <= NB <= 40
template <typename T, int NB>
__device__ __forceinline__ void tiled_pass(T* sm, const T* __restrict__ A,
                                           const T* __restrict__ Bm, const T* __restrict__ d,
                                           const T* __restrict__ qx, const T* __restrict__ qu,
                                           const T* __restrict__ Qxx, const T* __restrict__ Quu,
                                           const T* __restrict__ Qux, const T* __restrict__ Vx_T,
                                           const T* __restrict__ Vxx_T, T reg, T eps, int nT,
                                           int nx, int nu, T* __restrict__ ks,
                                           T* __restrict__ Ks, T* __restrict__ Qus) {
  const Plan p = riccati_plan(nx, nu, sizeof(T));
  const int nr = nx + 1;   // right-hand sides: [Qux' | Qu]
  T* Vxx = sm + p.vxx;     // Vxx(i, j) at [j * ldv + i] (symmetric after stage T-1)
  T* Lc = sm + p.lc;       // phases C-D: the factor by columns
  T* Lw = sm + p.lw;       // phase C: the scaled Quu by rows
  T* QuuP = sm + p.vxx;    // phases E-F: [Quu sol | Qu]
  T* Vx = sm + p.vx;
  T* AB = sm + p.ab;       // row i: [A_i . B_i d_i], B at column ox, d at oz
  T* VAB = sm + p.vab;     // phases A-C: Vxx [A B d], Vx_g in column oz
  T* QuxtP = sm + p.vab;   // phases F-G: Qux' sol
  T* PtQP = QuxtP + static_cast<size_t>(p.ox) * p.ldsol;  // F-G: sol' [Quu sol | Qu]
  T* Q = sm + p.q;         // rows < nx: [Qxx . Qx], rows ox + i: [Qux . Quu Qu]
  T* sol = sm + p.sol;     // row i: D^-1/2 [Qux' | Qu] (C), y (D), then [-K_i | -k_i]
  T* Ld = sm + p.ld;       // the factor's diagonal
  T* dsc = sm + p.dsc;     // the Jacobi scale
  int* ready = reinterpret_cast<int*>(sm + p.flag);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  if (nT <= 0) return;

  for (int i = warp; i < nx; i += kWarps)
    for (int j = lane; j < nx; j += 32)
      Vxx[static_cast<size_t>(j) * p.ldv + i] = Vxx_T[(b * nx + i) * nx + j];
  for (int i = tid; i < nx; i += kThreads) Vx[i] = Vx_T[b * nx + i];
  copy_ab(p, AB, nx, nu, b * nT + nT - 1, A, Bm, d, tid, kThreads);
  copy_q_ctrl(p, Q, nx, nu, b * nT + nT - 1, qu, Quu, Qux, tid, kThreads);

  const int ntab = p.ldab / 4;  // column tiles of [A B d] and of Q
  const int nta = (p.ox / 4) * ntab, ntg = (p.ox / 4) * (p.ox / 4);
  // warps that solve, after warp 0; the others form the state rows
  const int ws = (nr + 31) / 32 < kWarps - 2 ? (nr + 31) / 32 : kWarps - 2;
  if (tid == 0) *ready = 0;
  SMPC_MARKS_START
  for (int t = nT - 1; t >= 0; --t) {
    const size_t bt = b * nT + t;
    const int base = (nT - 1 - t) * nu;  // columns published before this stage
    cp_async_wait_all();  // [A B d] and Q's control rows
    __syncthreads();
    SMPC_MARK(0);

    // A. VAB = Vxx [A B d], plus Vx in column oz (gap folding); the warps it
    // leaves idle copy the stage's Q blocks into Q's state rows
    if (warp >= idle_from(nta)) {
      const int w0 = idle_from(nta);
      copy_q_state(p, Q, nx, bt, qx, Qxx, tid - 32 * w0, kThreads - 32 * w0);
    }
    for (int tile = tid; tile < nta; tile += kThreads) {
      const int m0 = 4 * (tile / ntab), n0 = 4 * (tile % ntab);
      T acc[4][4] = {};
      tile_tn<T, false>(Vxx, p.ldv, AB, p.ldab, nx, m0, n0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = m0 + a;
        if (i >= nx) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n0 + c == p.oz) acc[a][c] += Vx[i];
        store4(VAB + static_cast<size_t>(i) * p.ldab + n0, acc[a]);
      }
    }
    __syncthreads();
    SMPC_MARK(1);

    // B. the control rows of Q: [Qux Quu Qu] += B' VAB
    for (int tile = tid; tile < (r4(nu) / 4) * ntab; tile += kThreads) {
      const int m0 = 4 * (tile / ntab), n0 = 4 * (tile % ntab);
      T acc[4][4] = {};
      tile_tn<T, false>(AB + p.ox, p.ldab, VAB, p.ldab, nx, m0, n0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        T* q = Q + static_cast<size_t>(p.ox + m0 + a) * p.ldq + n0;
        T v[4];
        load4(q, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] += acc[a][c];
        store4(q, v);
      }
    }
    cp_async_wait_all();  // Q's state rows
    __syncthreads();
    SMPC_MARK(2);

    // B'. the Jacobi scale dsc, Qs = D^-1/2 Quu D^-1/2 + reg I by rows into
    // Lw (zero past nu, NB x NB) and the right-hand sides D^-1/2 [Qux' | Qu]
    // into sol, every entry of them an element of the loop, every scale
    // formed as dsc[i] is
    {
      const T* Qu = Q + static_cast<size_t>(p.ox) * p.ldq;  // row i: [Qux_i . Quu_i Qu_i]
      for (int i = tid; i < nu; i += kThreads)
        dsc[i] = sqrt(fabs(Qu[static_cast<size_t>(i) * p.ldq + p.ox + i]) + eps);
      for (int e = tid; e < NB * NB + nu * nr; e += kThreads) {
        if (e < NB * NB) {
          const int i = e / NB, j = e - i * NB;
          T v = T(0);
          if (i < nu && j < nu) {
            const T* qi = Qu + static_cast<size_t>(i) * p.ldq;
            const T* qj = Qu + static_cast<size_t>(j) * p.ldq;
            v = qi[p.ox + j] / (sqrt(fabs(qi[p.ox + i]) + eps) * sqrt(fabs(qj[p.ox + j]) + eps));
            if (i == j) v = v + reg;
          }
          Lw[static_cast<size_t>(i) * p.ldl + j] = v;
        } else {
          const int i = (e - NB * NB) / nr, c = e - NB * NB - i * nr;
          const T* qi = Qu + static_cast<size_t>(i) * p.ldq;
          sol[static_cast<size_t>(i) * p.ldsol + c] =
              qi[c < nx ? c : p.oz] / sqrt(fabs(qi[p.ox + i]) + eps);
        }
      }
    }
    __syncthreads();
    SMPC_MARK(12);

    // C. warp 0 factors, publishing each column of L in `ready`; warps 1 to
    // ws solve behind it, column by column, a right-hand side a thread; the
    // others add A' VAB into the state rows [Qxx Qx] (column tiles < ox and
    // the one holding oz) and write Qu out
    if (warp == 0) {
      factor_regs<T, NB>(p, nu, Lc, Lw, Ld, lane, ready, base SMPC_MARKS_ARG);
      SMPC_MARK(10);
    } else if (warp <= ws) {
      for (int c = tid - 32; c < nr; c += 32 * ws)
        solve_regs<T, NB>(p, Lc, Ld, nu, c, sol, ready, base SMPC_MARKS_ARG);
    } else {
      const int w0 = 32 * (ws + 1), nc = p.ox / 4 + 1;
      for (int tile = tid - w0; tile < (p.ox / 4) * nc; tile += kThreads - w0) {
        const int m0 = 4 * (tile / nc), tn = tile % nc;
        const int n0 = tn == nc - 1 ? 4 * (p.oz / 4) : 4 * tn;
        T acc[4][4] = {};
        tile_tn<T, false>(AB, p.ldab, VAB, p.ldab, nx, m0, n0, acc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          T* q = Q + static_cast<size_t>(m0 + a) * p.ldq + n0;
          T v[4];
          load4(q, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] += acc[a][c];
          store4(q, v);
        }
      }
      const T* Qu = Q + static_cast<size_t>(p.ox) * p.ldq + p.oz;
      for (int i = tid - w0; i < nu; i += kThreads - w0) Qus[bt * nu + i] = Qu[i * p.ldq];
    }
    __syncthreads();
    SMPC_MARK(3);

    // D. sol = x / dscale, and the gains -sol out
    for (int e = tid; e < nu * nr; e += kThreads) {
      const int i = e / nr, c = e - i * nr;
      T* si = sol + static_cast<size_t>(i) * p.ldsol + c;
      const T o = *si / dsc[i];
      *si = o;
      if (c < nx)
        Ks[(bt * nu + i) * nx + c] = -o;
      else
        ks[bt * nu + i] = -o;
    }
    __syncthreads();
    SMPC_MARK(4);

    // E. QuuP = [Quu sol | Qu]; the warps it leaves idle copy stage t-1's
    // [A B d] into AB (read last by phase C)
    {
      const T* Quu_t = Q + static_cast<size_t>(p.ox) * p.ldq + p.ox;  // Quu(i, j) at [i ldq + j]
      const int nt = p.ldsol / 4;
      if (t > 0 && warp >= idle_from((r4(nu) / 4) * nt)) {
        const int w0 = idle_from((r4(nu) / 4) * nt);
        copy_ab(p, AB, nx, nu, bt - 1, A, Bm, d, tid - 32 * w0, kThreads - 32 * w0);
      }
      for (int tile = tid; tile < (r4(nu) / 4) * nt; tile += kThreads) {
        const int m0 = 4 * (tile / nt), n0 = 4 * (tile % nt);
        T acc[4][4] = {};
        tile_tn<T, true>(Quu_t, p.ldq, sol, p.ldsol, nu, m0, n0, acc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (m0 + a >= nu) break;
          T* out = QuuP + static_cast<size_t>(m0 + a) * p.ldp + n0;
          if (n0 + 4 <= nr) {
            store4(out, acc[a]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n0 + c < nr) out[c] = acc[a][c];  // column nr holds Qu
          }
        }
      }
      for (int i = tid; i < nu; i += kThreads)
        QuuP[static_cast<size_t>(i) * p.ldp + nr] = Quu_t[static_cast<size_t>(i) * p.ldq + nu];
    }
    __syncthreads();
    SMPC_MARK(5);

    // F. QuxtP = Qux' sol and PtQP = sol[:, :nx]' [Quu sol | Qu], the twin's
    // products
    {
      const int nt = p.ldsol / 4, np = p.ldp / 4, nq = (p.ox / 4) * nt;
      for (int tile = tid; tile < nq + (p.ox / 4) * np; tile += kThreads) {
        const bool qux = tile < nq;
        const int tl = qux ? tile : tile - nq, w = qux ? nt : np;
        const int m0 = 4 * (tl / w), n0 = 4 * (tl % w);
        T acc[4][4] = {};
        if (qux)
          tile_tn<T, false>(Q + static_cast<size_t>(p.ox) * p.ldq, p.ldq, sol, p.ldsol,
                                   nu, m0, n0, acc);
        else
          tile_tn<T, false>(sol, p.ldsol, QuuP, p.ldp, nu, m0, n0, acc);
        T* out = qux ? QuxtP + n0 : PtQP + n0;
        const int ld = qux ? p.ldsol : p.ldp;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (m0 + a >= nx) break;
          store4(out + static_cast<size_t>(m0 + a) * ld, acc[a]);
        }
      }
    }
    __syncthreads();
    SMPC_MARK(6);

    // G. the value function as the twin forms it, Vxx = sym(Qxx - Qux'K -
    // K'Qux + K'Quu K) and Vx = Qx + K'Qu + Qux'k + K'Quu k (K = -sol), in
    // 4x4 blocks read with vector loads (a block and its transpose); the
    // warps it leaves idle copy stage t-1's Q blocks into Q's control rows
    // (read last by F)
    if (t > 0 && warp >= idle_from(ntg)) {
      const int w0 = idle_from(ntg);
      copy_q_ctrl(p, Q, nx, nu, bt - 1, qu, Quu, Qux, tid - 32 * w0, kThreads - 32 * w0);
    }
    for (int tile = tid; tile < ntg; tile += kThreads) {
      const int x0 = 4 * (tile / (p.ox / 4)), y0 = 4 * (tile % (p.ox / 4));
      T qa[4][4], qb[4][4], ua[4][4], ub[4][4], pa[4][4], pb[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load4(Q + static_cast<size_t>(x0 + a) * p.ldq + y0, qa[a]);
        load4(Q + static_cast<size_t>(y0 + a) * p.ldq + x0, qb[a]);
        load4(QuxtP + static_cast<size_t>(x0 + a) * p.ldsol + y0, ua[a]);
        load4(QuxtP + static_cast<size_t>(y0 + a) * p.ldsol + x0, ub[a]);
        load4(PtQP + static_cast<size_t>(x0 + a) * p.ldp + y0, pa[a]);
        load4(PtQP + static_cast<size_t>(y0 + a) * p.ldp + x0, pb[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        T v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // x = x0 + a, y = y0 + c: mxy and myx as the twin sums them
          const T mxy = qa[a][c] - ua[a][c] - ub[c][a] + pa[a][c];
          const T myx = qb[c][a] - ub[c][a] - ua[a][c] + pb[c][a];
          v[c] = T(0.5) * (mxy + myx);
        }
        store4(Vxx + static_cast<size_t>(x0 + a) * p.ldv + y0, v);
      }
    }
    for (int x = tid; x < nx; x += kThreads)
      Vx[x] = Q[static_cast<size_t>(x) * p.ldq + p.oz] - PtQP[static_cast<size_t>(x) * p.ldp + nr] -
              QuxtP[static_cast<size_t>(x) * p.ldsol + nx] + PtQP[static_cast<size_t>(x) * p.ldp + nx];
  }
  SMPC_MARKS_SAVE
}

// NB: riccati_nb(nu), the tiled kernel's instance, or 0: the staged kernel
template <typename T, int NB>
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
  T* sm = reinterpret_cast<T*>(smem_raw);
  if constexpr (NB == 0)
    staged_pass<T>(sm, A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T, Vxx_T, reg, eps, nT, nx, nu, ks, Ks,
                   Qus);
  else
    tiled_pass<T, NB>(sm, A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T, Vxx_T, reg, eps, nT, nx, nu, ks,
                      Ks, Qus);
}

template <typename T, int NB>
int launch_nb(size_t smem, const void* A, const void* Bm, const void* d, const void* qx,
              const void* qu, const void* Qxx, const void* Quu, const void* Qux,
              const void* Vx_T, const void* Vxx_T, double reg, double eps, int nbatch, int nT,
              int nx, int nu, void* ks, void* Ks, void* Qus, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(riccati_backward_kernel<T, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_backward_kernel<T, NB><<<nbatch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(A), static_cast<const T*>(Bm), static_cast<const T*>(d), static_cast<const T*>(qx), static_cast<const T*>(qu), static_cast<const T*>(Qxx), static_cast<const T*>(Quu), static_cast<const T*>(Qux), static_cast<const T*>(Vx_T), static_cast<const T*>(Vxx_T), static_cast<T>(reg), static_cast<T>(eps), nT, nx, nu, static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(Qus));
  return static_cast<int>(cudaGetLastError());
}

// The tiled kernel where nu <= 40 and its plan fits the device's opt-in
// shared memory, else the staged kernel where its plan fits, else an error
template <typename T>
int launch_riccati(const void* A, const void* Bm, const void* d, const void* qx,
                   const void* qu, const void* Qxx, const void* Quu,
                   const void* Qux, const void* Vx_T, const void* Vxx_T,
                   double reg, double eps, int nbatch, int nT, int nx, int nu,
                   void* ks, void* Ks, void* Qus, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = riccati_nb(nu);
  const size_t tiled = nb > 0 ? riccati_plan(nx, nu, sizeof(T)).total * sizeof(T) : 0;
#define SMPC_LAUNCH(NB, SMEM)                                                              \
  launch_nb<T, NB>(SMEM, A, Bm, d, qx, qu, Qxx, Quu, Qux, Vx_T, Vxx_T, reg, eps, nbatch, nT, \
                   nx, nu, ks, Ks, Qus, stream)
  if (nb > 0 && tiled <= static_cast<size_t>(optin)) {
    switch (nb) {
      case 16: return SMPC_LAUNCH(16, tiled);
      case 24: return SMPC_LAUNCH(24, tiled);
      case 32: return SMPC_LAUNCH(32, tiled);
      default: return SMPC_LAUNCH(40, tiled);
    }
  }
  const size_t staged = riccati_staged_elems(nx, nu) * sizeof(T);
  if (staged > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  return SMPC_LAUNCH(0, staged);
#undef SMPC_LAUNCH
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

#ifdef SMPC_RICCATI_PROF
// the profiling marks of the last pass (16 sums of cycles)
int smpc_riccati_marks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)));
}
#endif

}  // extern "C"
