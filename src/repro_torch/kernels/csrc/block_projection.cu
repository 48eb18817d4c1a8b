// Hand-written CUDA kernels for the projection family's worker update,
// for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_projection.py:
//
//   apc_gather       (repro.kernels.block_projection:apc_gather)
//       U[w, i, l] = sum_j (X̄[i, j] − X[w, i, j]) · A[w, l, j]
//   apc_scatter      (repro.kernels.block_projection:apc_scatter)
//       Y[w, i, j] = X + γ·((X̄ − X) − sum_l U[w, i, l] · B[w, j, l])
//   cimmino_gather   (repro.kernels.block_projection:cimmino_gather)
//       U[w, i, l] = sum_j X̄[i, j] · A[w, l, j]
//   cimmino_scatter  (repro.kernels.block_projection:cimmino_scatter)
//       R[w, i, j] = sum_l V[w, i, l] · B[w, j, l]
//
// and, over the compressed support of a sparse system (vals (m, p, w) on
// the global columns cols (m, w), Bvals (m, w, p)), the three kernels the
// reference aliases to the dense ones over a (p, w) tile:
//
//   sparse_gather          (repro.kernels.block_projection:sparse_gather)
//       U[w, i, l] = sum_c (X̄[i, cols[w, c]] − X[w, i, cols[w, c]])
//                          · vals[w, l, c]
//   sparse_cimmino_gather  (...:sparse_cimmino_gather)
//       U[w, i, l] = sum_c X̄[i, cols[w, c]] · vals[w, l, c]
//   sparse_scatter         (...:sparse_scatter)
//       C[w, i, c] = sum_l U[w, i, l] · Bvals[w, c, l], stored at column
//       cols[w, c] of a per-worker (m, k, n) output: APC form
//       Y = X + γ((X̄ − X) − C), Cimmino form R = C.
//
// for all m workers w in ONE launch each: A (m, p, n) and B (m, n, p)
// row-major and contiguous; X (m, k, n), X̄ (k, n), U and V (m, k, p), Y
// and R (m, k, n) addressed through their worker/row strides with a unit
// stride along the last axis.  The kernels take strides rather than
// copying: solve_many holds its iterate as (k, m, n) and its right-hand
// sides as (k, m, p) and hands the kernels the (m, k, .) transposed
// views, and Y is written in the same layout.  X̄ is read from its one
// (k, n) buffer by every worker.
//
// What bounds them on an H100: bytes.  Per step each gather streams all
// of A and each scatter all of B (m·p·n elements each) and does 2k flops
// per element; at k = 1 that is 2 flops per 8-byte f64 element, far below
// the card's flop/byte balance, so each kernel's floor is |A| (or |B|)
// over the HBM rate.  The design therefore streams each A/B element
// exactly once, with coalesced loads, and keeps everything else out of
// HBM:
//
//   * All seven kernels are the same "row dot" over a row-major matrix M
//     (gathers: M = A_w or vals_w, rows l, columns j; scatters: M = B_w
//     or Bvals_w, rows j, columns l) against a small right operand (APC
//     gather: D = X̄ − X, formed on the fly; Cimmino gather: X̄;
//     scatters: U or V).  A block
//     of 8 warps owns 8·R consecutive rows of M (R = 4, or 2 for the
//     k-chunk-8 scatters) and all KC ≤ 8 batch rows of its k-chunk; each
//     lane reads consecutive columns, so a warp reads 256 contiguous bytes
//     of a row per load, and each loaded element of M feeds KC FMAs.  Two
//     blocks fit on an SM, so one block's loads overlap the other's
//     barriers.
//   * The right operand is staged through shared memory in 256-column
//     chunks, once per block, so the (k, cols) operand is read from L2
//     once per 8·R rows of M rather than once per row.
//   * The reduction over columns (the Pallas kernels' sequential grid
//     revisits) is a loop inside the block: per-lane partial sums in
//     registers, then a fixed warp-shuffle tree.  No atomics, no split
//     across blocks: the result is deterministic run to run, and every
//     batch row sees the same sequence of operations whatever k is, so a
//     row of a k-batch is bit-identical to a k = 1 call on that row.
//   * Ragged edges (p = 7, n = 130, p = 1) are masked inside the kernel:
//     out-of-range loads read 0, out-of-range outputs are not written.
//     No padding copies of A or B.
//   * The APC scatter fuses the AXPY X + γ(X̄ − X) into the epilogue of
//     the rank-p correction; γ is a runtime argument, so a new γ builds
//     nothing.  The Cimmino scatter writes the accumulator as it is: the
//     v = b − u before it and the master sum ν Σ_w r_w after it stay
//     outside, as in the reference.
//   * The sparse kernels are the same row dots over the compressed tiles
//     (each streams vals or Bvals once: about w/n of the dense bytes).
//     The TPU version gathers X[:, cols] before its kernel and
//     scatter-adds the result after it in XLA; here the gather is part of
//     the staged load (cols is read once per chunk, and no (m, k, w) copy
//     of the support columns is ever written), and the scatter is the
//     epilogue, which STORES each row's value at its column cols[w, j].
//     That is exact because a block repeats only the index of an all-zero
//     column (the padding of as_sparse), whose Bvals row is zero, so every
//     copy stores the same value; the system's constructor checks it.
//     The APC form stores X + γ((X̄ − X) − C) on the support; the
//     off-support columns of Y come from the caller's AXPY pre-pass.
//
// f64 accumulates in f64, f32 in f32 (FFMA; no tensor cores, no TF32),
// with A/B in the same type as the right operand; the wrapper rejects
// anything else.  Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                            // staged columns

// Every instance is compiled for two blocks per SM, which caps it at 128
// registers a thread.  Left to itself ptxas gave even the k = 1 gather
// 141 registers, one block per SM, and too few loads in flight to reach
// the HBM rate (PERF.md).  A warp owns R rows of M and holds R x KC
// accumulators: R = 4, except R = 2 for the KC = 8 scatters, which spill
// under the cap at R = 4.
constexpr int kMinBlocks = 2;
template <int KC>
constexpr int scatter_rows() { return KC >= 8 ? 2 : 4; }
constexpr int kGatherRows = 4;

// Per-lane partial dot products of this warp's R rows of the
// row-major (rows x cols) matrix M with the KC staged right-operand rows,
// reduced over the lanes at the end.  `stage(c0, Vs)` fills
// Vs[kk][c] = V[kk][c0 + c], zero outside the valid range.
template <typename T, int KC, int R, typename Stage>
__device__ __forceinline__ void row_dot(const T* __restrict__ M,
                                        int64_t rows, int64_t cols,
                                        int64_t row0, Stage stage,
                                        T (*Vs)[kChunk],
                                        T (&acc)[R][KC]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) acc[r][kk] = T(0);

  const int64_t wrow0 = row0 + warp * R;
  for (int64_t c0 = 0; c0 < cols; c0 += kChunk) {
    __syncthreads();                 // the previous chunk is consumed
    stage(c0, Vs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const int c = lane + 32 * i;
      const int64_t col = c0 + c;
      T a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = wrow0 + r;
        a[r] = (row < rows && col < cols) ? M[row * cols + col] : T(0);
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const T v = Vs[kk][c];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][kk] = fma(a[r], v, acc[r][kk]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      T v = acc[r][kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][kk] = v;
    }
}

// Gather staging: Vs[kk][c] = X̄[i, g] − X[w, i, g] (APC, kDiff) or
// X̄[i, g] (Cimmino, X unused), i = k0 + kk, at the global column
// g = c0 + c, or g = cols[c0 + c] of this worker's support (kSparse; n is
// then the support width).
template <typename T, int KC, bool kDiff, bool kSparse>
struct StageXbar {
  const T* X;
  const T* Xbar;
  const int64_t* cols;
  int64_t n, kvalid, sx_k, sxb_k;
  __device__ void operator()(int64_t c0, T (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      T v = T(0);
      if (kk < kvalid && col < n) {
        const int64_t g = kSparse ? cols[col] : col;
        v = Xbar[kk * sxb_k + g];
        if constexpr (kDiff) v -= X[kk * sx_k + g];
      }
      Vs[kk][c] = v;
    }
  }
};

// Scatter staging: Vs[kk][c] = U[w, i, c0 + c] (or V for Cimmino).
template <typename T, int KC>
struct StageU {
  const T* U;
  int64_t p, kvalid, su_k;
  __device__ void operator()(int64_t c0, T (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      Vs[kk][c] = (kk < kvalid && col < p) ? U[kk * su_k + col] : T(0);
    }
  }
};

// The gather of block (blockIdx.x, w, k-chunk): U[w, i, l] for this
// block's 8 R rows l of A_w (p x n; vals_w, p x w, under kSparse)
// against the X̄-staged operand.
// grid (ceil(p / (8 R)), m, ceil(k / KC))
template <typename T, int KC, int R, bool kDiff, bool kSparse>
__device__ __forceinline__ void gather_block(
    const T* __restrict__ A, const T* __restrict__ X,
    const T* __restrict__ Xbar, const int64_t* __restrict__ cols,
    T* __restrict__ U, int64_t p, int64_t n, int64_t k, int64_t sx_w,
    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
    T (*Vs)[kChunk]) {
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  StageXbar<T, KC, kDiff, kSparse> stage{
      kDiff ? X + w * sx_w + k0 * sx_k : X, Xbar + k0 * sxb_k,
      kSparse ? cols + w * n : cols, n, kvalid, sx_k, sxb_k};
  T acc[R][KC];
  row_dot<T, KC, R>(A + w * p * n, p, n, row0, stage, Vs, acc);
  if (threadIdx.x % 32 != 0) return;
  const int64_t wrow0 = row0 + (threadIdx.x / 32) * R;
  T* Uw = U + w * su_w + k0 * su_k;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      if (wrow0 + r < p && kk < kvalid) Uw[kk * su_k + wrow0 + r] = acc[r][kk];
}

// The scatter of block (blockIdx.x, w, k-chunk): the rank-p product of
// this block's 8 R rows j of B_w (n x p; Bvals_w, w x p, under kSparse)
// with the staged U (or V), then the epilogue at output column j (dense,
// coalesced along j) or cols[w, j] (kSparse): Y = X + γ((X̄ − X) − B·U)
// under kAxpy (APC), Y = B·V otherwise (Cimmino; X and X̄ unused).
// grid (ceil(n / (8 R)), m, ceil(k / KC))
template <typename T, int KC, int R, bool kAxpy, bool kSparse>
__device__ __forceinline__ void scatter_block(
    const T* __restrict__ B, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar,
    const T* __restrict__ U, T gamma, T* __restrict__ Y, int64_t n,
    int64_t p, int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
    int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k,
    T (*Vs)[kChunk], T (*Cs)[kWarps * R]) {
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  StageU<T, KC> stage{U + w * su_w + k0 * su_k, p, kvalid, su_k};
  T acc[R][KC];
  row_dot<T, KC, R>(B + w * n * p, n, p, row0, stage, Vs, acc);
  if (threadIdx.x % 32 == 0) {
    const int wr = (threadIdx.x / 32) * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) Cs[kk][wr + r] = acc[r][kk];
  }
  __syncthreads();
  T* Yw = Y + w * sy_w + k0 * sy_k;
  for (int idx = threadIdx.x; idx < KC * (kWarps * R); idx += kThreads) {
    const int kk = idx / (kWarps * R);
    const int jj = idx % (kWarps * R);
    const int64_t j = row0 + jj;
    if (kk < kvalid && j < n) {
      const int64_t jo = kSparse ? cols[w * n + j] : j;
      if constexpr (kAxpy) {
        const T x = X[w * sx_w + (k0 + kk) * sx_k + jo];
        const T d = Xbar[(k0 + kk) * sxb_k + jo] - x;
        Yw[kk * sy_k + jo] = x + gamma * (d - Cs[kk][jj]);
      } else {
        Yw[kk * sy_k + jo] = Cs[kk][jj];
      }
    }
  }
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_gather_kernel(const T* __restrict__ A, const T* __restrict__ X,
                  const T* __restrict__ Xbar, T* __restrict__ U,
                  int64_t p, int64_t n, int64_t k, int64_t sx_w,
                  int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k) {
  __shared__ T Vs[KC][kChunk];
  gather_block<T, KC, R, true, false>(A, X, Xbar, nullptr, U, p, n, k,
                                      sx_w, sx_k, sxb_k, su_w, su_k, Vs);
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_gather_kernel(const T* __restrict__ A, const T* __restrict__ Xbar,
                      T* __restrict__ U, int64_t p, int64_t n, int64_t k,
                      int64_t sxb_k, int64_t su_w, int64_t su_k) {
  __shared__ T Vs[KC][kChunk];
  gather_block<T, KC, R, false, false>(A, nullptr, Xbar, nullptr, U, p, n,
                                       k, 0, 0, sxb_k, su_w, su_k, Vs);
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_scatter_kernel(const T* __restrict__ B, const T* __restrict__ X,
                   const T* __restrict__ Xbar, const T* __restrict__ U,
                   T gamma, T* __restrict__ Y, int64_t n, int64_t p,
                   int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  __shared__ T Vs[KC][kChunk];
  __shared__ T Cs[KC][kWarps * R];        // the reduced B·U per row
  scatter_block<T, KC, R, true, false>(B, nullptr, X, Xbar, U, gamma, Y, n,
                                       p, k, sx_w, sx_k, sxb_k, su_w, su_k,
                                       sy_w, sy_k, Vs, Cs);
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_scatter_kernel(const T* __restrict__ B, const T* __restrict__ V,
                       T* __restrict__ Rout, int64_t n, int64_t p,
                       int64_t k, int64_t sv_w, int64_t sv_k, int64_t sr_w,
                       int64_t sr_k) {
  __shared__ T Vs[KC][kChunk];
  __shared__ T Cs[KC][kWarps * R];        // the reduced B·V per row
  scatter_block<T, KC, R, false, false>(B, nullptr, nullptr, nullptr, V,
                                        T(0), Rout, n, p, k, 0, 0, 0, sv_w,
                                        sv_k, sr_w, sr_k, Vs, Cs);
}

// The sparse kernels: w is the support width, the row-dot's column count
// (gathers) or row count (scatters).
template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_gather_kernel(const T* __restrict__ vals,
                     const int64_t* __restrict__ cols,
                     const T* __restrict__ X, const T* __restrict__ Xbar,
                     T* __restrict__ U, int64_t p, int64_t w, int64_t k,
                     int64_t sx_w, int64_t sx_k, int64_t sxb_k, int64_t su_w,
                     int64_t su_k) {
  __shared__ T Vs[KC][kChunk];
  gather_block<T, KC, R, true, true>(vals, X, Xbar, cols, U, p, w, k, sx_w,
                                     sx_k, sxb_k, su_w, su_k, Vs);
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_cimmino_gather_kernel(const T* __restrict__ vals,
                             const int64_t* __restrict__ cols,
                             const T* __restrict__ Xbar, T* __restrict__ U,
                             int64_t p, int64_t w, int64_t k, int64_t sxb_k,
                             int64_t su_w, int64_t su_k) {
  __shared__ T Vs[KC][kChunk];
  gather_block<T, KC, R, false, true>(vals, nullptr, Xbar, cols, U, p, w,
                                      k, 0, 0, sxb_k, su_w, su_k, Vs);
}

template <typename T, int KC, int R, bool kAxpy>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_scatter_kernel(const T* __restrict__ Bvals,
                      const int64_t* __restrict__ cols,
                      const T* __restrict__ X, const T* __restrict__ Xbar,
                      const T* __restrict__ U, T gamma, T* __restrict__ Y,
                      int64_t w, int64_t p, int64_t k, int64_t sx_w,
                      int64_t sx_k, int64_t sxb_k, int64_t su_w,
                      int64_t su_k, int64_t sy_w, int64_t sy_k) {
  __shared__ T Vs[KC][kChunk];
  __shared__ T Cs[KC][kWarps * R];        // the reduced Bvals·U per row
  scatter_block<T, KC, R, kAxpy, true>(Bvals, cols, X, Xbar, U, gamma, Y, w,
                                       p, k, sx_w, sx_k, sxb_k, su_w, su_k,
                                       sy_w, sy_k, Vs, Cs);
}

inline int kc_for(int64_t k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

// Calls f(std::integral_constant<int, KC>) with the k-chunk for k.
template <typename F>
void with_kc(int64_t k, F&& f) {
  switch (kc_for(k)) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

inline dim3 grid_for(int64_t rows, int64_t m, int64_t k, int kc, int r) {
  const int64_t rb = kWarps * r;                       // rows per block
  return dim3(static_cast<unsigned>((rows + rb - 1) / rb),
              static_cast<unsigned>(m),
              static_cast<unsigned>((k + kc - 1) / kc));
}

template <typename T>
int apc_gather(const void* A, const void* X, const void* Xbar, void* U,
               int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
               int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
               void* stream) {
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    apc_gather_kernel<T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const T*>(A), static_cast<const T*>(X),
            static_cast<const T*>(Xbar), static_cast<T*>(U), p, n, k, sx_w,
            sx_k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cimmino_gather(const void* A, const void* Xbar, void* U, int64_t m,
                   int64_t p, int64_t n, int64_t k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, void* stream) {
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    cimmino_gather_kernel<T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const T*>(A), static_cast<const T*>(Xbar),
            static_cast<T*>(U), p, n, k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apc_scatter(const void* B, const void* X, const void* Xbar,
                const void* U, double gamma, void* Y, int64_t m, int64_t n,
                int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
                int64_t sxb_k, int64_t su_w, int64_t su_k, int64_t sy_w,
                int64_t sy_k, void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    constexpr int R = scatter_rows<KC>();
    apc_scatter_kernel<T, KC, R>
        <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
            static_cast<const T*>(B), static_cast<const T*>(X),
            static_cast<const T*>(Xbar), static_cast<const T*>(U),
            static_cast<T>(gamma), static_cast<T*>(Y), n, p, k, sx_w, sx_k,
            sxb_k, su_w, su_k, sy_w, sy_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cimmino_scatter(const void* B, const void* V, void* Rout, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sv_w,
                    int64_t sv_k, int64_t sr_w, int64_t sr_k, void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    constexpr int R = scatter_rows<KC>();
    cimmino_scatter_kernel<T, KC, R>
        <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
            static_cast<const T*>(B), static_cast<const T*>(V),
            static_cast<T*>(Rout), n, p, k, sv_w, sv_k, sr_w, sr_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sparse_gather(const void* vals, const void* cols, const void* X,
                  const void* Xbar, void* U, int64_t m, int64_t p,
                  int64_t w, int64_t k, int64_t sx_w, int64_t sx_k,
                  int64_t sxb_k, int64_t su_w, int64_t su_k, void* stream) {
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    sparse_gather_kernel<T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const T*>(vals), static_cast<const int64_t*>(cols),
            static_cast<const T*>(X), static_cast<const T*>(Xbar),
            static_cast<T*>(U), p, w, k, sx_w, sx_k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sparse_cimmino_gather(const void* vals, const void* cols,
                          const void* Xbar, void* U, int64_t m, int64_t p,
                          int64_t w, int64_t k, int64_t sxb_k, int64_t su_w,
                          int64_t su_k, void* stream) {
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    sparse_cimmino_gather_kernel<T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const T*>(vals), static_cast<const int64_t*>(cols),
            static_cast<const T*>(Xbar), static_cast<T*>(U), p, w, k, sxb_k,
            su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

// Both forms of sparse_scatter: the APC form when X is given (it reads X
// and X̄), the Cimmino form when X is null.
template <typename T>
int sparse_scatter(const void* Bvals, const void* cols, const void* X,
                   const void* Xbar, const void* U, double gamma, void* Y,
                   int64_t m, int64_t w, int64_t p, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   int64_t sy_w, int64_t sy_k, void* stream) {
  if (m == 0 || w == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(k, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    constexpr int R = scatter_rows<KC>();
    const dim3 grid = grid_for(w, m, k, KC, R);
    const auto launch = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(Bvals), static_cast<const int64_t*>(cols),
          static_cast<const T*>(X), static_cast<const T*>(Xbar),
          static_cast<const T*>(U), static_cast<T>(gamma),
          static_cast<T*>(Y), w, p, k, sx_w, sx_k, sxb_k, su_w, su_k, sy_w,
          sy_k);
    };
    if (X != nullptr)
      launch(sparse_scatter_kernel<T, KC, R, true>);
    else
      launch(sparse_scatter_kernel<T, KC, R, false>);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int apc_gather_f64(const void* A, const void* X, const void* Xbar, void* U,
                   int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   void* stream) {
  return apc_gather<double>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k,
                            su_w, su_k, stream);
}

int apc_gather_f32(const void* A, const void* X, const void* Xbar, void* U,
                   int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   void* stream) {
  return apc_gather<float>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k,
                           su_w, su_k, stream);
}

int apc_scatter_f64(const void* B, const void* X, const void* Xbar,
                    const void* U, double gamma, void* Y, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sx_w,
                    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                    int64_t sy_w, int64_t sy_k, void* stream) {
  return apc_scatter<double>(B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w,
                             sx_k, sxb_k, su_w, su_k, sy_w, sy_k, stream);
}

int apc_scatter_f32(const void* B, const void* X, const void* Xbar,
                    const void* U, double gamma, void* Y, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sx_w,
                    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                    int64_t sy_w, int64_t sy_k, void* stream) {
  return apc_scatter<float>(B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w,
                            sx_k, sxb_k, su_w, su_k, sy_w, sy_k, stream);
}

int cimmino_gather_f64(const void* A, const void* Xbar, void* U, int64_t m,
                       int64_t p, int64_t n, int64_t k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k, void* stream) {
  return cimmino_gather<double>(A, Xbar, U, m, p, n, k, sxb_k, su_w, su_k,
                                stream);
}

int cimmino_gather_f32(const void* A, const void* Xbar, void* U, int64_t m,
                       int64_t p, int64_t n, int64_t k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k, void* stream) {
  return cimmino_gather<float>(A, Xbar, U, m, p, n, k, sxb_k, su_w, su_k,
                               stream);
}

int cimmino_scatter_f64(const void* B, const void* V, void* R, int64_t m,
                        int64_t n, int64_t p, int64_t k, int64_t sv_w,
                        int64_t sv_k, int64_t sr_w, int64_t sr_k,
                        void* stream) {
  return cimmino_scatter<double>(B, V, R, m, n, p, k, sv_w, sv_k, sr_w,
                                 sr_k, stream);
}

int cimmino_scatter_f32(const void* B, const void* V, void* R, int64_t m,
                        int64_t n, int64_t p, int64_t k, int64_t sv_w,
                        int64_t sv_k, int64_t sr_w, int64_t sr_k,
                        void* stream) {
  return cimmino_scatter<float>(B, V, R, m, n, p, k, sv_w, sv_k, sr_w, sr_k,
                                stream);
}

int sparse_gather_f64(const void* vals, const void* cols, const void* X,
                      const void* Xbar, void* U, int64_t m, int64_t p,
                      int64_t w, int64_t k, int64_t sx_w, int64_t sx_k,
                      int64_t sxb_k, int64_t su_w, int64_t su_k,
                      void* stream) {
  return sparse_gather<double>(vals, cols, X, Xbar, U, m, p, w, k, sx_w, sx_k,
                          sxb_k, su_w, su_k, stream);
}

int sparse_gather_f32(const void* vals, const void* cols, const void* X,
                      const void* Xbar, void* U, int64_t m, int64_t p,
                      int64_t w, int64_t k, int64_t sx_w, int64_t sx_k,
                      int64_t sxb_k, int64_t su_w, int64_t su_k,
                      void* stream) {
  return sparse_gather<float>(vals, cols, X, Xbar, U, m, p, w, k, sx_w, sx_k,
                          sxb_k, su_w, su_k, stream);
}

int sparse_cimmino_gather_f64(const void* vals, const void* cols,
                              const void* Xbar, void* U, int64_t m,
                              int64_t p, int64_t w, int64_t k, int64_t sxb_k,
                              int64_t su_w, int64_t su_k, void* stream) {
  return sparse_cimmino_gather<double>(vals, cols, Xbar, U, m, p, w, k, sxb_k,
                                  su_w, su_k, stream);
}

int sparse_cimmino_gather_f32(const void* vals, const void* cols,
                              const void* Xbar, void* U, int64_t m,
                              int64_t p, int64_t w, int64_t k, int64_t sxb_k,
                              int64_t su_w, int64_t su_k, void* stream) {
  return sparse_cimmino_gather<float>(vals, cols, Xbar, U, m, p, w, k, sxb_k,
                                  su_w, su_k, stream);
}

int sparse_scatter_f64(const void* Bvals, const void* cols, const void* X,
                       const void* Xbar, const void* U, double gamma, void* Y,
                       int64_t m, int64_t w, int64_t p, int64_t k,
                       int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k, int64_t sy_w,
                       int64_t sy_k, void* stream) {
  return sparse_scatter<double>(Bvals, cols, X, Xbar, U, gamma, Y, m, w, p, k,
                           sx_w, sx_k, sxb_k, su_w, su_k, sy_w, sy_k,
                           stream);
}

int sparse_scatter_f32(const void* Bvals, const void* cols, const void* X,
                       const void* Xbar, const void* U, double gamma, void* Y,
                       int64_t m, int64_t w, int64_t p, int64_t k,
                       int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k, int64_t sy_w,
                       int64_t sy_k, void* stream) {
  return sparse_scatter<float>(Bvals, cols, X, Xbar, U, gamma, Y, m, w, p, k,
                           sx_w, sx_k, sxb_k, su_w, su_k, sy_w, sy_k,
                           stream);
}

}  // extern "C"
