// Hand-written CUDA kernels for the APC worker update, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_projection.py:
//
//   apc_gather   (repro.kernels.block_projection:apc_gather)
//       U[w, i, l] = sum_j (X̄[i, j] − X[w, i, j]) · A[w, l, j]
//   apc_scatter  (repro.kernels.block_projection:apc_scatter)
//       Y[w, i, j] = X + γ·((X̄ − X) − sum_l U[w, i, l] · B[w, j, l])
//
// for all m workers w in ONE launch each: A (m, p, n) and B (m, n, p)
// row-major and contiguous; X (m, k, n), X̄ (k, n), U (m, k, p) and Y
// (m, k, n) addressed through their worker/row strides with a unit
// stride along the last axis.  The kernels take strides rather than
// copying: solve_many holds its iterate as (k, m, n) and hands the kernels
// the (m, k, n) transposed view, and Y is written in the same layout.  X̄
// is read from its one (k, n) buffer by every worker.
//
// What bounds them on an H100: bytes.  Per step the gather streams all of
// A and the scatter all of B (m·p·n elements each) and do 2k flops per
// element; at k = 1 that is 2 flops per 8-byte f64 element, far below the
// card's flop/byte balance, so each kernel's floor is |A| (or |B|) over
// the HBM rate.  The design therefore streams each A/B element exactly
// once, with coalesced loads, and keeps everything else out of HBM:
//
//   * Both kernels are the same "row dot" over a row-major matrix M
//     (gather: M = A_w, rows l, columns j; scatter: M = B_w, rows j,
//     columns l) against a small right operand V (gather: D = X̄ − X,
//     formed on the fly; scatter: U).  A block of 8 warps owns 8·R
//     consecutive rows of M (R = 4, or 2 for the k-chunk-8 scatter) and
//     all KC ≤ 8 batch rows of its k-chunk; each lane reads consecutive
//     columns, so a warp reads 256 contiguous bytes of a row per load, and
//     each loaded element of M feeds KC FMAs.  Two blocks fit on an SM, so
//     one block's loads overlap the other's barriers.
//   * V is staged through shared memory in 256-column chunks, once per
//     block, so the (k, cols) operand is read from L2 once per 8·R rows of
//     M rather than once per row.
//   * The reduction over columns (the Pallas kernels' sequential grid
//     revisits) is a loop inside the block: per-lane partial sums in
//     registers, then a fixed warp-shuffle tree.  No atomics, no split
//     across blocks: the result is deterministic run to run, and every
//     batch row sees the same sequence of operations whatever k is, so a
//     row of a k-batch is bit-identical to a k = 1 call on that row.
//   * Ragged edges (p = 7, n = 130, p = 1) are masked inside the kernel:
//     out-of-range loads read 0, out-of-range outputs are not written.
//     No padding copies of A or B.
//   * The scatter fuses the AXPY X + γ(X̄ − X) into the epilogue of the
//     rank-p correction; γ is a runtime argument, so a new γ builds
//     nothing.
//
// f64 accumulates in f64, f32 in f32 (FFMA; no tensor cores, no TF32),
// with A/B in the same type as X; the wrapper rejects anything else.
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                            // staged columns

// Every instance is compiled for two blocks per SM, which caps it at 128
// registers a thread.  Left to itself ptxas gave even the k = 1 gather
// 141 registers, one block per SM, and too few loads in flight to reach
// the HBM rate (PERF.md).  A warp owns R rows of M and holds R x KC
// accumulators: R = 4, except R = 2 for the KC = 8 scatter, which spills
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

// Gather staging: Vs[kk][c] = X̄[i, c0 + c] − X[w, i, c0 + c], i = k0 + kk.
template <typename T, int KC>
struct StageD {
  const T* X;
  const T* Xbar;
  int64_t n, kvalid, sx_k, sxb_k;
  __device__ void operator()(int64_t c0, T (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      T v = T(0);
      if (kk < kvalid && col < n)
        v = Xbar[kk * sxb_k + col] - X[kk * sx_k + col];
      Vs[kk][c] = v;
    }
  }
};

// Scatter staging: Vs[kk][c] = U[w, i, c0 + c].
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

// grid (ceil(p / (8 R)), m, ceil(k / KC))
template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_gather_kernel(const T* __restrict__ A, const T* __restrict__ X,
                  const T* __restrict__ Xbar, T* __restrict__ U,
                  int64_t p, int64_t n, int64_t k, int64_t sx_w,
                  int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k) {
  __shared__ T Vs[KC][kChunk];
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  StageD<T, KC> stage{X + w * sx_w + k0 * sx_k, Xbar + k0 * sxb_k, n,
                      kvalid, sx_k, sxb_k};
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

// grid (ceil(n / (8 R)), m, ceil(k / KC))
template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_scatter_kernel(const T* __restrict__ B, const T* __restrict__ X,
                   const T* __restrict__ Xbar, const T* __restrict__ U,
                   T gamma, T* __restrict__ Y, int64_t n, int64_t p,
                   int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  __shared__ T Vs[KC][kChunk];
  __shared__ T Cs[KC][(kWarps * R)];      // the reduced B·U per row
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
  // epilogue: coalesced along j, the fused AXPY
  const T* Xw = X + w * sx_w + k0 * sx_k;
  const T* Xb = Xbar + k0 * sxb_k;
  T* Yw = Y + w * sy_w + k0 * sy_k;
  for (int idx = threadIdx.x; idx < KC * (kWarps * R); idx += kThreads) {
    const int kk = idx / (kWarps * R);
    const int jj = idx % (kWarps * R);
    const int64_t j = row0 + jj;
    if (kk < kvalid && j < n) {
      const T x = Xw[kk * sx_k + j];
      const T d = Xb[kk * sxb_k + j] - x;
      Yw[kk * sy_k + j] = x + gamma * (d - Cs[kk][jj]);
    }
  }
}

inline int kc_for(int64_t k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

inline dim3 grid_for(int64_t rows, int64_t m, int64_t k, int kc, int r) {
  const int64_t rb = kWarps * r;                       // rows per block
  return dim3(static_cast<unsigned>((rows + rb - 1) / rb),
              static_cast<unsigned>(m),
              static_cast<unsigned>((k + kc - 1) / kc));
}

template <typename T, int KC>
void launch_gather(const T* a, const T* x, const T* xb, T* u, int64_t m,
                   int64_t p, int64_t n, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   cudaStream_t s) {
  apc_gather_kernel<T, KC, kGatherRows>
      <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
          a, x, xb, u, p, n, k, sx_w, sx_k, sxb_k, su_w, su_k);
}

template <typename T, int KC>
void launch_scatter(const T* b, const T* x, const T* xb, const T* u, T g,
                    T* y, int64_t m, int64_t n, int64_t p, int64_t k,
                    int64_t sx_w, int64_t sx_k, int64_t sxb_k, int64_t su_w,
                    int64_t su_k, int64_t sy_w, int64_t sy_k,
                    cudaStream_t s) {
  constexpr int R = scatter_rows<KC>();
  apc_scatter_kernel<T, KC, R>
      <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
          b, x, xb, u, g, y, n, p, k, sx_w, sx_k, sxb_k, su_w, su_k, sy_w,
          sy_k);
}

template <typename T>
int gather(const void* A, const void* X, const void* Xbar, void* U,
           int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
           int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
           void* stream) {
  if (m == 0 || p == 0 || k == 0) return 0;
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  const T* xb = static_cast<const T*>(Xbar);
  T* u = static_cast<T*>(U);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kc_for(k)) {
    case 1: launch_gather<T, 1>(a, x, xb, u, m, p, n, k, sx_w, sx_k, sxb_k,
                                su_w, su_k, s); break;
    case 2: launch_gather<T, 2>(a, x, xb, u, m, p, n, k, sx_w, sx_k, sxb_k,
                                su_w, su_k, s); break;
    case 4: launch_gather<T, 4>(a, x, xb, u, m, p, n, k, sx_w, sx_k, sxb_k,
                                su_w, su_k, s); break;
    default: launch_gather<T, 8>(a, x, xb, u, m, p, n, k, sx_w, sx_k, sxb_k,
                                 su_w, su_k, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter(const void* B, const void* X, const void* Xbar, const void* U,
            double gamma, void* Y, int64_t m, int64_t n, int64_t p,
            int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
            int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k,
            void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  const T* b = static_cast<const T*>(B);
  const T* x = static_cast<const T*>(X);
  const T* xb = static_cast<const T*>(Xbar);
  const T* u = static_cast<const T*>(U);
  T* y = static_cast<T*>(Y);
  const T g = static_cast<T>(gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kc_for(k)) {
    case 1: launch_scatter<T, 1>(b, x, xb, u, g, y, m, n, p, k, sx_w, sx_k,
                                 sxb_k, su_w, su_k, sy_w, sy_k, s); break;
    case 2: launch_scatter<T, 2>(b, x, xb, u, g, y, m, n, p, k, sx_w, sx_k,
                                 sxb_k, su_w, su_k, sy_w, sy_k, s); break;
    case 4: launch_scatter<T, 4>(b, x, xb, u, g, y, m, n, p, k, sx_w, sx_k,
                                 sxb_k, su_w, su_k, sy_w, sy_k, s); break;
    default: launch_scatter<T, 8>(b, x, xb, u, g, y, m, n, p, k, sx_w, sx_k,
                                  sxb_k, su_w, su_k, sy_w, sy_k, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int apc_gather_f64(const void* A, const void* X, const void* Xbar, void* U,
                   int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   void* stream) {
  return gather<double>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k, su_w,
                        su_k, stream);
}

int apc_gather_f32(const void* A, const void* X, const void* Xbar, void* U,
                   int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   void* stream) {
  return gather<float>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k, su_w,
                       su_k, stream);
}

int apc_scatter_f64(const void* B, const void* X, const void* Xbar,
                    const void* U, double gamma, void* Y, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sx_w,
                    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                    int64_t sy_w, int64_t sy_k, void* stream) {
  return scatter<double>(B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w, sx_k,
                         sxb_k, su_w, su_k, sy_w, sy_k, stream);
}

int apc_scatter_f32(const void* B, const void* X, const void* Xbar,
                    const void* U, double gamma, void* Y, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sx_w,
                    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                    int64_t sy_w, int64_t sy_k, void* stream) {
  return scatter<float>(B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w, sx_k,
                        sxb_k, su_w, su_k, sy_w, sy_k, stream);
}

}  // extern "C"
