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
//   * All seven kernels have the same "row dot" over a row-major matrix M
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
// All seven kernels (the four gathers apc_gather, sparse_gather,
// cimmino_gather, sparse_cimmino_gather, and the scatters apc_scatter,
// cimmino_scatter and both forms of sparse_scatter) have a second,
// Hopper instance, the "ring", which the launcher takes wherever its
// 16-byte copies can (below); the row dot stays only for the shapes
// they cannot take.  All are bound by
// bytes (|A| or |vals| over the HBM rate), but at k = 8 the row dot
// reached only about half its bound: each 256-column chunk stages 8
// batch rows of the right operand between two barriers with no load of A
// in flight, its 32 f64 accumulators spill under the 128-register cap,
// and a lane holds at most R = 4 loads of A in flight (the f64 and f32
// scatters only R = 2 at KC = 8).  The ring instead:
//
//   * runs one persistent block per SM (grid = min(SMs, 64-row tiles)):
//     8 consumer warps and 4 producer warps.  Block b takes an equal,
//     contiguous share of the m·ceil(k/KC)·p rows (worker-major, to
//     within one row), cut into tiles of at most 64 rows that never
//     cross a worker or a k-chunk, so no SM idles while others finish a
//     last wave (fixed 64-row tiles left 512 tiles on 132 SMs: 3.88
//     waves), and neighbouring tiles share X_w and X̄ in L2.
//   * streams A (or vals) through a ring of S stages of dynamic shared
//     memory, 512 bytes of each of the tile's rows a stage (64 f64 or 128
//     f32 columns; a bf16 matrix: the compute type's columns, see below),
//     with 16-byte cp.async: no register holds a load.  A
//     "full" mbarrier per stage counts the 128 producer threads whose
//     copies have landed (cp.async.mbarrier.arrive), an "empty" one the
//     consumer warps done reading it.  S is what fits in 200 KiB: 5 or 6
//     stages, so 128–165 KiB are in flight per SM (bf16: 8 to 16 smaller
//     stages).
//   * stages the right operand with the A stage that uses it: the stage's
//     KC rows of X̄ and, in the APC form, of X (dense: 16 bytes a lane;
//     sparse: one cp.async of one element a lane at the support column
//     cols[w, c], which the producer reads once, a step ahead, so no copy
//     waits on it).  The operand costs 2·KC/64 of A's bytes (APC) or
//     KC/64 (Cimmino: X̄ alone, the one (k, n) buffer every worker
//     reads), from L2, beside A and not between barriers.
//   * gives each consumer warp 8 rows and all KC batch rows: 8·KC
//     accumulators (64 f64 at KC = 8: 128 of its 168 registers; the
//     tile's coordinates wait in shared memory meanwhile, so nothing
//     spills).  Lane l sums the
//     columns ≡ l (mod 32) in increasing order, reading A and X̄ (or
//     forming X̄ − X) from the stage, and the warp reduces with the row
//     dot's xor-shuffle tree: every output is the row dot's sequence of
//     operations, so the two instances are bit-identical.
//   * copies only the valid bytes of the last, ragged chunk, and loops
//     over its valid columns only.
//
// A scatter is the Cimmino form of the ring over the rows j of B_w
// (n x p; Bvals_w, w x p) with U_w (or V_w) in X̄'s place: the
// producers copy the stage's KC operand rows, 16 bytes a lane, from the
// tile's own worker (ring_produce's kPerWorker), so the stage, its size
// (gather_ring_smem's Cimmino form) and the consumers' loop are the
// Cimmino gather's.  Only the epilogue differs: the shuffle tree runs as
// a reduce-scatter, halving the sums a lane keeps at each level (the
// same additions in the same order as the tree), so each lane ends with
// its own 1–2 of the warp's 8·KC sums and the 32 lanes store at once:
// at column j (dense) or cols[w, j] (sparse), C in the Cimmino forms
// (R = V·Bᵀ) and X + γ((X̄ − X) − C) in the APC forms (apc_scatter, and
// sparse_scatter given X), reading X, X̄ and cols only there, after the
// accumulators are gone.
//
// Tried on the card and dropped for the gathers, each slower than this
// design or not working (PERF.md): one 1-D bulk copy (cp.async.bulk) per
// 512-byte row segment, about half the bound; no producer warp, every
// warp copying its own rows; 7 rows a consumer warp at KC = 8, to fit
// 168 registers; and setmaxnreg, moving registers from the producers to
// the consumers, which hung the kernel.
//
// A 16-byte cp.async moves 16 bytes between 16-byte-aligned addresses.
// So the ring needs the rows of its matrix (A, vals, B, Bvals) and every
// base and row stride it copies from (dense gathers: X̄, and X in the
// APC form; scatters: U or V) to be 16-byte multiples: f64 with an even
// row length, f32 with one divisible by 4, bf16 by 8.  Other shapes
// (n = 130 or 7 in f32, an odd support width, p = 7, a view at an odd
// offset, an empty row) take the row dot.  The choice is by shape,
// made once in the Python wrapper (block_projection.gather_instance) and
// passed to the entry as one int64 (kRowDot or kRing); a scatter with a
// float64 or float32 matrix at k = 1 takes the row dot there too, a
// fixed rule from the chip's timings (its one batch row is no stage's
// worth of reuse, and the ring's per-tile cost is not earned back).
//
// Two types name every kernel: the matrix type TM of A, B, vals and
// Bvals, and the compute type T of X, X̄, U, V, Y and R; a third
// follows from T, the accumulator type Acc<T>.  f64 accumulates in f64,
// f32 in f32 (DFMA/FFMA; no tensor cores, no TF32).  The entries
// <kernel>_f64 and <kernel>_f32 take TM = T; <kernel>_bf16_f64 and
// <kernel>_bf16_f32 take a bf16 matrix (the reference's
// precision="mixed": the accumulation type follows X, not the stored
// A/B).  The consumer widens each element of the matrix to Acc<T> once,
// exactly (bf16 ⊂ f32 ⊂ f64), and feeds the widened value to all KC
// batch rows.  The all-bf16 form (apc_gather_bf16_bf16,
// apc_scatter_bf16_bf16: the reference's apc_gather/apc_scatter on bf16
// x) takes T = bf16 and accumulates in f32 (_acc_dtype): each operand
// element is widened to f32 as it is read, the difference X̄ − X is
// taken in f32, γ is the bf16-rounded value in f32, and each output is
// rounded to bf16 as it is stored (U between the two passes, and Y).
// Its scatter ring reads X and X̄ after the tree (a one-element
// cp.async moves at least 4 bytes).  The other five kernels take the
// first four pairs only.  The ring sizes its stage by the compute type:
// C = 512 / sizeof(T) columns a stage, so the operand's rows are 512
// bytes as in the f64/f32 rings, and the matrix's rows C·sizeof(TM)
// bytes (128 for bf16/f64, 256 for bf16/f32, 512 for bf16/bf16); the
// stages are smaller, so more of them fit (at most kRingMaxStages); the
// all-bf16 APC stage at KC = 8 is 40 KiB, five stages in the 200 KiB
// budget.  The wrapper rejects every other pair.
//
// KC, the batch rows a block (a ring tile) carries, is 1, 2, 4 or 8: the
// entry's kc argument where the caller pins or measured one
// (kernels/ops.py, REPRO_KERNEL_BK), else the smallest that holds all k
// rows, at most 8.  Every entry returns cudaGetLastError() after its
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <type_traits>

namespace {

__host__ __device__ constexpr int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// An element of the matrix in the compute type: exact, as bf16 ⊂ f32 ⊂
// f64.
template <typename T, typename TM>
__device__ __forceinline__ T widen(TM x) {
  return static_cast<T>(x);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// bf16 -> f64 through f32 (F2F.F64.F32).  A probe on the card timed two
// integer constructions of the f64 bits against it (the f32 bits shifted
// into the f64 fields and rescaled by 2^896 in one exact multiply; the
// exponent rebiased, zeros and subnormals on a branch): both were slower
// in the ring gathers at k = 1 and k = 8 (PERF.md).
template <>
__device__ __forceinline__ double widen<double, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return static_cast<double>(__bfloat162float(x));
}

// The accumulator type of a compute (operand) type T: T itself for f64
// and f32; f32 for bf16 (the all-bf16 form, the reference's _acc_dtype).
// Every operand element is widened to it as it is read, and every output
// is narrowed back to T as it is stored; for f64 and f32 both are the
// identity, so those forms compile to what they compiled to before.
template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using Acc = typename AccOf<T>::type;

// An accumulator value in the output type T.
template <typename T, typename TA>
__device__ __forceinline__ T narrow(TA x) {
  return static_cast<T>(x);
}

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float x) {
  return __float2bfloat16_rn(x);
}

// γ as the kernels apply it: in T's accumulator type, after rounding to
// T (the reference's jnp.asarray(gamma, x.dtype)): a float rounded to
// the nearest bf16, ties to even, for the all-bf16 form.
template <typename T>
Acc<T> gamma_of(double g) {
  return static_cast<T>(g);
}

template <>
float gamma_of<__nv_bfloat16>(double g) {
  float f = static_cast<float>(g);
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x7fffu + ((u >> 16) & 1u);
  u &= 0xffff0000u;
  memcpy(&f, &u, sizeof f);
  return f;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                            // staged columns

// Every row-dot instance is compiled for two blocks per SM, which caps it
// at 128 registers a thread.  Left to itself ptxas gave even the k = 1
// gather 141 registers, one block per SM, and too few loads in flight to
// reach the HBM rate (PERF.md).  A warp owns R rows of M and holds R x KC
// accumulators: R = 4, except R = 2 for the f64 and f32 KC = 8 scatters,
// which spill under the cap at R = 4.  The bf16 (packed) scatters fit
// R = 4 at KC = 8 (no spill), and each read of the staged operand then
// feeds four rows: faster than R = 2 in a probe on the card
// (PERF.md).
constexpr int kMinBlocks = 2;
template <typename TM, int KC>
constexpr int scatter_rows() {
  return KC >= 8 && sizeof(TM) != 2 ? 2 : 4;
}
constexpr int kGatherRows = 4;

// The ring instance of the gathers (header): 64-row tiles, 8 rows per
// consumer warp, 512-byte row segments per stage, as many stages as fit
// in 200 KiB of the SM's 227 KB (one block per SM; the rest is left to
// L1).  12 warps put 3 on each of the SM's 4 schedulers, which share its
// 16384 registers a lane: 168 a thread.  A ring is of the APC form
// (kDiff: the operand X̄ − X) or the Cimmino form (X̄).
constexpr int64_t kRowDot = 0, kRing = 1;          // the entries' instance
constexpr int64_t kApcForm = 0, kCimminoForm = 1;  // gather_ring_smem's form
constexpr int kRingWarps = 8;                      // consumer warps
constexpr int kRingWarpRows = 8;
constexpr int kRingRows = kRingWarps * kRingWarpRows;
constexpr int kRingLoaders = 4;                    // producer warps
constexpr int kRingThreads = 32 * (kRingWarps + kRingLoaders);
constexpr int kRingSegment = 512;       // bytes of an operand row a stage
constexpr int kRingBudget = 200 * 1024;
constexpr int kRingMaxStages = 16;

// A stage holds C = kCols columns: M[kRingRows][kCols] in TM, then
// X̄[KC][kCols] and, under kDiff, X[KC][kCols] in T (kOperandRows rows
// of the right operand, 512 bytes each).  A matrix row segment is
// kPieces 16-byte copies.
template <typename TM, typename T, int KC, bool kDiff>
struct Ring {
  static constexpr int kCols = kRingSegment / sizeof(T);
  static constexpr int kRowBytes = kCols * sizeof(TM);
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kMatrixBytes = kRingRows * kRowBytes;
  static constexpr int kOperandRows = (kDiff ? 2 : 1) * KC;
  static constexpr int kStageBytes =
      kMatrixBytes + kOperandRows * kRingSegment;
  static constexpr int kStages =
      static_cast<int>(min64(kRingBudget / kStageBytes, kRingMaxStages));
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStages >= 2 && kCols % 32 == 0 && 32 % kPieces == 0,
                "ring shape");
};

// A packed row dot (the bf16 scatters) loads 16 bytes of a row a lane:
// lane l takes the kPack consecutive columns c0 + kPack·l ... of each
// 256-column chunk, and the staged operand is stored permuted, column
// c0 + kPack·l + j at Vs[kk][32·j + l], so the lanes read it without bank
// conflicts.  The scalar row dot's lane l takes the columns ≡ l (mod 32),
// in the ring's order (the gathers' two instances are bit-identical);
// with 2-byte elements it issues four times the loads per byte of f64
// and was bound by them (PERF.md).  So a bf16 scatter's two instances
// sum in two orders: its ring is bit-identical to the f64 (f32) ring on
// the matrix widened, its packed row dot is not.
constexpr int kPack = 16 / sizeof(__nv_bfloat16);
static_assert(kChunk == 32 * kPack, "one pack a lane a chunk");

__device__ __forceinline__ int packed_slot(int c) {
  return (c % kPack) * 32 + c / kPack;
}

// Per-lane partial dot products of this warp's R rows of the
// row-major (rows x cols) matrix M with the KC staged right-operand rows,
// reduced over the lanes at the end.  `stage(c0, Vs)` fills
// Vs[kk][c] = V[kk][c0 + c] (Vs[kk][packed_slot(c)] under kPacked), zero
// outside the valid range.  Each loaded element of M is widened to T once
// and feeds KC FMAs.
template <typename TM, typename T, int KC, int R, bool kPacked,
          typename Stage>
__device__ __forceinline__ void row_dot(const TM* __restrict__ M,
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
  // 16-byte loads need 16-byte rows at a 16-byte-aligned base
  [[maybe_unused]] const bool aligned =
      cols * static_cast<int64_t>(sizeof(TM)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(M) % 16 == 0;
  for (int64_t c0 = 0; c0 < cols; c0 += kChunk) {
    __syncthreads();                 // the previous chunk is consumed
    stage(c0, Vs);
    __syncthreads();
    if constexpr (kPacked) {
      static_assert(sizeof(TM) * kPack == 16, "a pack is 16 bytes");
      const int64_t col = c0 + kPack * lane;
      uint4 raw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = wrow0 + r;
        const TM* src = M + row * cols + col;
        if (row < rows && aligned && col + kPack <= cols) {
          raw[r] = *reinterpret_cast<const uint4*>(src);
        } else {
          TM* e = reinterpret_cast<TM*>(&raw[r]);
#pragma unroll
          for (int j = 0; j < kPack; ++j)
            e[j] = (row < rows && col + j < cols) ? src[j] : TM(0.0f);
        }
      }
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T a = widen<T>(reinterpret_cast<const TM*>(&raw[r])[j]);
#pragma unroll
          for (int kk = 0; kk < KC; ++kk)
            acc[r][kk] = fma(a, Vs[kk][32 * j + lane], acc[r][kk]);
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const int c = lane + 32 * i;
      const int64_t col = c0 + c;
      T a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = wrow0 + r;
        a[r] = (row < rows && col < cols) ? widen<T>(M[row * cols + col])
                                          : T(0);
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
// then the support width), in the accumulator type.
template <typename T, int KC, bool kDiff, bool kSparse>
struct StageXbar {
  using TA = Acc<T>;
  const T* X;
  const T* Xbar;
  const int64_t* cols;
  int64_t n, kvalid, sx_k, sxb_k;
  __device__ void operator()(int64_t c0, TA (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      TA v = TA(0);
      if (kk < kvalid && col < n) {
        const int64_t g = kSparse ? cols[col] : col;
        v = widen<TA>(Xbar[kk * sxb_k + g]);
        if constexpr (kDiff) v -= widen<TA>(X[kk * sx_k + g]);
      }
      Vs[kk][c] = v;
    }
  }
};

// Scatter staging: Vs[kk][c] = U[w, i, c0 + c] (or V for Cimmino), at
// Vs[kk][packed_slot(c)] for a packed row dot, in the accumulator type.
template <typename T, int KC, bool kPacked>
struct StageU {
  using TA = Acc<T>;
  const T* U;
  int64_t p, kvalid, su_k;
  __device__ void operator()(int64_t c0, TA (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      Vs[kk][kPacked ? packed_slot(c) : c] =
          (kk < kvalid && col < p) ? widen<TA>(U[kk * su_k + col]) : TA(0);
    }
  }
};

// The gather of block (blockIdx.x, w, k-chunk): U[w, i, l] for this
// block's 8 R rows l of A_w (p x n; vals_w, p x w, under kSparse)
// against the X̄-staged operand.
// grid (ceil(p / (8 R)), m, ceil(k / KC))
template <typename TM, typename T, int KC, int R, bool kDiff, bool kSparse>
__device__ __forceinline__ void gather_block(
    const TM* __restrict__ A, const T* __restrict__ X,
    const T* __restrict__ Xbar, const int64_t* __restrict__ cols,
    T* __restrict__ U, int64_t p, int64_t n, int64_t k, int64_t sx_w,
    int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
    Acc<T> (*Vs)[kChunk]) {
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  StageXbar<T, KC, kDiff, kSparse> stage{
      kDiff ? X + w * sx_w + k0 * sx_k : X, Xbar + k0 * sxb_k,
      kSparse ? cols + w * n : cols, n, kvalid, sx_k, sxb_k};
  Acc<T> acc[R][KC];
  row_dot<TM, Acc<T>, KC, R, false>(A + w * p * n, p, n, row0, stage, Vs,
                                    acc);
  if (threadIdx.x % 32 != 0) return;
  const int64_t wrow0 = row0 + (threadIdx.x / 32) * R;
  T* Uw = U + w * su_w + k0 * su_k;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      if (wrow0 + r < p && kk < kvalid)
        Uw[kk * su_k + wrow0 + r] = narrow<T>(acc[r][kk]);
}

// The scatter of block (blockIdx.x, w, k-chunk): the rank-p product of
// this block's 8 R rows j of B_w (n x p; Bvals_w, w x p, under kSparse)
// with the staged U (or V), then the epilogue at output column j (dense,
// coalesced along j) or cols[w, j] (kSparse): Y = X + γ((X̄ − X) − B·U)
// under kAxpy (APC), Y = B·V otherwise (Cimmino; X and X̄ unused).
// grid (ceil(n / (8 R)), m, ceil(k / KC))
template <typename TM, typename T, int KC, int R, bool kAxpy, bool kSparse>
__device__ __forceinline__ void scatter_block(
    const TM* __restrict__ B, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar,
    const T* __restrict__ U, Acc<T> gamma, T* __restrict__ Y, int64_t n,
    int64_t p, int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
    int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k,
    Acc<T> (*Vs)[kChunk], Acc<T> (*Cs)[kWarps * R]) {
  using TA = Acc<T>;
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  // a bf16 matrix takes the packed row dot
  constexpr bool kPacked = sizeof(TM) * kPack == 16;
  StageU<T, KC, kPacked> stage{U + w * su_w + k0 * su_k, p, kvalid, su_k};
  TA acc[R][KC];
  row_dot<TM, TA, KC, R, kPacked>(B + w * n * p, n, p, row0, stage, Vs,
                                  acc);
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
        const TA x = widen<TA>(X[w * sx_w + (k0 + kk) * sx_k + jo]);
        const TA d = widen<TA>(Xbar[(k0 + kk) * sxb_k + jo]) - x;
        Yw[kk * sy_k + jo] = narrow<T>(x + gamma * (d - Cs[kk][jj]));
      } else {
        Yw[kk * sy_k + jo] = narrow<T>(Cs[kk][jj]);
      }
    }
  }
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_gather_kernel(const TM* __restrict__ A, const T* __restrict__ X,
                  const T* __restrict__ Xbar, T* __restrict__ U,
                  int64_t p, int64_t n, int64_t k, int64_t sx_w,
                  int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  gather_block<TM, T, KC, R, true, false>(A, X, Xbar, nullptr, U, p, n, k,
                                      sx_w, sx_k, sxb_k, su_w, su_k, Vs);
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_gather_kernel(const TM* __restrict__ A, const T* __restrict__ Xbar,
                      T* __restrict__ U, int64_t p, int64_t n, int64_t k,
                      int64_t sxb_k, int64_t su_w, int64_t su_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  gather_block<TM, T, KC, R, false, false>(A, nullptr, Xbar, nullptr, U, p, n,
                                       k, 0, 0, sxb_k, su_w, su_k, Vs);
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_scatter_kernel(const TM* __restrict__ B, const T* __restrict__ X,
                   const T* __restrict__ Xbar, const T* __restrict__ U,
                   Acc<T> gamma, T* __restrict__ Y, int64_t n, int64_t p,
                   int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  __shared__ Acc<T> Cs[KC][kWarps * R];        // the reduced B·U per row
  scatter_block<TM, T, KC, R, true, false>(B, nullptr, X, Xbar, U, gamma, Y, n,
                                       p, k, sx_w, sx_k, sxb_k, su_w, su_k,
                                       sy_w, sy_k, Vs, Cs);
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_scatter_kernel(const TM* __restrict__ B, const T* __restrict__ V,
                       T* __restrict__ Rout, int64_t n, int64_t p,
                       int64_t k, int64_t sv_w, int64_t sv_k, int64_t sr_w,
                       int64_t sr_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  __shared__ Acc<T> Cs[KC][kWarps * R];        // the reduced B·V per row
  scatter_block<TM, T, KC, R, false, false>(B, nullptr, nullptr, nullptr, V,
                                        Acc<T>(0), Rout, n, p, k, 0, 0, 0, sv_w,
                                        sv_k, sr_w, sr_k, Vs, Cs);
}

// The sparse kernels: w is the support width, the row-dot's column count
// (gathers) or row count (scatters).
template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_gather_kernel(const TM* __restrict__ vals,
                     const int64_t* __restrict__ cols,
                     const T* __restrict__ X, const T* __restrict__ Xbar,
                     T* __restrict__ U, int64_t p, int64_t w, int64_t k,
                     int64_t sx_w, int64_t sx_k, int64_t sxb_k, int64_t su_w,
                     int64_t su_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  gather_block<TM, T, KC, R, true, true>(vals, X, Xbar, cols, U, p, w, k, sx_w,
                                     sx_k, sxb_k, su_w, su_k, Vs);
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_cimmino_gather_kernel(const TM* __restrict__ vals,
                             const int64_t* __restrict__ cols,
                             const T* __restrict__ Xbar, T* __restrict__ U,
                             int64_t p, int64_t w, int64_t k, int64_t sxb_k,
                             int64_t su_w, int64_t su_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  gather_block<TM, T, KC, R, false, true>(vals, nullptr, Xbar, cols, U, p, w,
                                      k, 0, 0, sxb_k, su_w, su_k, Vs);
}

template <typename TM, typename T, int KC, int R, bool kAxpy>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_scatter_kernel(const TM* __restrict__ Bvals,
                      const int64_t* __restrict__ cols,
                      const T* __restrict__ X, const T* __restrict__ Xbar,
                      const T* __restrict__ U, Acc<T> gamma,
                      T* __restrict__ Y, int64_t w, int64_t p, int64_t k,
                      int64_t sx_w,
                      int64_t sx_k, int64_t sxb_k, int64_t su_w,
                      int64_t su_k, int64_t sy_w, int64_t sy_k) {
  __shared__ Acc<T> Vs[KC][kChunk];
  __shared__ Acc<T> Cs[KC][kWarps * R];        // the reduced Bvals·U per row
  scatter_block<TM, T, KC, R, kAxpy, true>(Bvals, cols, X, Xbar, U, gamma, Y, w,
                                       p, k, sx_w, sx_k, sxb_k, su_w, su_k,
                                       sy_w, sy_k, Vs, Cs);
}

// ---------------------------------------------------------------------------
// The ring instance of every kernel (see the header)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// 16 bytes from global to shared, asynchronously, both 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// One element from global to shared, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async_element(T* dst, const T* src) {
  static_assert(sizeof(T) >= 4, "a cp.async moves 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "n"(sizeof(T)) : "memory");
}

// An arrival on bar once this thread's cp.asyncs so far have landed,
// counted in the barrier's init count (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// A tile: rows row0 .. row0 + rows of worker w's matrix against its
// batch rows k0 .. k0 + kvalid.
struct RingTile {
  int64_t w, k0, row0;
  int rows, kvalid;
};

// A consumer warp's place in the walk: the next tile's first row g of
// its range [g, end), and the tile it computes.
struct RingWalk {
  int64_t g, end;
  RingTile tl;
};

// The ring's shared memory: the stages (dynamic), their full and empty
// barriers, and each consumer warp's walk.  Declared here, their
// addresses are constants: no register holds them.
extern __shared__ __align__(128) unsigned char ring_smem[];
__shared__ __align__(8) uint64_t ring_full[kRingMaxStages];
__shared__ __align__(8) uint64_t ring_empty[kRingMaxStages];
__shared__ RingWalk ring_walks[kRingWarps];

// The walk's rows are g = (w · k_tiles + k-chunk) · p + row, worker-major;
// block b takes the rows [total·b / grid, total·(b + 1) / grid), an equal
// share to within one row, cut into tiles of at most 64 rows that never
// cross a worker or a k-chunk.  This is the tile at row g of [g, end).
template <int KC>
__device__ __forceinline__ RingTile ring_tile(int64_t g, int64_t end,
                                              int64_t p, int64_t k) {
  const int64_t unit = g / p;
  const int64_t k_tiles = (k + KC - 1) / KC;
  RingTile r;
  r.w = unit / k_tiles;
  r.k0 = unit % k_tiles * KC;
  r.row0 = g - unit * p;
  r.rows = static_cast<int>(min64(min64(p - r.row0, end - g), kRingRows));
  r.kvalid = static_cast<int>(min64(k - r.k0, KC));
  return r;
}

// The support columns of the step at column c0 of worker w's cols that
// lane l copies X̄ and X at: cols[w, c0 + l + 32 j] (0 past the end).
template <int C>
__device__ __forceinline__ void ring_cols(int64_t (&g)[C / 32],
                                          const int64_t* __restrict__ cols,
                                          int64_t w, int64_t c0, int64_t n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < C / 32; ++j)
    g[j] = c0 + lane + 32 * j < n ? cols[w * n + c0 + lane + 32 * j] : 0;
}

// A producer warp (pw of kRingLoaders): for every chunk of the tile, wait
// for its stage to empty, then copy its share into it — rows of M (16
// bytes a lane; a row segment is kPieces copies, so a warp copies
// 32 / kPieces rows at once: rows pw, pw + 4, ... in f64 and f32) and
// rows q = pw, pw + 4, ... of the right operand's KC (Cimmino) or 2·KC
// (kDiff) rows (X̄ row q, or X row q − KC; dense: 16 bytes a lane,
// sparse: one element a lane at its support column) — and arrive on the
// stage's full barrier once they have landed.  Under kSparse, `g` holds
// the support columns of the step and is refilled with the next step's
// (the next tile's first, of worker next_w, after the last chunk): each
// index is read a step before the copies that need it.  Under
// kPerWorker (the scatters: the Cimmino form, dense) the operand is
// worker w's own rows, at Xbar + w·sxb_w, not the one shared X̄.  `it`
// counts the block's (tile, chunk) steps: stage it % S, round it / S.
template <typename TM, typename T, int KC, bool kDiff, bool kSparse,
          bool kPerWorker>
__device__ __forceinline__ void ring_produce(
    const RingTile& tl, int64_t next_w,
    int64_t (&g)[Ring<TM, T, KC, kDiff>::kCols / 32],
    const TM* __restrict__ M, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar, int64_t p,
    int64_t n, int64_t sx_w, int64_t sx_k, int64_t sxb_k, uint32_t& it,
    int64_t sxb_w) {
  using Cfg = Ring<TM, T, KC, kDiff>;
  static_assert(!kPerWorker || !(kDiff || kSparse), "a scatter's operand");
  constexpr int C = Cfg::kCols;
  constexpr int kPer = 16 / sizeof(T);           // operand elements a piece
  constexpr int kMPer = 16 / sizeof(TM);         // matrix elements a piece
  constexpr int kRowsAtOnce = 32 / Cfg::kPieces;
  const int pw = threadIdx.x / 32 - kRingWarps;
  const int lane = threadIdx.x % 32;
  const int piece = lane % Cfg::kPieces;
  const TM* Mt = M + (tl.w * p + tl.row0) * n + piece * kMPer;
  for (int64_t c0 = 0; c0 < n; c0 += C, ++it) {
    const int s = it % Cfg::kStages;
    const int nv = static_cast<int>(min64(n - c0, C));
    const int mpieces = nv * static_cast<int>(sizeof(TM)) / 16;
    const int opieces = nv * static_cast<int>(sizeof(T)) / 16;
    unsigned char* stage = ring_smem + s * Cfg::kStageBytes;
    TM* Ms = reinterpret_cast<TM*>(stage);
    T* XBs = reinterpret_cast<T*>(stage + Cfg::kMatrixBytes);
    T* Xs = XBs + KC * C;
    mbar_wait(&ring_empty[s], ((it / Cfg::kStages) & 1) ^ 1);
    int64_t gc[C / 32] = {};
    if (kSparse && pw < Cfg::kOperandRows) {
#pragma unroll
      for (int j = 0; j < C / 32; ++j) gc[j] = g[j];
      if (c0 + C < n)
        ring_cols<C>(g, cols, tl.w, c0 + C, n);
      else if (next_w >= 0)
        ring_cols<C>(g, cols, next_w, 0, n);
    }
    if (piece < mpieces)
      for (int r = pw * kRowsAtOnce + lane / Cfg::kPieces; r < tl.rows;
           r += kRingLoaders * kRowsAtOnce)
        cp_async16(Ms + r * C + piece * kMPer, Mt + r * n + c0);
    for (int q = pw; q < Cfg::kOperandRows; q += kRingLoaders) {
      const int kk = q % KC;
      if (kk >= tl.kvalid) continue;
      T* dst = (q < KC ? XBs : Xs) + kk * C;
      const T* src = q < KC ? Xbar + (tl.k0 + kk) * sxb_k
                            : X + tl.w * sx_w + (tl.k0 + kk) * sx_k;
      if constexpr (kPerWorker) src += tl.w * sxb_w;
      if constexpr (kSparse) {
#pragma unroll
        for (int j = 0; j < C / 32; ++j)
          if (lane + 32 * j < nv)
            cp_async_element(dst + lane + 32 * j, src + gc[j]);
      } else if (lane < opieces) {
        cp_async16(dst + lane * kPer, src + c0 + lane * kPer);
      }
    }
    cp_async_arrive(&ring_full[s]);
  }
}

// The operand at column c of a stage for the batch rows K0 .. K1 − 1:
// X̄ − X (kDiff) or X̄, in the accumulator type.
template <typename T, int KC, int C, bool kDiff, int K0, int K1>
__device__ __forceinline__ void ring_operand(const T* XBs, const T* Xs,
                                             int c, Acc<T> (&d)[K1 - K0]) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    d[kk - K0] = widen<Acc<T>>(XBs[kk * C + c]);
    if constexpr (kDiff) d[kk - K0] -= widen<Acc<T>>(Xs[kk * C + c]);
  }
}

// Column c of a stage against a consumer warp's 8 rows, for the batch
// rows K0 .. K1 − 1; each element of M widened to T as it is read.
template <typename TM, typename T, int KC, int C, bool kDiff, int K0 = 0,
          int K1 = KC>
__device__ __forceinline__ void ring_column(
    const TM* Ms, const T* XBs, const T* Xs, int c,
    Acc<T> (&acc)[kRingWarpRows][KC]) {
  Acc<T> d[K1 - K0];
  ring_operand<T, KC, C, kDiff, K0, K1>(XBs, Xs, c, d);
#pragma unroll
  for (int r = 0; r < kRingWarpRows; ++r) {
    const Acc<T> a = widen<Acc<T>>(Ms[r * C + c]);
#pragma unroll
    for (int kk = K0; kk < K1; ++kk)
      acc[r][kk] = fma(a, d[kk - K0], acc[r][kk]);
  }
}

// The same against the column of M already widened.
template <typename T, int KC, int C, bool kDiff, int K0, int K1>
__device__ __forceinline__ void ring_column_widened(
    const Acc<T> (&a)[kRingWarpRows], const T* XBs, const T* Xs, int c,
    Acc<T> (&acc)[kRingWarpRows][KC]) {
  Acc<T> d[K1 - K0];
  ring_operand<T, KC, C, kDiff, K0, K1>(XBs, Xs, c, d);
#pragma unroll
  for (int r = 0; r < kRingWarpRows; ++r)
#pragma unroll
    for (int kk = K0; kk < K1; ++kk)
      acc[r][kk] = fma(a[r], d[kk - K0], acc[r][kk]);
}

// A consumer warp's columns of one stage: lane l takes the stage's
// columns l, l + 32, ... below nv, in increasing order.  At f64 and
// KC = 8 the 64 accumulators (128 of the 168 registers) leave no room
// for a second column's loads: that loop is not unrolled.  Nor, in the
// APC form, for the 16 loads of X̄ and X behind the 8 values of X̄ − X:
// it takes each column in two halves of the batch rows, reading the
// column of A twice; a bf16 A is widened once, into 8 registers, before
// the two halves.  The Cimmino form loads only the 8 values of X̄ and
// takes a column in one pass.
template <typename TM, typename T, int KC, int C, bool kDiff, bool kRagged>
__device__ __forceinline__ void ring_columns(const TM* Ms, const T* XBs,
                                             const T* Xs, int nv,
                                             Acc<T> (&acc)[kRingWarpRows][KC]) {
  using TA = Acc<T>;
  const int lane = threadIdx.x % 32;
  if constexpr (KC * sizeof(TA) >= 64) {
#pragma unroll 1
    for (int c = lane; c < (kRagged ? nv : C); c += 32) {
      if constexpr (kDiff && std::is_same_v<TM, TA>) {
        ring_column<TM, T, KC, C, kDiff, 0, KC / 2>(Ms, XBs, Xs, c, acc);
        ring_column<TM, T, KC, C, kDiff, KC / 2, KC>(Ms, XBs, Xs, c, acc);
      } else if constexpr (kDiff) {
        TA a[kRingWarpRows];
#pragma unroll
        for (int r = 0; r < kRingWarpRows; ++r) a[r] = widen<TA>(Ms[r * C + c]);
        ring_column_widened<T, KC, C, kDiff, 0, KC / 2>(a, XBs, Xs, c, acc);
        ring_column_widened<T, KC, C, kDiff, KC / 2, KC>(a, XBs, Xs, c, acc);
      } else {
        ring_column<TM, T, KC, C, kDiff>(Ms, XBs, Xs, c, acc);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      if (kRagged && lane + 32 * i >= nv) break;
      ring_column<TM, T, KC, C, kDiff>(Ms, XBs, Xs, lane + 32 * i, acc);
    }
  }
}

// A consumer warp, over the rows [g, end): for each tile, its 8 rows
// against every chunk as it lands, then `store` (the shuffle tree and
// the epilogue).  A warp with no rows in the tile
// still waits for and releases every stage, so the empty barriers count
// all 8 warps.  Its place in the walk waits in shared memory while the
// accumulators hold the registers.
template <typename TM, typename T, int KC, bool kDiff, typename Store>
__device__ __forceinline__ void ring_consume(int64_t g, int64_t end,
                                             int64_t p, int64_t n,
                                             int64_t k, Store store) {
  using Cfg = Ring<TM, T, KC, kDiff>;
  constexpr int C = Cfg::kCols;
  constexpr int R = kRingWarpRows;
  RingWalk* walk = &ring_walks[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * R;
  if (lane == 0) {
    walk->g = g;
    walk->end = end;
  }
  uint32_t it = 0;
  for (;;) {
    bool active;
    {
      __syncwarp();                    // lane 0's last writes are seen
      const int64_t g = walk->g, end = walk->end;
      if (g >= end) return;
      const RingTile tl = ring_tile<KC>(g, end, p, k);
      __syncwarp();                    // every lane has read them
      if (lane == 0) {
        walk->tl = tl;
        walk->g = g + tl.rows;
      }
      __syncwarp();
      active = r0 < tl.rows;
    }
    Acc<T> acc[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) acc[r][kk] = Acc<T>(0);
    for (int64_t c0 = 0; c0 < n; c0 += C, ++it) {
      const int s = it % Cfg::kStages;
      const unsigned char* stage = ring_smem + s * Cfg::kStageBytes;
      const TM* Ms = reinterpret_cast<const TM*>(stage);
      const T* XBs = reinterpret_cast<const T*>(stage + Cfg::kMatrixBytes);
      const T* Xs = XBs + KC * C;
      mbar_wait(&ring_full[s], (it / Cfg::kStages) & 1);
      if (active) {
        if (c0 + C <= n)
          ring_columns<TM, T, KC, C, kDiff, false>(Ms + r0 * C, XBs, Xs, C,
                                                   acc);
        else
          ring_columns<TM, T, KC, C, kDiff, true>(
              Ms + r0 * C, XBs, Xs, static_cast<int>(n - c0), acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring_empty[s]);
    }
    if (active) store(acc, walk, r0, lane);
  }
}

// A gather's epilogue: the row dot's xor-shuffle tree, one level at a
// time over all the accumulators in place (each sees the same additions
// in the same order; the tree per accumulator, interleaved by ptxas,
// spilled), then lane 0 stores U[w, k0 + kk, row0 + r0 + r].
template <typename T, int KC>
struct RingGatherStore {
  T* __restrict__ U;
  int64_t su_w, su_k;
  __device__ __forceinline__ void operator()(
      Acc<T> (&acc)[kRingWarpRows][KC], const RingWalk* walk, int r0,
      int lane) const {
    constexpr int R = kRingWarpRows;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          acc[r][kk] += __shfl_xor_sync(0xffffffffu, acc[r][kk], off);
    if (lane != 0) return;
    const RingTile tl = walk->tl;
    T* Ut = U + tl.w * su_w + tl.k0 * su_k + tl.row0 + r0;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (r0 + r < tl.rows && kk < tl.kvalid)
          Ut[kk * su_k + r] = narrow<T>(acc[r][kk]);
  }
};

// The row dot's xor-shuffle tree over a warp's N partial sums, each
// level halving the sums a lane keeps (a reduce-scatter): at offset kOff
// a lane whose bit kOff is set keeps the upper half of its kCount sums,
// the other the lower, and adds its partner's partial of each; once one
// is left, the levels go on as the tree.  Each sum is the tree's own:
// own + partner's partial at every level, in the tree's order.  Lane l
// ends with the sums l·N/32, ... (max(N/32, 1) of them, the first in
// v[0]; below 32 sums, 32/N lanes hold each).
template <int kOff, int kCount, typename T, int N>
__device__ __forceinline__ void reduce_scatter(T (&v)[N], int lane) {
  if constexpr (kOff > 0) {
    if constexpr (kCount > 1) {
      constexpr int h = kCount / 2;
      const bool hi = lane & kOff;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const T send = hi ? v[j] : v[j + h];
        const T keep = hi ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kOff);
    }
    reduce_scatter<kOff / 2, (kCount > 1 ? kCount / 2 : 1)>(v, lane);
  }
}

// A scatter's epilogue: the tree as a reduce-scatter over the warp's 8
// rows × KC sums, so every lane holds its own 1–2 and the lanes store
// together: out[w, k0 + kk, j'] for the tile's row j = row0 + r0 + r and
// kk < kvalid, at j' = j (dense) or cols[w, j] (kSparse; `rows` is the
// support width), of C (R = V·Bᵀ, the Cimmino forms) or, under kAxpy,
// of X + γ((X̄ − X) − C) (the APC forms: apc_scatter, and sparse_scatter
// given X), as the row dot stores them.  The sums are laid out so that
// lane l holds row r = q % 8 and batch rows kk = (q / 8)·H + h,
// h < H = max(KC / 4, 1), with q = l (or
// the l·N/32 of the lanes that hold a sum each below 32 sums): each
// store (one h) writes 8 consecutive rows of a batch row from 8
// neighbouring lanes, and reads X and X̄ so.  The reduce-scatter leaves
// at most 2 sums live, so X, X̄ and cols cost no register the
// accumulators need.
//
// The dense APC form (apc_scatter) copies X and X̄ at its lane's outputs
// into shared memory before the tree (`prefetch`: one cp.async of one
// element each, so no register holds them while the tree runs) and reads
// them there after it: the loads' latency hides behind the tree.  Loaded
// after the tree, it sat at the end of every one of the ~31 tiles a
// block walks at the main path's shapes, where at k = 8 the consumers
// set the ring's pace: in probes on the card that form trailed the
// Cimmino ring by a few per cent in f64 and more in f32; loaded into
// registers before the tree, X and X̄ spilled the f64 instance (PERF.md).
// The sparse form reads cols first and keeps its loads after the tree.
template <typename T, int KC, bool kAxpy, bool kSparse>
struct RingScatterStore {
  static constexpr int N = kRingWarpRows * KC;
  static constexpr int H = N >= 32 ? N / 32 : 1;   // sums a lane holds
  // a one-element cp.async moves 4, 8 or 16 bytes: a bf16 X reads after
  // the tree, as the sparse form does
  static constexpr bool kStaged = kAxpy && !kSparse && sizeof(T) >= 4;
  using TA = Acc<T>;
  const int64_t* __restrict__ cols;
  const T* __restrict__ X;
  const T* __restrict__ Xbar;
  TA gamma;
  T* __restrict__ Y;
  int64_t rows, sx_w, sx_k, sxb_k, sy_w, sy_k;

  // This warp's copies of X (row 2h) and X̄ (row 2h + 1), lane by lane.
  __device__ static T (*staged())[32] {
    __shared__ T slots[kRingWarps][2 * H][32];
    return slots[threadIdx.x / 32];
  }

  // The copies of X and X̄ at the lane's outputs (lane l holds the sums
  // q = l·N/32/H, ... of operator()), where it stores any.
  __device__ __forceinline__ void prefetch(const RingTile& tl, int r0,
                                           int lane) const {
    if constexpr (N < 32)
      if (lane % (32 / N) != 0) return;
    const int q = lane * N / 32 / H;
    const int r = q % kRingWarpRows;
    if (r0 + r >= tl.rows) return;
    const int64_t j = tl.row0 + r0 + r;
    T (*s)[32] = staged();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int kk = q / kRingWarpRows * H + h;
      if (kk >= tl.kvalid) continue;
      const int64_t i = tl.k0 + kk;
      cp_async_element(&s[2 * h][lane], X + tl.w * sx_w + i * sx_k + j);
      cp_async_element(&s[2 * h + 1][lane], Xbar + i * sxb_k + j);
    }
  }

  __device__ __forceinline__ void operator()(TA (&acc)[kRingWarpRows][KC],
                                             const RingWalk* walk, int r0,
                                             int lane) const {
    if constexpr (kStaged) prefetch(walk->tl, r0, lane);
    TA v[N];
#pragma unroll
    for (int r = 0; r < kRingWarpRows; ++r)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        v[((kk / H) * kRingWarpRows + r) * H + kk % H] = acc[r][kk];
    reduce_scatter<16, N>(v, lane);
    if constexpr (N < 32)
      if (lane % (32 / N) != 0) return;            // another lane's copy
    const int q = lane * N / 32 / H;
    const int r = q % kRingWarpRows;
    const RingTile tl = walk->tl;
    if (r0 + r >= tl.rows) return;
    const int64_t j = tl.row0 + r0 + r;
    const int64_t jo = kSparse ? cols[tl.w * rows + j] : j;
    if constexpr (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int kk = q / kRingWarpRows * H + h;
      if (kk >= tl.kvalid) continue;
      const int64_t i = tl.k0 + kk;
      T* y = Y + tl.w * sy_w + i * sy_k + jo;
      if constexpr (kStaged) {
        const TA x = staged()[2 * h][lane];
        const TA d = staged()[2 * h + 1][lane] - x;
        *y = narrow<T>(x + gamma * (d - v[h]));
      } else if constexpr (kAxpy) {
        const TA x = widen<TA>(X[tl.w * sx_w + i * sx_k + jo]);
        const TA d = widen<TA>(Xbar[i * sxb_k + jo]) - x;
        *y = narrow<T>(x + gamma * (d - v[h]));
      } else {
        *y = narrow<T>(v[h]);
      }
    }
  }
};

// The ring over the m·ceil(k/KC)·p rows of M (p x n a worker): warps
// 8..11 copy (ring_produce), warps 0..7 compute and hand each tile's sums
// to `store`; both walk the block's tiles.
template <typename TM, typename T, int KC, bool kDiff, bool kSparse,
          bool kPerWorker, typename Store>
__device__ __forceinline__ void ring_run(
    const TM* __restrict__ M, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar, int64_t m,
    int64_t p, int64_t n, int64_t k, int64_t sx_w, int64_t sx_k,
    int64_t sxb_w, int64_t sxb_k, Store store) {
  using Cfg = Ring<TM, T, KC, kDiff>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&ring_full[s], 32 * kRingLoaders);  // every producer thread
      mbar_init(&ring_empty[s], kRingWarps);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t total = m * ((k + KC - 1) / KC) * p;
  const int64_t end = total * (blockIdx.x + 1) / gridDim.x;
  int64_t g = total * blockIdx.x / gridDim.x;
  const int warp = threadIdx.x / 32;
  if (warp >= kRingWarps) {
    uint32_t it = 0;
    RingTile tl = ring_tile<KC>(g, end, p, k);
    int64_t cg[Cfg::kCols / 32] = {};      // support columns, a step ahead
    if (kSparse && g < end) ring_cols<Cfg::kCols>(cg, cols, tl.w, 0, n);
    while (g < end) {
      const int64_t gn = g + tl.rows;
      const RingTile next = gn < end ? ring_tile<KC>(gn, end, p, k) : tl;
      ring_produce<TM, T, KC, kDiff, kSparse, kPerWorker>(
          tl, gn < end ? next.w : -1, cg, M, cols, X, Xbar, p, n, sx_w, sx_k,
          sxb_k, it, sxb_w);
      g = gn;
      tl = next;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    ring_consume<TM, T, KC, kDiff>(g, end, p, n, k, store);
  }
}

// U[w, i, l] = sum_j (X̄[i, g_j] − X[w, i, g_j]) · M[w, l, j] (kDiff;
// X̄[i, g_j] alone otherwise, X unused) with g_j = j (dense: M = A) or
// cols[w, j] (kSparse: M = vals, n = w).
template <typename TM, typename T, int KC, bool kDiff, bool kSparse>
__device__ __forceinline__ void gather_ring(
    const TM* __restrict__ M, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar, T* __restrict__ U,
    int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w, int64_t sx_k,
    int64_t sxb_k, int64_t su_w, int64_t su_k) {
  ring_run<TM, T, KC, kDiff, kSparse, false>(
      M, cols, X, Xbar, m, p, n, k, sx_w, sx_k, 0, sxb_k,
      RingGatherStore<T, KC>{U, su_w, su_k});
}

// C[w, i, j] = sum_l U[w, i, l] · M[w, j, l] over the rows j of M = B_w
// (n x p; Bvals_w, w x p, under kSparse), streamed as the Cimmino
// gathers stream A with U_w (V_w) as their X̄, then the scatter's
// epilogue (RingScatterStore).
template <typename TM, typename T, int KC, bool kAxpy, bool kSparse>
__device__ __forceinline__ void scatter_ring(
    const TM* __restrict__ M, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar,
    const T* __restrict__ U, Acc<T> gamma, T* __restrict__ Y, int64_t m,
    int64_t n, int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
    int64_t sxb_k, int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  ring_run<TM, T, KC, false, false, true>(
      M, nullptr, nullptr, U, m, n, p, k, 0, 0, su_w, su_k,
      RingScatterStore<T, KC, kAxpy, kSparse>{cols, X, Xbar, gamma, Y, n,
                                              sx_w, sx_k, sxb_k, sy_w, sy_k});
}

// The four gather ring kernels share one parameter list; a dense kernel
// does not read cols, nor a Cimmino one X and its strides.
template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
apc_gather_ring_kernel(const TM* __restrict__ A,
                       const int64_t* __restrict__ cols,
                       const T* __restrict__ X, const T* __restrict__ Xbar,
                       T* __restrict__ U, int64_t m, int64_t p, int64_t n,
                       int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k) {
  gather_ring<TM, T, KC, true, false>(A, cols, X, Xbar, U, m, p, n, k, sx_w,
                                  sx_k, sxb_k, su_w, su_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
sparse_gather_ring_kernel(const TM* __restrict__ vals,
                          const int64_t* __restrict__ cols,
                          const T* __restrict__ X,
                          const T* __restrict__ Xbar, T* __restrict__ U,
                          int64_t m, int64_t p, int64_t w, int64_t k,
                          int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                          int64_t su_w, int64_t su_k) {
  gather_ring<TM, T, KC, true, true>(vals, cols, X, Xbar, U, m, p, w, k, sx_w,
                                 sx_k, sxb_k, su_w, su_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
cimmino_gather_ring_kernel(const TM* __restrict__ A,
                           const int64_t* __restrict__ cols,
                           const T* __restrict__ X,
                           const T* __restrict__ Xbar, T* __restrict__ U,
                           int64_t m, int64_t p, int64_t n, int64_t k,
                           int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                           int64_t su_w, int64_t su_k) {
  gather_ring<TM, T, KC, false, false>(A, cols, X, Xbar, U, m, p, n, k, sx_w,
                                   sx_k, sxb_k, su_w, su_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
sparse_cimmino_gather_ring_kernel(const TM* __restrict__ vals,
                                  const int64_t* __restrict__ cols,
                                  const T* __restrict__ X,
                                  const T* __restrict__ Xbar,
                                  T* __restrict__ U, int64_t m, int64_t p,
                                  int64_t w, int64_t k, int64_t sx_w,
                                  int64_t sx_k, int64_t sxb_k, int64_t su_w,
                                  int64_t su_k) {
  gather_ring<TM, T, KC, false, true>(vals, cols, X, Xbar, U, m, p, w, k, sx_w,
                                  sx_k, sxb_k, su_w, su_k);
}

// The scatter ring kernels: the parameter lists of their row-dot twins
// with m (n is the sparse kernel's w).
template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
apc_scatter_ring_kernel(const TM* __restrict__ B, const T* __restrict__ X,
                        const T* __restrict__ Xbar, const T* __restrict__ U,
                        Acc<T> gamma, T* __restrict__ Y, int64_t m, int64_t n,
                        int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
                        int64_t sxb_k, int64_t su_w, int64_t su_k,
                        int64_t sy_w, int64_t sy_k) {
  scatter_ring<TM, T, KC, true, false>(B, nullptr, X, Xbar, U, gamma, Y, m,
                                       n, p, k, sx_w, sx_k, sxb_k, su_w,
                                       su_k, sy_w, sy_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
cimmino_scatter_ring_kernel(const TM* __restrict__ B,
                            const T* __restrict__ V, T* __restrict__ Rout,
                            int64_t m, int64_t n, int64_t p, int64_t k,
                            int64_t sv_w, int64_t sv_k, int64_t sr_w,
                            int64_t sr_k) {
  scatter_ring<TM, T, KC, false, false>(B, nullptr, nullptr, nullptr, V,
                                        Acc<T>(0),
                                        Rout, m, n, p, k, 0, 0, 0, sv_w, sv_k,
                                        sr_w, sr_k);
}

template <typename TM, typename T, int KC, bool kAxpy>
__global__ void __launch_bounds__(kRingThreads, 1)
sparse_scatter_ring_kernel(const TM* __restrict__ Bvals,
                           const int64_t* __restrict__ cols,
                           const T* __restrict__ X,
                           const T* __restrict__ Xbar,
                           const T* __restrict__ U, Acc<T> gamma,
                           T* __restrict__ Y, int64_t m, int64_t w,
                           int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
                           int64_t sxb_k, int64_t su_w, int64_t su_k,
                           int64_t sy_w, int64_t sy_k) {
  scatter_ring<TM, T, KC, kAxpy, true>(Bvals, cols, X, Xbar, U, gamma, Y, m,
                                       w, p, k, sx_w, sx_k, sxb_k, su_w,
                                       su_k, sy_w, sy_k);
}

// Launches kKernel, a ring kernel, over the m·ceil(k/KC)·rows rows of its
// walk with smem bytes of dynamic shared memory: one persistent block per
// SM (the ring's shared memory admits no second), and no more blocks
// than 64-row tiles.  The dynamic shared memory above 48 KB is opted into
// once per device and kernel.
template <auto kKernel, int KC, typename... Args>
void launch_ring(int smem, int64_t m, int64_t rows, int64_t k,
                 cudaStream_t s, Args... args) {
  static std::atomic<uint64_t> opted_in{0};          // a bit per device
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return;
  const uint64_t bit = uint64_t{1} << (dev % 64);
  if (!(opted_in.load() & bit)) {
    if (cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return;
    opted_in.fetch_or(bit);
  }
  const int64_t tiles = (m * ((k + KC - 1) / KC) * rows + kRingRows - 1) /
                        kRingRows;
  kKernel<<<static_cast<unsigned>(min64(sms, tiles)), kRingThreads, smem,
            s>>>(args...);
}

// The gather ring kernel of a form, the only one instantiated (the
// all-bf16 pair has the APC form alone: a sparse gather's ring copies
// 2-byte elements, which cp.async does not move).
template <typename TM, typename T, int KC, bool kDiff, bool kSparse>
constexpr auto gather_ring_kernel() {
  if constexpr (kDiff && kSparse)
    return &sparse_gather_ring_kernel<TM, T, KC>;
  else if constexpr (kDiff)
    return &apc_gather_ring_kernel<TM, T, KC>;
  else if constexpr (kSparse)
    return &sparse_cimmino_gather_ring_kernel<TM, T, KC>;
  else
    return &cimmino_gather_ring_kernel<TM, T, KC>;
}

// The gathers' ring: the kernel of its form, over the rows of A (vals).
template <typename TM, typename T, int KC, bool kDiff, bool kSparse>
void launch_gather_ring(const void* M, const void* cols, const void* X,
                        const void* Xbar, void* U, int64_t m, int64_t p,
                        int64_t n, int64_t k, int64_t sx_w, int64_t sx_k,
                        int64_t sxb_k, int64_t su_w, int64_t su_k,
                        cudaStream_t s) {
  constexpr auto kernel = gather_ring_kernel<TM, T, KC, kDiff, kSparse>();
  launch_ring<kernel, KC>(
      Ring<TM, T, KC, kDiff>::kSmem, m, p, k, s, static_cast<const TM*>(M),
      static_cast<const int64_t*>(cols), static_cast<const T*>(X),
      static_cast<const T*>(Xbar), static_cast<T*>(U), m, p, n, k, sx_w, sx_k,
      sxb_k, su_w, su_k);
}

// The k-chunk KC, the batch rows one block (a ring tile) carries: the
// entry's kc argument where the caller gives one (1, 2, 4 or 8: the
// instances the library holds), else the smallest that holds all k rows,
// at most 8.  Every batch row sees the same sequence of operations
// whatever KC is, so the choice moves time, not bits.
inline int kc_for(int64_t k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

inline bool kc_valid(int64_t kc) {
  return kc == 0 || kc == 1 || kc == 2 || kc == 4 || kc == 8;
}

inline int kc_of(int64_t k, int64_t kc) {
  return kc > 0 ? static_cast<int>(kc) : kc_for(k);
}

// Calls f(std::integral_constant<int, KC>) with the k-chunk kc.
template <typename F>
void with_kc(int kc, F&& f) {
  switch (kc) {
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

// instance: kRing or kRowDot, as the wrapper chose it by shape.
template <typename TM, typename T>
int apc_gather(const void* A, const void* X, const void* Xbar, void* U,
               int64_t m, int64_t p, int64_t n, int64_t k, int64_t sx_w,
               int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
               int64_t instance, int64_t kc, void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_gather_ring<TM, T, KC, true, false>(
          A, nullptr, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k, su_w, su_k,
          s);
      return;
    }
    apc_gather_kernel<TM, T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const TM*>(A), static_cast<const T*>(X),
            static_cast<const T*>(Xbar), static_cast<T*>(U), p, n, k, sx_w,
            sx_k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename T>
int cimmino_gather(const void* A, const void* Xbar, void* U, int64_t m,
                   int64_t p, int64_t n, int64_t k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, int64_t instance, int64_t kc,
                   void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_gather_ring<TM, T, KC, false, false>(
          A, nullptr, nullptr, Xbar, U, m, p, n, k, 0, 0, sxb_k, su_w, su_k,
          s);
      return;
    }
    cimmino_gather_kernel<TM, T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const TM*>(A), static_cast<const T*>(Xbar),
            static_cast<T*>(U), p, n, k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename T>
int apc_scatter(const void* B, const void* X, const void* Xbar,
                const void* U, double gamma, void* Y, int64_t m, int64_t n,
                int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
                int64_t sxb_k, int64_t su_w, int64_t su_k, int64_t sy_w,
                int64_t sy_k, int64_t instance, int64_t kc, void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_ring<&apc_scatter_ring_kernel<TM, T, KC>, KC>(
          Ring<TM, T, KC, false>::kSmem, m, n, k, s,
          static_cast<const TM*>(B), static_cast<const T*>(X),
          static_cast<const T*>(Xbar), static_cast<const T*>(U),
          gamma_of<T>(gamma), static_cast<T*>(Y), m, n, p, k, sx_w, sx_k,
          sxb_k, su_w, su_k, sy_w, sy_k);
      return;
    }
    constexpr int R = scatter_rows<TM, KC>();
    apc_scatter_kernel<TM, T, KC, R>
        <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
            static_cast<const TM*>(B), static_cast<const T*>(X),
            static_cast<const T*>(Xbar), static_cast<const T*>(U),
            gamma_of<T>(gamma), static_cast<T*>(Y), n, p, k, sx_w, sx_k,
            sxb_k, su_w, su_k, sy_w, sy_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename T>
int cimmino_scatter(const void* B, const void* V, void* Rout, int64_t m,
                    int64_t n, int64_t p, int64_t k, int64_t sv_w,
                    int64_t sv_k, int64_t sr_w, int64_t sr_k,
                    int64_t instance, int64_t kc, void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_ring<&cimmino_scatter_ring_kernel<TM, T, KC>, KC>(
          Ring<TM, T, KC, false>::kSmem, m, n, k, s,
          static_cast<const TM*>(B), static_cast<const T*>(V),
          static_cast<T*>(Rout), m, n, p, k, sv_w, sv_k, sr_w, sr_k);
      return;
    }
    constexpr int R = scatter_rows<TM, KC>();
    cimmino_scatter_kernel<TM, T, KC, R>
        <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
            static_cast<const TM*>(B), static_cast<const T*>(V),
            static_cast<T*>(Rout), n, p, k, sv_w, sv_k, sr_w, sr_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename T>
int sparse_gather(const void* vals, const void* cols, const void* X,
                  const void* Xbar, void* U, int64_t m, int64_t p,
                  int64_t w, int64_t k, int64_t sx_w, int64_t sx_k,
                  int64_t sxb_k, int64_t su_w, int64_t su_k,
                  int64_t instance, int64_t kc, void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_gather_ring<TM, T, KC, true, true>(
          vals, cols, X, Xbar, U, m, p, w, k, sx_w, sx_k, sxb_k, su_w, su_k,
          s);
      return;
    }
    sparse_gather_kernel<TM, T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const TM*>(vals), static_cast<const int64_t*>(cols),
            static_cast<const T*>(X), static_cast<const T*>(Xbar),
            static_cast<T*>(U), p, w, k, sx_w, sx_k, sxb_k, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename T>
int sparse_cimmino_gather(const void* vals, const void* cols,
                          const void* Xbar, void* U, int64_t m, int64_t p,
                          int64_t w, int64_t k, int64_t sxb_k, int64_t su_w,
                          int64_t su_k, int64_t instance, int64_t kc, void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      launch_gather_ring<TM, T, KC, false, true>(
          vals, cols, nullptr, Xbar, U, m, p, w, k, 0, 0, sxb_k, su_w, su_k,
          s);
      return;
    }
    sparse_cimmino_gather_kernel<TM, T, KC, kGatherRows>
        <<<grid_for(p, m, k, KC, kGatherRows), kThreads, 0, s>>>(
            static_cast<const TM*>(vals), static_cast<const int64_t*>(cols),
            static_cast<const T*>(Xbar), static_cast<T*>(U), p, w, k, sxb_k,
            su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

// Both forms of sparse_scatter: the APC form when X is given (it reads X
// and X̄), the Cimmino form when X is null.
template <typename TM, typename T>
int sparse_scatter(const void* Bvals, const void* cols, const void* X,
                   const void* Xbar, const void* U, double gamma, void* Y,
                   int64_t m, int64_t w, int64_t p, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   int64_t sy_w, int64_t sy_k, int64_t instance, int64_t kc,
                   void* stream) {
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc))
    return cudaErrorInvalidValue;
  if (m == 0 || w == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (instance == kRing) {
      const auto ring = [&](auto axpy) {
        launch_ring<&sparse_scatter_ring_kernel<TM, T, KC, decltype(axpy)::value>,
                    KC>(
            Ring<TM, T, KC, false>::kSmem, m, w, k, s,
            static_cast<const TM*>(Bvals), static_cast<const int64_t*>(cols),
            static_cast<const T*>(X), static_cast<const T*>(Xbar),
            static_cast<const T*>(U), gamma_of<T>(gamma),
            static_cast<T*>(Y), m, w, p, k, sx_w, sx_k, sxb_k, su_w, su_k,
            sy_w, sy_k);
      };
      if (X != nullptr)
        ring(std::true_type{});
      else
        ring(std::false_type{});
      return;
    }
    constexpr int R = scatter_rows<TM, KC>();
    const dim3 grid = grid_for(w, m, k, KC, R);
    const auto launch = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const TM*>(Bvals), static_cast<const int64_t*>(cols),
          static_cast<const T*>(X), static_cast<const T*>(Xbar),
          static_cast<const T*>(U), gamma_of<T>(gamma),
          static_cast<T*>(Y), w, p, k, sx_w, sx_k, sxb_k, su_w, su_k, sy_w,
          sy_k);
    };
    if (X != nullptr)
      launch(sparse_scatter_kernel<TM, T, KC, R, true>);
    else
      launch(sparse_scatter_kernel<TM, T, KC, R, false>);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The C entries of each (matrix, compute) type pair: <kernel>_<SUFFIX>.
// kc is the k-chunk (0: the library's own, kc_for(k)).  The APC pair has
// an entry for every pair of block_projection.PAIRS, the all-bf16 one
// (bf16_bf16) included; the other five for the first four.
#define REPRO_APC_ENTRIES(SUFFIX, TM, T)                                     \
  int apc_gather_##SUFFIX(const void* A, const void* X, const void* Xbar,    \
                          void* U, int64_t m, int64_t p, int64_t n,          \
                          int64_t k, int64_t sx_w, int64_t sx_k,             \
                          int64_t sxb_k, int64_t su_w, int64_t su_k,         \
                          int64_t instance, int64_t kc, void* stream) {      \
    return apc_gather<TM, T>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k,   \
                             su_w, su_k, instance, kc, stream);              \
  }                                                                          \
  int apc_scatter_##SUFFIX(const void* B, const void* X, const void* Xbar,   \
                           const void* U, double gamma, void* Y, int64_t m,  \
                           int64_t n, int64_t p, int64_t k, int64_t sx_w,    \
                           int64_t sx_k, int64_t sxb_k, int64_t su_w,        \
                           int64_t su_k, int64_t sy_w, int64_t sy_k,         \
                           int64_t instance, int64_t kc, void* stream) {     \
    return apc_scatter<TM, T>(B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w,     \
                              sx_k, sxb_k, su_w, su_k, sy_w, sy_k, instance, \
                              kc, stream);                                   \
  }

#define REPRO_ENTRIES(SUFFIX, TM, T)                                         \
  REPRO_APC_ENTRIES(SUFFIX, TM, T)                                           \
  int cimmino_gather_##SUFFIX(const void* A, const void* Xbar, void* U,      \
                              int64_t m, int64_t p, int64_t n, int64_t k,    \
                              int64_t sxb_k, int64_t su_w, int64_t su_k,     \
                              int64_t instance, int64_t kc, void* stream) {  \
    return cimmino_gather<TM, T>(A, Xbar, U, m, p, n, k, sxb_k, su_w, su_k,  \
                                 instance, kc, stream);                      \
  }                                                                          \
  int cimmino_scatter_##SUFFIX(const void* B, const void* V, void* R,        \
                               int64_t m, int64_t n, int64_t p, int64_t k,   \
                               int64_t sv_w, int64_t sv_k, int64_t sr_w,     \
                               int64_t sr_k, int64_t instance, int64_t kc,   \
                               void* stream) {                               \
    return cimmino_scatter<TM, T>(B, V, R, m, n, p, k, sv_w, sv_k, sr_w,     \
                                  sr_k, instance, kc, stream);               \
  }                                                                          \
  int sparse_gather_##SUFFIX(const void* vals, const void* cols,             \
                             const void* X, const void* Xbar, void* U,       \
                             int64_t m, int64_t p, int64_t w, int64_t k,     \
                             int64_t sx_w, int64_t sx_k, int64_t sxb_k,      \
                             int64_t su_w, int64_t su_k, int64_t instance,   \
                             int64_t kc, void* stream) {                     \
    return sparse_gather<TM, T>(vals, cols, X, Xbar, U, m, p, w, k, sx_w,    \
                                sx_k, sxb_k, su_w, su_k, instance, kc,       \
                                stream);                                     \
  }                                                                          \
  int sparse_cimmino_gather_##SUFFIX(                                        \
      const void* vals, const void* cols, const void* Xbar, void* U,         \
      int64_t m, int64_t p, int64_t w, int64_t k, int64_t sxb_k,             \
      int64_t su_w, int64_t su_k, int64_t instance, int64_t kc,              \
      void* stream) {                                                        \
    return sparse_cimmino_gather<TM, T>(vals, cols, Xbar, U, m, p, w, k,     \
                                        sxb_k, su_w, su_k, instance, kc,     \
                                        stream);                             \
  }                                                                          \
  int sparse_scatter_##SUFFIX(const void* Bvals, const void* cols,           \
                              const void* X, const void* Xbar,               \
                              const void* U, double gamma, void* Y,          \
                              int64_t m, int64_t w, int64_t p, int64_t k,    \
                              int64_t sx_w, int64_t sx_k, int64_t sxb_k,     \
                              int64_t su_w, int64_t su_k, int64_t sy_w,      \
                              int64_t sy_k, int64_t instance, int64_t kc,    \
                              void* stream) {                                \
    return sparse_scatter<TM, T>(Bvals, cols, X, Xbar, U, gamma, Y, m, w, p, \
                                 k, sx_w, sx_k, sxb_k, su_w, su_k, sy_w,     \
                                 sy_k, instance, kc, stream);                \
  }

REPRO_ENTRIES(f64, double, double)
REPRO_ENTRIES(f32, float, float)
REPRO_ENTRIES(bf16_f64, __nv_bfloat16, double)
REPRO_ENTRIES(bf16_f32, __nv_bfloat16, float)
REPRO_APC_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef REPRO_ENTRIES
#undef REPRO_APC_ENTRIES

// The ring instance's dynamic shared memory at the k-chunk of k, in
// bytes, for a matrix of matrix_itemsize bytes (8, 4 or 2), a compute
// type of itemsize bytes (8, 4, or 2 beside a bf16 matrix) and a form
// (kApcForm or kCimminoForm); 0 for any other.
int64_t gather_ring_smem(int64_t matrix_itemsize, int64_t itemsize,
                         int64_t k, int64_t form) {
  if (form != kApcForm && form != kCimminoForm) return 0;
  int64_t bytes = 0;
  with_kc(kc_for(k), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    const auto of = [&](auto tm, auto t) {
      using TM = decltype(tm);
      using T = decltype(t);
      bytes = form == kApcForm ? Ring<TM, T, KC, true>::kSmem
                               : Ring<TM, T, KC, false>::kSmem;
    };
    if (matrix_itemsize == 8 && itemsize == 8)
      of(double{}, double{});
    else if (matrix_itemsize == 4 && itemsize == 4)
      of(float{}, float{});
    else if (matrix_itemsize == 2 && itemsize == 8)
      of(__nv_bfloat16{}, double{});
    else if (matrix_itemsize == 2 && itemsize == 4)
      of(__nv_bfloat16{}, float{});
    else if (matrix_itemsize == 2 && itemsize == 2)
      of(__nv_bfloat16{}, __nv_bfloat16{});
  });
  return bytes;
}

}  // extern "C"
