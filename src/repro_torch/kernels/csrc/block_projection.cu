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
//   * All seven kernels have the same "row dot" (but the tensor-core
//     form's, below) over a row-major matrix M
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
//     scatter-adds the result after it in XLA.  Here each sparse gather
//     is two launches of one entry: a pre-pass (support_operand_kernel)
//     writes the support operand O (m, k, wp), O[w, i, c] =
//     X̄[i, cols[w, c]] − X[w, i, cols[w, c]] (sparse_gather) or
//     X̄[i, cols[w, c]] (sparse_cimmino_gather), in the accumulator type
//     Acc<T> (the difference taken there, as a consumer takes it, so
//     every output rounds as before), its rows padded with zeros to a
//     16-byte multiple wp ≥ w (0.8 % of vals' bytes at the sparse path's
//     f64 k = 8); then both gathers are the Cimmino form's row dot or
//     ring over vals_w with O_w for X̄, a per-worker operand the ring
//     stages with 16-byte copies (its launch the pre-pass's programmatic
//     dependent, launch_ring).  A gather inside the ring's producers
//     repeats itself for every tile, moves a bf16 element through a
//     register, and timed slower on the card even in a 256-row tile
//     (PERF.md).  The scatter is the epilogue, which STORES each row's
//     value at its column cols[w, j].
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
//   * stages the right operand with the A stage that uses it, 16 bytes a
//     lane: the stage's KC rows of X̄ and, in the APC form, of X.  The
//     operand costs 2·KC/64 of A's bytes (APC) or KC/64 (Cimmino: X̄
//     alone, the one (k, n) buffer every worker reads, or a worker's own
//     rows: the scatters' U or V, the sparse gathers' O), from L2, beside
//     A and not between barriers.
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
// accumulators are gone (the APC forms in 4-byte and 8-byte types copy
// X and X̄, at cols[w, j] in the sparse one, into shared memory before
// the tree, RingScatterStore).
//
// Tried on the card and dropped for the gathers, each slower than this
// design or not working (PERF.md): one 1-D bulk copy (cp.async.bulk) per
// 512-byte row segment, about half the bound; no producer warp, every
// warp copying its own rows; 7 rows a consumer warp at KC = 8, to fit
// 168 registers; and setmaxnreg, moving registers from the producers to
// the consumers, which hung the kernel.
//
// The tensor-core form.  The kernels with a bf16 matrix and float64
// operands (every kernel's _bf16_f64, the main path's
// precision="mixed"; kMmaForm) stream a quarter of the float64 form's
// bytes, so at k = 8 the DFMA consumer above, not the bytes, set their
// pace (39–44 % of the bound; the sparse kernels 32–42 %).  Their
// products run on the FP64 tensor cores (mma.sync m16n8k8 .f64), in a
// ring of its own shape; so do the float64 cimmino_scatter's
// (kMmaF64Form, below) and the float64 sparse kernels' (kSparseMma; the
// sparse gathers' ring is the Cimmino form's with O_w as its per-worker
// operand, as the scatters' with U_w or V_w), and the all-bf16
// sparse_scatter's on the bf16 tensor cores (kBf16Mma, below):
//
//   * M = the matrix's rows (l of A_w, j of B_w), N = the k-chunk's 8
//     batch rows (zero past KC and the tile's), K = its columns.  Each
//     output is one accumulator chain of mmas over the columns in
//     increasing order, 8 a k-step (k-slot t of a step at column 2t,
//     t + 4 at 2t + 1): every batch row sees the same operations whatever
//     KC is and the other rows hold, so a batch row is bit-identical to a
//     k = 1 call; the row dot of this form issues the same mmas on the
//     same fragments, loaded straight from global memory (any shape, any
//     alignment), so it is bit-identical to the ring.
//   * A tile is 256 rows (kMmaRows): 8 consumer warps of 32 rows (two
//     mmas of 16), each against every column, so a stage's operand rows
//     are read from L2 once per 256 rows of the matrix: a quarter of its
//     bytes in the APC gather at KC = 8 (X̄ and X), an eighth in the
//     Cimmino gather (X̄) and the scatters (U, V).  On the card an SM
//     takes in about 3.2–3.8 TB/s of L2 traffic
//     in all, matrix and operand alike: with the rings' 64-row tiles the
//     gather's operand equalled its matrix, and it ran at half its bound
//     whatever its consumer did.
//   * Blocks take whole tiles, T = m·ceil(k/KC)·ceil(p/256) of them on
//     min(SMs, T) blocks (MmaWalk): the ring's depth is sized for a
//     256-row stage, so a part tile streams at its share of the rate, and
//     a block whose equal share of rows straddled a worker took twice as
//     long as one whose share did not.  sparse_scatter's rows rarely end
//     on a tile (the sparse path's w = 2064 = 8·256 + 16: whole tiles
//     gave 12 of 132 blocks two, and its 16 part tiles on the 4 blocks
//     the full ones leave free ran slower still, a part tile costing its
//     stages, not its rows), so its tiles may run on into the next unit
//     (SpanWalk): the units' rows in 16-row groups split evenly over the
//     blocks, a tile at most 256 rows over at most two units, rows
//     16rb .. 16rb + 15 of a warp taking the operand rows of their unit
//     (the stage holds two units' KC rows) and storing at their unit's
//     places: one tile of 240 or 256 rows a block at the sparse path's
//     shapes.
//   * The consumers read the matrix with ldmatrix (a k-step's 16-byte
//     piece of 32 rows a warp) and the operand with 16-byte loads (the
//     step's 2 columns of a batch row a lane); the producers store piece
//     j of matrix row r at j ^ (r & 7) and of operand row kk at
//     j ^ 4·(kk & 1), so neither read has a bank conflict.  The matrix
//     copies fetch 256-byte L2 blocks (.L2::256B): a stage takes 128
//     bytes of each of its 256 rows, and the next stage finds the next
//     128 in L2.
//   * Each bf16 is widened to float64 once, through float32, and feeds
//     its 8 batch rows in one mma; every warp forms the X̄ − X of its
//     fragments (8 times a stage: with the consumers' arithmetic removed
//     altogether the kernel ran no faster).  The epilogues take the sums
//     from the fragment: the gathers store U and the Cimmino scatter R
//     as they are (MmaStore), the APC scatter X + γ((X̄ − X) − C),
//     loading X and X̄ at the fragment's places.  No shuffle tree and no
//     cross-warp reduction.
//   * sparse_scatter's epilogue (MmaSparseStore) reads its lane's cols
//     and, in the APC form, X and X̄ there (as a tile starts in the
//     float64 forms, after its stages in all-bf16), and stores at cols
//     from the fragment after the tile's stages.
//   * The all-bf16 sparse_scatter (kBf16Mma) runs mma.sync m16n8k16 bf16
//     with float32 accumulators on the same ring and walk: a 64-column
//     stage is four k-steps of 16, the matrix read with two ldmatrix.x4
//     and the operand (bf16, its pieces stored as the matrix's) with one
//     ldmatrix.x2 a k-step; each output one accumulator chain over the
//     columns in order, so its ring and row dot are bit-identical and a
//     batch row is a k = 1 call's, though the sums' order is the tensor
//     cores', not the FFMA ring's (within the bf16 tolerance of the plain
//     version).  The FFMA ring it replaced trailed torch.bmm at k = 8.
//   * The float64 cimmino_scatter (R = V·Bᵀ; kMmaF64Form) takes the same
//     ring: its DFMA ring (64-row tiles, 512-byte segments) lost a fixed
//     time a tile, 31 tiles a block at the main path's shapes, each
//     ending in the reduce-scatter tree, and trailed torch.matmul at
//     k = 8.  Its stage takes 128 bytes (16 columns, two k-steps) of each
//     of 256 rows of B_w, six stages in the budget; the consumers read a
//     lane's pair of columns of its 4 rows with 16-byte loads from the
//     operand's swizzled layout and feed them to the mma unwidened, zero
//     past the ragged chunk's columns (a float64 row is a 16-byte
//     multiple: an even p, not a multiple of 8).  Its row dot issues the
//     same mmas.  Float64 arithmetic does not bind it (8.6 GFLOP at
//     k = 8: 0.13 ms on the tensor cores against 1.29 ms of bytes).
//
// Tried on the card for this form and dropped (PERF.md): 64-row tiles
// with the columns of a stage split over the 8 warps and their sums
// reduced through shared memory (the operand traffic above); 256-row
// tiles over equal shares of rows (the part tiles above); the integer
// widening (below); an L2 evict-first policy on the matrix (no change);
// and m16n8k16 (no faster than k8).
//
// A 16-byte cp.async moves 16 bytes between 16-byte-aligned addresses.
// So the ring needs the rows of its matrix (A, vals, B, Bvals) and every
// base and row stride it copies from (dense gathers: X̄, and X in the
// APC form; scatters: U or V; the sparse gathers' O is allocated so) to
// be 16-byte multiples: f64 with an even
// row length, f32 with one divisible by 4, bf16 by 8.  Other shapes
// (n = 130 or 7 in f32, an odd support width, p = 7, a view at an odd
// offset, an empty row) take the row dot.  The choice is by shape,
// made once in the Python wrapper (block_projection.gather_instance) and
// passed to the entry as one int64 (kRowDot or kRing); a dense scatter
// with a float64 or float32 matrix at k = 1 takes the row dot there too,
// a fixed rule from the chip's timings (its one batch row is no stage's
// worth of reuse, and the DFMA ring's per-tile cost is not earned back),
// but for the float64 cimmino_scatter, whose tensor-core row dot trails
// its ring at every k (block_projection.MMA_FORMS); sparse_scatter's
// ring leads its row dot in every form at k = 1 too.
//
// Two types name every kernel: the matrix type TM of A, B, vals and
// Bvals, and the compute type T of X, X̄, U, V, Y and R; a third
// follows from T, the accumulator type Acc<T>.  f64 accumulates in f64,
// f32 in f32: DFMA/FFMA, no TF32, and tensor cores only in the
// tensor-core form above (float64 mma, float64 products and sums; the
// all-bf16 sparse_scatter's bf16 mma, float32 sums).  The entries <kernel>_f64 and
// <kernel>_f32 take TM = T; <kernel>_bf16_f64 and <kernel>_bf16_f32 take
// a bf16 matrix (the reference's precision="mixed": the accumulation
// type follows X, not the stored A/B).  The consumer widens each element
// of the matrix to Acc<T> once, exactly (bf16 ⊂ f32 ⊂ f64), and feeds
// the widened value to all KC batch rows.  The all-bf16 form (<kernel>_bf16_bf16, every kernel: the
// reference's kernels on bf16 x) takes T = bf16 and accumulates in f32
// (_acc_dtype): each operand element is widened to f32 as it is read,
// the difference X̄ − X is taken in f32, γ is the bf16-rounded value in
// f32, and each output is rounded to bf16 as it is stored (U between
// the two passes, R, C, Y).  The APC form of sparse_scatter rounds
// where the reference's ops.sparse_proj_update does (apc_out): the
// pre-pass X + γ(X̄ − X) and C each to bf16, then their difference
// X + γ(X̄ − X) − γ·C, so it agrees with ops.sparse_scatter_ref to
// within the rounding of C's sum order.  A one-element cp.async moves
// at least 4 bytes, so in bf16 the dense APC scatter's ring reads X and
// X̄ after the tree.  The sparse gathers' O is float32 in the all-bf16
// form (Acc<T>): their ring is the bf16/f32 one, storing U in bf16.  The
// ring sizes its stage by the compute type: C = 512 / sizeof(T) columns
// a stage, so the operand's rows are 512 bytes as in the f64/f32 rings,
// and the matrix's rows C·sizeof(TM) bytes (128 for bf16/f64, 256 for
// bf16/f32, 512 for bf16/bf16); the stages are smaller, so more of them
// fit (at most kRingMaxStages); the all-bf16 APC stage at KC = 8 is
// 40 KiB, five stages in the 200 KiB budget.  The wrapper rejects every
// other pair.
//
// Each pair's entries are a library of their own: the wrapper compiles
// this file once per pair (-DREPRO_PAIR=0..4, block_projection.PAIRS'
// order), the five nvcc processes at once.
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
// in the DFMA ring gathers at k = 1 and k = 8, and the first again in the
// tensor-core form (widen_pair; PERF.md).
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

// The APC forms' output X + γ((X̄ − X) − C) at one element, from x, x̄
// and the reduced C in the accumulator type.  The all-bf16 sparse form
// (kSparse) rounds as the reference's ops.sparse_proj_update and
// ops.sparse_scatter_ref do: the pre-pass Y0 = X + γ(X̄ − X) to bf16, C
// to bf16, then Y0 − γ·C once more, each operation in f32 and rounded
// to nearest (no contraction to an FMA: the plain version's separate
// operations).
template <typename T, bool kSparse>
__device__ __forceinline__ T apc_out(Acc<T> x, Acc<T> xb, Acc<T> gamma,
                                     Acc<T> c) {
  if constexpr (kSparse && std::is_same_v<T, __nv_bfloat16>) {
    const float y0 = __bfloat162float(__float2bfloat16_rn(
        __fadd_rn(x, __fmul_rn(gamma, __fsub_rn(xb, x)))));
    const float c16 = __bfloat162float(__float2bfloat16_rn(c));
    return __float2bfloat16_rn(__fsub_rn(y0, __fmul_rn(gamma, c16)));
  } else {
    const Acc<T> d = xb - x;
    return narrow<T>(x + gamma * (d - c));
  }
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
// gather_ring_smem's forms: a stage of X̄ and X (kApcForm), of X̄, U or V
// alone (kCimminoForm), and the same in the tensor-core form's layout
// (kApcMmaForm: apc_gather; kCimminoMmaForm: the dense bf16/f64 Cimmino
// pair and apc_scatter, and the f64 cimmino_scatter); the sparse
// gathers' stage of their support operand (kSparseForm); sparse_scatter's
// (kSparseScatterForm: its tensor-core forms' stage holds two units'
// operand rows)
constexpr int64_t kApcForm = 0, kCimminoForm = 1, kApcMmaForm = 2,
                  kCimminoMmaForm = 3, kSparseForm = 4,
                  kSparseScatterForm = 5;
constexpr int kRingWarps = 8;                      // consumer warps
constexpr int kRingWarpRows = 8;
constexpr int kRingRows = kRingWarps * kRingWarpRows;
constexpr int kRingLoaders = 4;                    // producer warps
constexpr int kRingThreads = 32 * (kRingWarps + kRingLoaders);
constexpr int kRingSegment = 512;       // bytes of an operand row a stage
constexpr int kRingBudget = 200 * 1024;
constexpr int kRingMaxStages = 16;

// The forms whose products run on the FP64 tensor cores (header): the
// kernels with a bf16 matrix and float64 operands (apc_gather,
// apc_scatter, cimmino_gather, cimmino_scatter, the two sparse gathers
// and sparse_scatter).
template <typename TM, typename T>
constexpr bool kMmaForm = std::is_same_v<TM, __nv_bfloat16> &&
                          std::is_same_v<T, double>;

// The float64 Cimmino scatter (cimmino_scatter_f64) on the same
// consumer, its matrix read as float64 fragments (header).  kAxpy: the
// dense APC scatter's epilogue, which keeps its DFMA ring.
template <typename TM, typename T, bool kAxpy>
constexpr bool kMmaF64Form = std::is_same_v<TM, double> &&
                             std::is_same_v<T, double> && !kAxpy;

// The sparse kernels' FP64 tensor-core consumer (header): the form in
// bf16/f64 and in f64 (float64 fragments, as the float64 Cimmino
// scatter's: a probe on the card timed the sparse gathers' level with
// the 64-row DFMA ring at k = 1 and 6 % ahead at k = 8, PERF.md); the
// FFMA ring in f32, bf16/f32 and, for the gathers, bf16/bf16.
template <typename TM, typename T>
constexpr bool kSparseMma =
    kMmaForm<TM, T> ||
    (std::is_same_v<TM, double> && std::is_same_v<T, double>);

// The all-bf16 form on the bf16 tensor cores (mma.sync m16n8k16, float32
// accumulators; header): sparse_scatter's.
template <typename TM, typename T>
constexpr bool kBf16Mma = std::is_same_v<TM, __nv_bfloat16> &&
                          std::is_same_v<T, __nv_bfloat16>;

// sparse_scatter's tensor-core forms, both instances, both epilogues.
template <typename TM, typename T>
constexpr bool kSparseScatterMma = kSparseMma<TM, T> || kBf16Mma<TM, T>;

// The tensor-core form's tile: each consumer warp owns 32 of its rows
// (two mmas of 16) against every column; a stage takes 128 bytes of each
// matrix row (half a 256-byte L2 block): 64 bf16 or 16 float64 columns.
constexpr int kMmaWarpRows = 32;
constexpr int kMmaRows = kRingWarps * kMmaWarpRows;
constexpr int kMmaSegment = 128;

// Where the tensor-core form's producers store piece j of matrix row r
// and of operand row kk (X̄ row kk, or X row kk): ldmatrix reads one
// piece of each of 8 consecutive bf16 rows (a bf16 operand's rows too),
// and a 16-byte load's phase the same piece of two consecutive operand
// rows (or float64 matrix rows: a lane's pair of columns), each in a
// bank group of its own.
__host__ __device__ constexpr int mma_matrix_piece(int r, int j) {
  return j ^ (r & 7);
}
__host__ __device__ constexpr int mma_operand_piece(int kk, int j) {
  return j ^ ((kk & 1) << 2);
}

// A stage holds C = kCols columns: M[rows][kCols] in TM (kRingRows rows,
// kMmaRows under kMma), then X̄[KC][kCols] and, under kDiff, X[KC][kCols]
// in T (kOperandRows rows of the right operand, kOperandBytes each: 512,
// or 128 in the float64 tensor-core form).  A matrix row segment is
// kPieces 16-byte copies.  Under kMma (the tensor-core form) the
// producers store their pieces swizzled (matrix_piece,
// mma_operand_piece).
template <typename TM, typename T, int KC, bool kDiff, bool kMma = false>
struct Ring {
  static constexpr int kRows = kMma ? kMmaRows : kRingRows;
  static constexpr int kCols = kMma ? kMmaSegment / sizeof(TM)
                                    : kRingSegment / sizeof(T);
  static constexpr int kRowBytes = kCols * sizeof(TM);
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kMatrixBytes = kRows * kRowBytes;
  static constexpr int kOperandRows = (kDiff ? 2 : 1) * KC;
  static constexpr int kOperandBytes = kCols * sizeof(T);
  static constexpr int kStageBytes =
      kMatrixBytes + kOperandRows * kOperandBytes;
  static constexpr int kStages =
      static_cast<int>(min64(kRingBudget / kStageBytes, kRingMaxStages));
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStages >= 2 && kCols % 8 == 0 && 32 % kPieces == 0 &&
                    (kMma || kCols % 32 == 0),
                "ring shape");
  static_assert(!kMma || kPieces == 8, "a matrix row segment is 8 pieces");
  // The place of piece j of matrix row r under kMma: ldmatrix's layout
  // for a bf16 matrix, the operand's for a float64 one.
  __host__ __device__ static constexpr int matrix_piece(int r, int j) {
    return sizeof(TM) == 2 ? mma_matrix_piece(r, j) : mma_operand_piece(r, j);
  }
  // The place of piece j of operand row kk under kMma: ldmatrix's layout
  // for a bf16 operand (the all-bf16 form), the 16-byte loads' for a
  // float64 one.
  __host__ __device__ static constexpr int operand_piece(int kk, int j) {
    return sizeof(T) == 2 ? mma_matrix_piece(kk, j)
                          : mma_operand_piece(kk, j);
  }
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
// the matrix widened, its packed row dot is not.  (The tensor-core
// form's scatters have neither: their two instances are bit-identical.)
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
// X̄[i, g] (Cimmino, X unused), i = k0 + kk, at the column g = c0 + c,
// in the accumulator type.
template <typename T, int KC, bool kDiff>
struct StageXbar {
  using TA = Acc<T>;
  const T* X;
  const T* Xbar;
  int64_t n, kvalid, sx_k, sxb_k;
  __device__ void operator()(int64_t c0, TA (*Vs)[kChunk]) const {
    for (int idx = threadIdx.x; idx < KC * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int64_t col = c0 + c;
      TA v = TA(0);
      if (kk < kvalid && col < n) {
        v = widen<TA>(Xbar[kk * sxb_k + col]);
        if constexpr (kDiff) v -= widen<TA>(X[kk * sx_k + col]);
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
// block's 8 R rows l of A_w (p x n; vals_w, p x w, for the sparse
// gathers) against the X̄-staged operand, X̄ at Xbar + w·sxb_w (the
// sparse gathers' support operand in TX = Acc<T>; dense: TX = T, one X̄
// for every worker, sxb_w = 0).
// grid (ceil(p / (8 R)), m, ceil(k / KC))
template <typename TM, typename T, int KC, int R, bool kDiff,
          typename TX = T>
__device__ __forceinline__ void gather_block(
    const TM* __restrict__ A, const TX* __restrict__ X,
    const TX* __restrict__ Xbar, T* __restrict__ U, int64_t p, int64_t n,
    int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_w, int64_t sxb_k,
    int64_t su_w, int64_t su_k, Acc<T> (*Vs)[kChunk]) {
  const int64_t w = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (kWarps * R);
  const int64_t kvalid = k - k0 < KC ? k - k0 : KC;
  StageXbar<TX, KC, kDiff> stage{kDiff ? X + w * sx_w + k0 * sx_k : X,
                                 Xbar + w * sxb_w + k0 * sxb_k, n, kvalid,
                                 sx_k, sxb_k};
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
        Yw[kk * sy_k + jo] = apc_out<T, kSparse>(
            widen<TA>(X[w * sx_w + (k0 + kk) * sx_k + jo]),
            widen<TA>(Xbar[(k0 + kk) * sxb_k + jo]), gamma, Cs[kk][jj]);
      } else {
        Yw[kk * sy_k + jo] = narrow<T>(Cs[kk][jj]);
      }
    }
  }
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

// The same, fetching the 256-byte L2 block around src from device memory
// (the tensor-core form's matrix rows: a stage takes 128 bytes of each,
// the next stage the next 128).
__device__ __forceinline__ void cp_async16_l2_256(void* dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
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
// batch rows k0 .. k0 + kvalid.  sparse_scatter's tensor-core walk
// (SpanWalk) lets a tile's rows run on into the next unit: its first
// `split` rows are the unit (w, k0)'s from row0, the rest the unit (w2,
// k02)'s from row 0 (split = rows in the tensor-core form's other
// walks; unset in the DFMA/FFMA ring's).
struct RingTile {
  int64_t w, k0, row0;
  int rows, kvalid;
  int split, kvalid2;
  int64_t w2, k02;
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

// A producer warp (pw of kRingLoaders): for every chunk of the tile, wait
// for its stage to empty, then copy its share into it, 16 bytes a lane —
// rows of M (a row segment is kPieces copies, so a warp copies
// 32 / kPieces rows at once: rows pw, pw + 4, ... in f64 and f32) and
// rows q = pw, pw + 4, ... of the right operand's KC (Cimmino) or 2·KC
// (kDiff) rows (X̄ row q, or X row q − KC) — and arrive on the stage's
// full barrier once they have landed.  Under kPerWorker (the scatters'
// U or V, the sparse gathers' support operand: the Cimmino form) the
// operand is worker w's own rows, at Xbar + w·sxb_w, not the one shared
// X̄.  `it` counts the block's (tile, chunk) steps: stage it % S, round
// it / S.  Under kMma each piece goes to its swizzled place
// (Ring::matrix_piece, Ring::operand_piece).  kSpan (sparse_scatter's
// tensor-core ring, per worker): a tile's rows from `split` on are the
// second unit's, rows past a unit's p are not copied (a unit's last
// 16-row group), and the second unit's KC operand rows go where the APC
// form's X rows go.
template <typename TM, typename T, int KC, bool kDiff, bool kPerWorker,
          bool kMma, bool kSpan = false>
__device__ __forceinline__ void ring_produce(
    const RingTile& tl, const TM* __restrict__ M, const T* __restrict__ X,
    const T* __restrict__ Xbar, int64_t p, int64_t n, int64_t sx_w,
    int64_t sx_k, int64_t sxb_w, int64_t sxb_k, uint32_t& it) {
  using Cfg = Ring<TM, T, KC, kDiff || kSpan, kMma>;
  static_assert(!kPerWorker || !kDiff, "a per-worker operand is one row");
  static_assert(!kSpan || (kMma && kPerWorker), "a span: the mma scatter");
  constexpr int C = Cfg::kCols;
  constexpr int kPer = 16 / sizeof(T);           // operand elements a piece
  constexpr int kMPer = 16 / sizeof(TM);         // matrix elements a piece
  constexpr int kRowsAtOnce = 32 / Cfg::kPieces;
  const int pw = threadIdx.x / 32 - kRingWarps;
  const int lane = threadIdx.x % 32;
  const int piece = lane % Cfg::kPieces;
  const TM* Mt = M + (tl.w * p + tl.row0) * n + piece * kMPer;
  // kSpan: the second unit's rows, tile row r at Mt2 + r·n; the rows
  // r < real of the first unit and r < real2 of the second hold data
  const TM* Mt2 = kSpan ? M + (tl.w2 * p - tl.split) * n + piece * kMPer
                       : nullptr;
  const int real = kSpan ? static_cast<int>(min64(tl.split, p - tl.row0)) : 0;
  const int64_t real2 = kSpan ? tl.split + p : 0;
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
    if (piece < mpieces)
      for (int r = pw * kRowsAtOnce + lane / Cfg::kPieces; r < tl.rows;
           r += kRingLoaders * kRowsAtOnce) {
        if constexpr (kSpan) {
          const bool first = r < tl.split;
          if (first ? r >= real : r >= real2) continue;
          cp_async16_l2_256(Ms + r * C + Cfg::matrix_piece(r, piece) * kMPer,
                            (first ? Mt : Mt2) + r * n + c0);
        } else if constexpr (kMma) {
          cp_async16_l2_256(Ms + r * C + Cfg::matrix_piece(r, piece) * kMPer,
                            Mt + r * n + c0);
        } else {
          cp_async16(Ms + r * C + piece * kMPer, Mt + r * n + c0);
        }
      }
    for (int q = pw; q < Cfg::kOperandRows; q += kRingLoaders) {
      const int kk = q % KC;
      const bool second = q >= KC;
      T* dst = (second ? Xs : XBs) + kk * C;
      const T* src;
      if constexpr (kSpan) {
        if (second ? tl.split >= tl.rows || kk >= tl.kvalid2
                   : kk >= tl.kvalid)
          continue;
        src = second ? Xbar + tl.w2 * sxb_w + (tl.k02 + kk) * sxb_k
                     : Xbar + tl.w * sxb_w + (tl.k0 + kk) * sxb_k;
      } else {
        if (kk >= tl.kvalid) continue;
        src = second ? X + tl.w * sx_w + (tl.k0 + kk) * sx_k
                     : Xbar + (tl.k0 + kk) * sxb_k;
        if constexpr (kPerWorker) src += tl.w * sxb_w;
      }
      if (lane < opieces)
        cp_async16(dst + (kMma ? Cfg::operand_piece(kk, lane) : lane) * kPer,
                   src + c0 + lane * kPer);
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
// The sparse APC form (f32 and bf16/f32: the other pairs take the
// tensor-core ring) reads its lane's cols[w, j] first and copies X and
// X̄ at that column so, but at KC = 1, whose short tree hides less than
// the cols load costs before it (a probe on the card: 5 % faster at
// KC = 8, 1 % slower at KC = 1, PERF.md); the sparse Cimmino form reads
// cols after the tree.
template <typename T, int KC, bool kAxpy, bool kSparse>
struct RingScatterStore {
  static constexpr int N = kRingWarpRows * KC;
  static constexpr int H = N >= 32 ? N / 32 : 1;   // sums a lane holds
  // a one-element cp.async moves 4, 8 or 16 bytes: a bf16 X reads after
  // the tree
  static constexpr bool kStaged =
      kAxpy && sizeof(T) >= 4 && !(kSparse && KC == 1);
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
  // q = l·N/32/H, ... of operator()), where it stores any; returns their
  // column (cols[w, j] under kSparse).
  __device__ __forceinline__ int64_t prefetch(const RingTile& tl, int r0,
                                              int lane) const {
    if constexpr (N < 32)
      if (lane % (32 / N) != 0) return 0;
    const int q = lane * N / 32 / H;
    const int r = q % kRingWarpRows;
    if (r0 + r >= tl.rows) return 0;
    const int64_t j = tl.row0 + r0 + r;
    const int64_t jo = kSparse ? cols[tl.w * rows + j] : j;
    T (*s)[32] = staged();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int kk = q / kRingWarpRows * H + h;
      if (kk >= tl.kvalid) continue;
      const int64_t i = tl.k0 + kk;
      cp_async_element(&s[2 * h][lane], X + tl.w * sx_w + i * sx_k + jo);
      cp_async_element(&s[2 * h + 1][lane], Xbar + i * sxb_k + jo);
    }
    return jo;
  }

  __device__ __forceinline__ void operator()(TA (&acc)[kRingWarpRows][KC],
                                             const RingWalk* walk, int r0,
                                             int lane) const {
    // the sparse form's column, read before the tree (the dense one's
    // is j, formed after it)
    constexpr bool kEarly = kStaged && kSparse;
    int64_t jo = 0;
    if constexpr (kEarly)
      jo = prefetch(walk->tl, r0, lane);
    else if constexpr (kStaged)
      prefetch(walk->tl, r0, lane);
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
    if constexpr (!kEarly) {
      const int64_t j = tl.row0 + r0 + r;
      jo = kSparse ? cols[tl.w * rows + j] : j;
    }
    if constexpr (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int kk = q / kRingWarpRows * H + h;
      if (kk >= tl.kvalid) continue;
      const int64_t i = tl.k0 + kk;
      T* y = Y + tl.w * sy_w + i * sy_k + jo;
      if constexpr (kStaged) {
        *y = apc_out<T, kSparse>(staged()[2 * h][lane],
                                 staged()[2 * h + 1][lane], gamma, v[h]);
      } else if constexpr (kAxpy) {
        *y = apc_out<T, kSparse>(widen<TA>(X[tl.w * sx_w + i * sx_k + jo]),
                                 widen<TA>(Xbar[i * sxb_k + jo]), gamma,
                                 v[h]);
      } else {
        *y = narrow<T>(v[h]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The tensor-core form: the dense APC pair, bf16 matrix, float64 operands
// (see the header)
// ---------------------------------------------------------------------------

// D += A·B on the FP64 tensor cores, mma.sync m16n8k8: A (16 x 8) in
// a0..a3, B (8 x 8) in b0, b1, D (16 x 8) in d0..d3.  Lane 4g + t holds
// A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B[t][g],
// B[t + 4][g]; D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory: lanes
// 8i .. 8i + 7 name the rows of matrix i, and lane 4g + t receives in
// r[i] the 32-bit word t of row g of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same for two matrices (lanes 0 .. 15 name their rows).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

// D += A·B on the bf16 tensor cores with float32 accumulators,
// mma.sync m16n8k16: A (16 x 16 bf16) in a0..a3, B (16 x 8) in b0, b1, D
// (16 x 8 float32) in d0..d3.  Lane 4g + t holds the bf16 pairs
// A[g][2t, 2t + 1], A[g + 8][2t, ..], A[g][2t + 8, ..], A[g + 8][2t + 8,
// ..]; B[2t, 2t + 1][g], B[2t + 8, 2t + 9][g]; and D as mma_f64 does.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two bf16 of a 32-bit word (the low half first) as float64, exactly,
// through float32 (F2F.F64.F32; the integer construction of the header's
// widen note was slower here too: scripts/probe_mma_widen.py).
__device__ __forceinline__ void widen_pair(uint32_t w, double& lo,
                                           double& hi) {
  lo = static_cast<double>(__uint_as_float(w << 16));
  hi = static_cast<double>(__uint_as_float(w & 0xffff0000u));
}

// One k-step of a consumer warp: 8 columns (the mma's k) of its 32 rows
// (two mmas of 16) against the 8 batch rows (n; zero past the tile's).
// w[i] holds rows 8i + g, columns 2t and 2t + 1 of the 8: k-slot t is
// column 2t and slot t + 4 column 2t + 1, so each bf16 word feeds a0
// and a2 (or a1 and a3), and b = (D[g][2t], D[g][2t + 1]); rows 16rb ..
// 16rb + 15 take b0 (rb = 0) or b1 (a span's second unit may start at
// row 16).
__device__ __forceinline__ void mma_rows(double (&acc)[2][4],
                                         const uint32_t (&w)[4],
                                         const double (&b0)[2],
                                         const double (&b1)[2]) {
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
    double a[4];
    widen_pair(w[2 * rb], a[0], a[2]);
    widen_pair(w[2 * rb + 1], a[1], a[3]);
    mma_f64(acc[rb], a, rb ? b1 : b0);
  }
}

// The same with a float64 matrix: f[i] holds rows 8i + g, columns 2t
// and 2t + 1 of the 8, each fed to the mma as it is.
__device__ __forceinline__ void mma_rows(double (&acc)[2][4],
                                         const double (&f)[4][2],
                                         const double (&b0)[2],
                                         const double (&b1)[2]) {
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
    const double a[4] = {f[2 * rb][0], f[2 * rb + 1][0], f[2 * rb][1],
                         f[2 * rb + 1][1]};
    mma_f64(acc[rb], a, rb ? b1 : b0);
  }
}

// The ring's k-steps of one stage (Ring<..., kMma>), those below its nv
// valid columns, in column order, and the operand's pair of columns (X̄,
// or X̄ − X under kDiff) through one 16-byte load each, from their
// swizzled places.  A bf16 matrix: the warp's 32 rows of the k-step's
// piece through one ldmatrix.x4; a float64 one (16 columns, two k-steps,
// a stage): a lane's pair of columns of each of its 4 rows through a
// 16-byte load, both pairs zero past nv (a float64 row is a 16-byte
// multiple, so nv is even, not a multiple of 8).  live[rb]: this lane's
// batch row is one of the tile's; under kSpan rows 16rb .. 16rb + 15
// take the operand rows of set[rb] (0: the tile's first unit, 1: its
// second, stored where the APC form's X rows are), live[rb] by that
// unit's batch rows.
template <typename TM, int KC, bool kDiff, bool kSpan = false>
__device__ __forceinline__ void mma_stage(const unsigned char* stage,
                                          int64_t nv, const int (&set)[2],
                                          const bool (&live)[2],
                                          double (&acc)[2][4]) {
  using Cfg = Ring<TM, double, KC, kDiff || kSpan, true>;
  static_assert(!(kDiff && kSpan), "a span: the Cimmino form's operand");
  constexpr bool kWide = sizeof(TM) == 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32);
  const int row = r0 + lane;
  const unsigned char* mrow = stage + row * Cfg::kRowBytes;
  const double* xb_row0 =
      reinterpret_cast<const double*>(stage + Cfg::kMatrixBytes);
  const double* xb = xb_row0 + g * Cfg::kCols;
#pragma unroll
  for (int s = 0; s < Cfg::kCols / 8; ++s) {
    if (8 * s >= nv) break;
    const bool valid = !kWide || 8 * s + 2 * t < nv;
    double b[2][2] = {};
    if constexpr (kSpan) {
      // without a branch: every lane loads its pair from a row of each
      // set (its batch row, or row 0 past KC) and keeps it where live (a
      // branch a set here compiled to divergent loads the mmas waited
      // on, 11 % slower at KC = 1 in a probe on the card, PERF.md)
      const double* v = xb_row0 + (g < KC ? g : 0) * Cfg::kCols +
                        2 * mma_operand_piece(g, 4 * s + t);
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        const double2 e = *reinterpret_cast<const double2*>(
            v + set[rb] * KC * Cfg::kCols);
        const bool keep = live[rb] && valid;
        b[rb][0] = keep ? e.x : 0.0;
        b[rb][1] = keep ? e.y : 0.0;
      }
    } else {
      if (live[0] && valid) {
        const double* v = xb + 2 * mma_operand_piece(g, 4 * s + t);
        const double2 e = *reinterpret_cast<const double2*>(v);
        b[0][0] = e.x;
        b[0][1] = e.y;
        if constexpr (kDiff) {
          const double2 x =
              *reinterpret_cast<const double2*>(v + KC * Cfg::kCols);
          b[0][0] -= x.x;
          b[0][1] -= x.y;
        }
      }
      b[1][0] = b[0][0];
      b[1][1] = b[0][1];
    }
    if constexpr (kWide) {
      double f[4][2] = {};
      if (valid)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * i + g;
          const double2 e = *reinterpret_cast<const double2*>(
              stage + r * Cfg::kRowBytes +
              Cfg::matrix_piece(r, 4 * s + t) * 16);
          f[i][0] = e.x;
          f[i][1] = e.y;
        }
      mma_rows(acc, f, b[0], b[1]);
    } else {
      uint32_t w[4];
      ldmatrix_x4(w, mrow + Cfg::matrix_piece(row, s) * 16);
      mma_rows(acc, w, b[0], b[1]);
    }
  }
}

// The row dot's fragments of the k-step at column c, the same values
// read from global memory: the warp's rows of M (rows x n, row-major;
// zero past `rows` and n) and the operand X̄ (rows g of Xb, sxb_k
// apart), minus X under kDiff, zero past n and outside the live batch
// rows.
template <typename TM, bool kDiff>
__device__ __forceinline__ void mma_global(
    const TM* __restrict__ M, int rows, int64_t n, int64_t c,
    const double* __restrict__ Xb, const double* __restrict__ X,
    int64_t sxb_k, int64_t sx_k, bool live, double (&acc)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32);
  const int64_t cc = c + 2 * (lane % 4);
  uint32_t w[4];
  double f[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 8 * i + g;
    if constexpr (sizeof(TM) == 8) {
      f[i][0] = r < rows && cc < n ? M[r * n + cc] : 0.0;
      f[i][1] = r < rows && cc + 1 < n ? M[r * n + cc + 1] : 0.0;
    } else {
      const uint16_t* bits = reinterpret_cast<const uint16_t*>(M);
      const uint32_t lo = r < rows && cc < n ? bits[r * n + cc] : 0u;
      const uint32_t hi = r < rows && cc + 1 < n ? bits[r * n + cc + 1] : 0u;
      w[i] = lo | hi << 16;
    }
  }
  double b[2] = {0.0, 0.0};
  if (live) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (cc + e < n) {
        b[e] = Xb[g * sxb_k + cc + e];
        if constexpr (kDiff) b[e] -= X[g * sx_k + cc + e];
      }
  }
  if constexpr (sizeof(TM) == 8)
    mma_rows(acc, f, b, b);
  else
    mma_rows(acc, w, b, b);
}

// The all-bf16 form's k-steps of one stage (Ring<bf16, bf16, KC, kSpan,
// true>: 64 columns, four k-steps of 16), those below its nv valid
// columns (a multiple of 8), in column order, on the bf16 tensor cores:
// the warp's 32 rows of a k-step through two ldmatrix.x4 (rows 16rb ..
// 16rb + 15, the step's two pieces), the operand's through one
// ldmatrix.x2 (the KC rows of set[rb], the same two pieces; lanes past
// KC name row 0, and every batch row past the tile's is zero: live[rb],
// as mma_stage's).  A step whose upper 8 columns are past nv takes zeros
// there in both fragments: the stage holds another stage's bytes past
// nv.
template <int KC, bool kSpan>
__device__ __forceinline__ void mma_stage_bf16(const unsigned char* stage,
                                               int64_t nv,
                                               const int (&set)[2],
                                               const bool (&live)[2],
                                               float (&acc)[2][4]) {
  using Cfg = Ring<__nv_bfloat16, __nv_bfloat16, KC, kSpan, true>;
  const int lane = threadIdx.x % 32;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32);
  const int kk = lane % 8 < KC ? lane % 8 : 0;
  const unsigned char* orow =
      stage + Cfg::kMatrixBytes + kk * Cfg::kOperandBytes;
  const bool two = kSpan && set[1] != set[0];
#pragma unroll
  for (int s = 0; s < Cfg::kCols / 16; ++s) {
    if (16 * s >= nv) break;
    const bool upper = 16 * s + 8 < nv;
    const int piece = Cfg::operand_piece(kk, 2 * s + lane / 8 % 2) * 16;
    uint32_t b[2][2];
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      if (rb == 1 && !two) {
        b[1][0] = b[0][0];
        b[1][1] = b[0][1];
        continue;
      }
      ldmatrix_x2(b[rb], orow + set[rb] * KC * Cfg::kOperandBytes + piece);
      if (!live[rb]) b[rb][0] = b[rb][1] = 0u;
      if (!upper) b[rb][1] = 0u;
    }
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      const int row = r0 + 16 * rb + lane % 16;
      uint32_t a[4];
      ldmatrix_x4(a, stage + row * Cfg::kRowBytes +
                         Cfg::matrix_piece(row, 2 * s + lane / 16) * 16);
      if (!upper) a[2] = a[3] = 0u;
      mma_bf16(acc[rb], a, b[rb]);
    }
  }
}

// The all-bf16 row dot's fragments of the k-step at column c, the same
// values read from global memory: the warp's rows of M (rows x n; zero
// past `rows` and n) and the operand (rows g of Xb, sxb_k apart; zero
// past n and outside the live batch rows).
__device__ __forceinline__ void mma_global_bf16(
    const __nv_bfloat16* __restrict__ M, int rows, int64_t n, int64_t c,
    const __nv_bfloat16* __restrict__ Xb, int64_t sxb_k, bool live,
    float (&acc)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32);
  const int64_t cc = c + 2 * (lane % 4);
  const uint16_t* mb = reinterpret_cast<const uint16_t*>(M);
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(Xb) + g * sxb_k;
  // the bf16 pair at columns j, j + 1 of a row, zero past n
  const auto pair = [n](const uint16_t* row, bool ok, int64_t j) {
    const uint32_t lo = ok && j < n ? row[j] : 0u;
    const uint32_t hi = ok && j + 1 < n ? row[j + 1] : 0u;
    return lo | hi << 16;
  };
  const uint32_t b[2] = {pair(xb, live, cc), pair(xb, live, cc + 8)};
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
    const int ra = r0 + 16 * rb + g, rc = ra + 8;
    const uint16_t* Ma = mb + ra * n;
    const uint16_t* Mc = mb + rc * n;
    const uint32_t a[4] = {pair(Ma, ra < rows, cc), pair(Mc, rc < rows, cc),
                           pair(Ma, ra < rows, cc + 8),
                           pair(Mc, rc < rows, cc + 8)};
    mma_bf16(acc[rb], a, b);
  }
}

// Calls f(row in the tile, batch row kk, sum) for each of this lane's
// sums: d0..d3 of the warp's two mmas, rows r0 + 16rb + g (+ 8) and
// batch rows 2t, 2t + 1 (float64 m16n8k8 and float32 m16n8k16 alike).
template <typename TA, typename F>
__device__ __forceinline__ void mma_sums(const TA (&acc)[2][4], F f) {
  const int lane = threadIdx.x % 32;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f(r0 + 16 * rb + 8 * (i >> 1), 2 * (lane % 4) + (i & 1), acc[rb][i]);
}

// An epilogue's values loaded as a tile starts, before its stages
// (`load`), handed to the epilogue after them: none for the dense ones.
struct NoPre {};

// The plain epilogue, from the fragment: each sum stored as it is at
// out[w, k0 + kk, row0 + r] (the gathers' U, the Cimmino scatter's R).
struct MmaStore {
  double* __restrict__ out;
  int64_t so_w, so_k;
  __device__ __forceinline__ NoPre load(const RingTile&) const { return {}; }
  __device__ __forceinline__ void operator()(const double (&acc)[2][4],
                                             const RingTile& tl,
                                             NoPre) const {
    double* Ot = out + tl.w * so_w + tl.k0 * so_k + tl.row0;
    mma_sums(acc, [&](int r, int kk, double sum) {
      if (r < tl.rows && kk < tl.kvalid) Ot[kk * so_k + r] = sum;
    });
  }
};

// The scatter's epilogue, fused: Y = X + γ((X̄ − X) − C) at the tile's
// rows j = row0 + r of batch row k0 + kk, all of a lane's X and X̄
// loaded before the first store.
struct MmaScatterStore {
  const double* __restrict__ X;
  const double* __restrict__ Xbar;
  double gamma;
  double* __restrict__ Y;
  int64_t sx_w, sx_k, sxb_k, sy_w, sy_k;
  __device__ __forceinline__ NoPre load(const RingTile&) const { return {}; }
  __device__ __forceinline__ void operator()(const double (&acc)[2][4],
                                             const RingTile& tl,
                                             NoPre) const {
    const double* Xt = X + tl.w * sx_w + tl.k0 * sx_k + tl.row0;
    const double* Xbt = Xbar + tl.k0 * sxb_k + tl.row0;
    double x[2][4] = {}, xb[2][4] = {};
    int q = 0;
    mma_sums(acc, [&](int r, int kk, double) {
      if (r < tl.rows && kk < tl.kvalid) {
        x[q / 4][q % 4] = Xt[kk * sx_k + r];
        xb[q / 4][q % 4] = Xbt[kk * sxb_k + r];
      }
      ++q;
    });
    double* Yt = Y + tl.w * sy_w + tl.k0 * sy_k + tl.row0;
    q = 0;
    mma_sums(acc, [&](int r, int kk, double c) {
      if (r < tl.rows && kk < tl.kvalid)
        Yt[kk * sy_k + r] =
            apc_out<double, false>(x[q / 4][q % 4], xb[q / 4][q % 4], gamma,
                                   c);
      ++q;
    });
  }
};

// sparse_scatter's epilogue from the fragment, both forms (header): at
// out[w, k0 + kk, cols[w, j]] for the tile's rows j of each unit, C as it
// is (the Cimmino form), or X + γ((X̄ − X) − C) under kAxpy with the
// rounding of apc_out<T, true>.  `read` reads the lane's 4 rows' cols
// and, under kAxpy, its 8 X and X̄ at them; in the float64 forms (kEarly)
// `load` reads them as the tile starts, so their latency hides behind
// the tile's stages (a block walks one tile at the sparse path's
// shapes), while the all-bf16 form reads them after its stages (a probe
// on the card timed its APC form 4 % faster so at k = 8, the float64
// forms 0–3 % slower, PERF.md).  Lane 4g + t holds tile rows r0 + g + 8i
// (i = 2rb + h, mma_sums' order) and batch rows 2t + e; rows 16rb ..
// 16rb + 15 are the second unit's from `split` on (SpanWalk), and a row
// past its unit's `rows` (a unit's last 16-row group) is none.
template <typename T, bool kAxpy>
struct MmaSparseStore {
  using TA = Acc<T>;
  static constexpr bool kEarly = sizeof(T) == 8;
  const int64_t* __restrict__ cols;
  const T* __restrict__ X;
  const T* __restrict__ Xbar;
  TA gamma;
  T* __restrict__ Y;
  int64_t rows, sx_w, sx_k, sxb_k, sy_w, sy_k;
  struct Pre {
    int64_t jo[4];
    TA x[kAxpy ? 8 : 1], xb[kAxpy ? 8 : 1];
  };
  // The unit of the lane's row slot i, its row j there (−1: none), and
  // whether batch row kk is one of the unit's.
  struct Slot {
    int64_t w, k0, j;
    int kvalid;
  };
  __device__ __forceinline__ Slot slot(const RingTile& tl, int i) const {
    const int r = kMmaWarpRows * (threadIdx.x / 32) + threadIdx.x % 32 / 4 +
                  8 * i;
    const bool first = kMmaWarpRows * (threadIdx.x / 32) + 16 * (i / 2) <
                       tl.split;
    Slot sl{first ? tl.w : tl.w2, first ? tl.k0 : tl.k02,
            first ? tl.row0 + r : r - tl.split,
            first ? tl.kvalid : tl.kvalid2};
    if (r >= tl.rows || sl.j >= rows) sl.j = -1;
    return sl;
  }
  __device__ __forceinline__ Pre read(const RingTile& tl) const {
    const int t = threadIdx.x % 4;
    Pre pre;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Slot sl = slot(tl, i);
      pre.jo[i] = sl.j < 0 ? 0 : cols[sl.w * rows + sl.j];
      if constexpr (kAxpy) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 2 * t + e;
          const bool ok = sl.j >= 0 && kk < sl.kvalid;
          const int64_t kr = sl.k0 + kk;
          pre.x[2 * i + e] =
              ok ? widen<TA>(X[sl.w * sx_w + kr * sx_k + pre.jo[i]]) : TA(0);
          pre.xb[2 * i + e] =
              ok ? widen<TA>(Xbar[kr * sxb_k + pre.jo[i]]) : TA(0);
        }
      }
    }
    return pre;
  }
  __device__ __forceinline__ Pre load(const RingTile& tl) const {
    if constexpr (kEarly) return read(tl);
    return Pre{};
  }
  __device__ __forceinline__ void operator()(const TA (&acc)[2][4],
                                             const RingTile& tl,
                                             const Pre& early) const {
    const Pre pre = kEarly ? early : read(tl);
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Slot sl = slot(tl, i);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * t + e;
        if (sl.j < 0 || kk >= sl.kvalid) continue;
        const TA c = acc[i / 2][2 * (i % 2) + e];
        T* y = Y + sl.w * sy_w + (sl.k0 + kk) * sy_k + pre.jo[i];
        if constexpr (kAxpy)
          *y = apc_out<T, true>(pre.x[2 * i + e], pre.xb[2 * i + e], gamma,
                                c);
        else
          *y = narrow<T>(c);
      }
    }
  }
};

// A block's whole tiles in the tensor-core form (header): the tiles
// [t, t_end) of T = units·per, tile t from row 256·(t % per) of unit t /
// per, at most 256 rows.  A unit is a (worker, k-chunk) pair,
// worker-major; `rows` is the matrix's rows a worker.  Block b of G takes
// the tiles [T·b / G, T·(b + 1) / G).
struct MmaWalk {
  int64_t t, t_end, per;

  template <int KC>
  __device__ __forceinline__ static MmaWalk of(int64_t m, int64_t rows,
                                               int64_t k) {
    const int64_t per = (rows + kMmaRows - 1) / kMmaRows;
    const int64_t tiles = m * ((k + KC - 1) / KC) * per;
    return {tiles * blockIdx.x / gridDim.x,
            tiles * (blockIdx.x + 1) / gridDim.x, per};
  }

  template <int KC>
  __device__ __forceinline__ bool next(RingTile& tl, int64_t rows,
                                       int64_t k) {
    if (t >= t_end) return false;
    const int64_t unit = t / per, k_tiles = (k + KC - 1) / KC;
    tl.w = unit / k_tiles;
    tl.k0 = unit % k_tiles * KC;
    tl.row0 = t % per * kMmaRows;
    tl.rows = static_cast<int>(min64(rows - tl.row0, kMmaRows));
    tl.kvalid = static_cast<int>(min64(k - tl.k0, KC));
    tl.split = tl.rows;
    ++t;
    return true;
  }
};

// sparse_scatter's walk (kSpan, header): a worker's rows rarely end on a
// tile (the sparse path's 2064 = 8·256 + 16), and whole tiles a block
// gave 12 of 132 blocks two at its shapes, while a part tile costs its
// stages, not its rows.  Here the units' rows go in 16-row groups (a
// unit's last group padded past its rows: per = ceil(rows / 16) a unit),
// block b takes the groups [Gt·b / G, Gt·(b + 1) / G) of the Gt =
// units·per, and cuts them into tiles of at most 16 groups that span at
// most two units: one tile of 240 or 256 rows a block at the sparse
// path's shapes (1.02 times the mean), each stage of it 256 rows'
// worth.
struct SpanWalk {
  int64_t g, end, per;

  template <int KC>
  __device__ __forceinline__ static SpanWalk of(int64_t m, int64_t rows,
                                                int64_t k) {
    const int64_t per = (rows + 15) / 16;
    const int64_t groups = m * ((k + KC - 1) / KC) * per;
    return {groups * blockIdx.x / gridDim.x,
            groups * (blockIdx.x + 1) / gridDim.x, per};
  }

  template <int KC>
  __device__ __forceinline__ bool next(RingTile& tl, int64_t, int64_t k) {
    if (g >= end) return false;
    const int64_t unit = g / per, k_tiles = (k + KC - 1) / KC;
    const int64_t stop =
        min64(min64(end, g + kMmaRows / 16), (unit + 2) * per);
    tl.w = unit / k_tiles;
    tl.k0 = unit % k_tiles * KC;
    tl.row0 = (g - unit * per) * 16;
    tl.rows = static_cast<int>(stop - g) * 16;
    tl.kvalid = static_cast<int>(min64(k - tl.k0, KC));
    tl.split = static_cast<int>(min64(stop, (unit + 1) * per) - g) * 16;
    tl.w2 = (unit + 1) / k_tiles;
    tl.k02 = (unit + 1) % k_tiles * KC;
    tl.kvalid2 = static_cast<int>(min64(k - tl.k02, KC));
    g = stop;
    return true;
  }
};

// A consumer warp of the tensor-core ring, over its block's walk
// (MmaWalk, or SpanWalk under kSpan): its 32 rows of each tile against
// every stage as it lands, then `store` (MmaStore, MmaScatterStore,
// MmaSparseStore) with what its `load` read as the tile started.  A warp
// with no rows in the tile still waits for and releases every stage.  T:
// double (the FP64 tensor cores), or bf16 (the all-bf16 form, float32
// sums).
template <typename TM, typename T, int KC, bool kDiff, bool kSpan,
          typename Walk, typename Store>
__device__ __forceinline__ void mma_consume(Walk walk, int64_t p, int64_t n,
                                            int64_t k, Store store) {
  using Cfg = Ring<TM, T, KC, kDiff || kSpan, true>;
  static_assert(sizeof(T) == 8 || !kDiff, "the all-bf16 ring: Cimmino form");
  const int lane = threadIdx.x % 32;
  const int r0 = kMmaWarpRows * (threadIdx.x / 32);
  uint32_t it = 0;
  for (RingTile tl; walk.template next<KC>(tl, p, k);) {
    const bool active = r0 < tl.rows;
    int set[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      if (kSpan) set[rb] = r0 + 16 * rb >= tl.split;
      live[rb] = lane / 4 < (set[rb] ? tl.kvalid2 : tl.kvalid);
    }
    const auto pre = store.load(tl);
    Acc<T> acc[2][4] = {};
    for (int64_t c0 = 0; c0 < n; c0 += Cfg::kCols, ++it) {
      const int s = it % Cfg::kStages;
      mbar_wait(&ring_full[s], (it / Cfg::kStages) & 1);
      if (active) {
        const unsigned char* stage = ring_smem + s * Cfg::kStageBytes;
        if constexpr (sizeof(T) == 2)
          mma_stage_bf16<KC, kSpan>(stage, n - c0, set, live, acc);
        else
          mma_stage<TM, KC, kDiff, kSpan>(stage, n - c0, set, live, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring_empty[s]);
    }
    if (active) store(acc, tl, pre);
  }
}

// The row dot of the tensor-core form: block (x, w, k-chunk) is the tile
// of the 256 rows row0 = 256x .. of M_w (rows x n) against batch rows
// k0 = KC·(k-chunk) .., each warp its 32 rows against the same k-steps
// in the same order, with the same epilogue: bit for bit the ring's
// sums, from fragments loaded straight from global memory (any shape,
// any alignment).  M is the worker stack (m, rows, n), Xb the operand
// rows (X̄, or U_w / V_w at w·sxb_w), X the APC gather's (null
// otherwise); T as mma_consume's.
template <typename TM, typename T, int KC, bool kDiff, typename Store>
__device__ __forceinline__ void mma_row_dot(
    const TM* __restrict__ M, const T* __restrict__ X,
    const T* __restrict__ Xb, int64_t rows, int64_t n, int64_t k,
    int64_t sx_w, int64_t sx_k, int64_t sxb_w, int64_t sxb_k,
    Store store) {
  RingTile tl;
  tl.w = blockIdx.y;
  tl.k0 = static_cast<int64_t>(blockIdx.z) * KC;
  tl.row0 = static_cast<int64_t>(blockIdx.x) * kMmaRows;
  tl.rows = static_cast<int>(min64(rows - tl.row0, kMmaRows));
  tl.kvalid = static_cast<int>(min64(k - tl.k0, KC));
  tl.split = tl.rows;
  if (kMmaWarpRows * static_cast<int>(threadIdx.x / 32) >= tl.rows) return;
  const bool live = threadIdx.x % 32 / 4 < tl.kvalid;
  const TM* Mt = M + (tl.w * rows + tl.row0) * n;
  const T* Xbt = Xb + tl.w * sxb_w + tl.k0 * sxb_k;
  const T* Xt = kDiff ? X + tl.w * sx_w + tl.k0 * sx_k : nullptr;
  const auto pre = store.load(tl);
  Acc<T> acc[2][4] = {};
  if constexpr (sizeof(T) == 2) {
    static_assert(!kDiff, "the all-bf16 row dot: Cimmino form");
    for (int64_t c = 0; c < n; c += 16)
      mma_global_bf16(Mt, tl.rows, n, c, Xbt, sxb_k, live, acc);
  } else {
    for (int64_t c = 0; c < n; c += 8)
      mma_global<TM, kDiff>(Mt, tl.rows, n, c, Xbt, Xt, sxb_k, sx_k, live,
                            acc);
  }
  store(acc, tl, pre);
}

// The dense kernels' row-dot kernels: in the tensor-core forms the row
// dot above, 256 rows a block; in every other form the row dot of
// gather_block and scatter_block.
template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_gather_kernel(const TM* __restrict__ A, const T* __restrict__ X,
                  const T* __restrict__ Xbar, T* __restrict__ U,
                  int64_t p, int64_t n, int64_t k, int64_t sx_w,
                  int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k) {
  if constexpr (kMmaForm<TM, T>) {
    mma_row_dot<TM, T, KC, true>(A, X, Xbar, p, n, k, sx_w, sx_k, 0, sxb_k,
                                 MmaStore{U, su_w, su_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    gather_block<TM, T, KC, R, true>(A, X, Xbar, U, p, n, k, sx_w, sx_k, 0,
                                     sxb_k, su_w, su_k, Vs);
  }
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apc_scatter_kernel(const TM* __restrict__ B, const T* __restrict__ X,
                   const T* __restrict__ Xbar, const T* __restrict__ U,
                   Acc<T> gamma, T* __restrict__ Y, int64_t n, int64_t p,
                   int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                   int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  if constexpr (kMmaForm<TM, T>) {
    mma_row_dot<TM, T, KC, false>(
        B, nullptr, U, n, p, k, 0, 0, su_w, su_k,
        MmaScatterStore{X, Xbar, gamma, Y, sx_w, sx_k, sxb_k, sy_w, sy_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    __shared__ Acc<T> Cs[KC][kWarps * R];      // the reduced B·U per row
    scatter_block<TM, T, KC, R, true, false>(B, nullptr, X, Xbar, U, gamma,
                                             Y, n, p, k, sx_w, sx_k, sxb_k,
                                             su_w, su_k, sy_w, sy_k, Vs, Cs);
  }
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_gather_kernel(const TM* __restrict__ A, const T* __restrict__ Xbar,
                      T* __restrict__ U, int64_t p, int64_t n, int64_t k,
                      int64_t sxb_k, int64_t su_w, int64_t su_k) {
  if constexpr (kMmaForm<TM, T>) {
    mma_row_dot<TM, T, KC, false>(A, nullptr, Xbar, p, n, k, 0, 0, 0, sxb_k,
                                  MmaStore{U, su_w, su_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    gather_block<TM, T, KC, R, false, T>(A, nullptr, Xbar, U, p, n, k, 0, 0,
                                         0, sxb_k, su_w, su_k, Vs);
  }
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cimmino_scatter_kernel(const TM* __restrict__ B, const T* __restrict__ V,
                       T* __restrict__ Rout, int64_t n, int64_t p,
                       int64_t k, int64_t sv_w, int64_t sv_k, int64_t sr_w,
                       int64_t sr_k) {
  if constexpr (kMmaForm<TM, T> || kMmaF64Form<TM, T, false>) {
    mma_row_dot<TM, T, KC, false>(B, nullptr, V, n, p, k, 0, 0, sv_w, sv_k,
                                  MmaStore{Rout, sr_w, sr_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    __shared__ Acc<T> Cs[KC][kWarps * R];      // the reduced B·V per row
    scatter_block<TM, T, KC, R, false, false>(B, nullptr, nullptr, nullptr,
                                              V, Acc<T>(0), Rout, n, p, k, 0,
                                              0, 0, sv_w, sv_k, sr_w, sr_k,
                                              Vs, Cs);
  }
}

// The sparse scatter: w is the support width, the row dot's row count;
// the tensor-core forms' row dot (kSparseScatterMma) or scatter_block's.
template <typename TM, typename T, int KC, int R, bool kAxpy>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_scatter_kernel(const TM* __restrict__ Bvals,
                      const int64_t* __restrict__ cols,
                      const T* __restrict__ X, const T* __restrict__ Xbar,
                      const T* __restrict__ U, Acc<T> gamma,
                      T* __restrict__ Y, int64_t w, int64_t p, int64_t k,
                      int64_t sx_w, int64_t sx_k, int64_t sxb_k, int64_t su_w,
                      int64_t su_k, int64_t sy_w, int64_t sy_k) {
  if constexpr (kSparseScatterMma<TM, T>) {
    mma_row_dot<TM, T, KC, false>(
        Bvals, nullptr, U, w, p, k, 0, 0, su_w, su_k,
        MmaSparseStore<T, kAxpy>{cols, X, Xbar, gamma, Y, w, sx_w, sx_k,
                                 sxb_k, sy_w, sy_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    __shared__ Acc<T> Cs[KC][kWarps * R];      // the reduced Bvals·U per row
    scatter_block<TM, T, KC, R, kAxpy, true>(Bvals, cols, X, Xbar, U, gamma,
                                             Y, w, p, k, sx_w, sx_k, sxb_k,
                                             su_w, su_k, sy_w, sy_k, Vs, Cs);
  }
}

// The sparse gathers' support operand (header): O[w, i, c] =
// X̄[i, cols[w, c]] − X[w, i, cols[w, c]] (kDiff, sparse_gather) or
// X̄[i, cols[w, c]] (sparse_cimmino_gather) in the accumulator type, the
// difference taken there as the consumers take it, for c < w, and 0 for
// w ≤ c < wp; O is (m, k, wp), contiguous.  One thread an element, in
// O's order, so its stores, its cols loads and, on a band, its X̄ and X
// loads are coalesced.
template <typename T, bool kDiff>
__global__ void __launch_bounds__(kThreads)
support_operand_kernel(const int64_t* __restrict__ cols,
                       const T* __restrict__ X, const T* __restrict__ Xbar,
                       Acc<T>* __restrict__ O, int64_t m, int64_t w,
                       int64_t wp, int64_t k, int64_t sx_w, int64_t sx_k,
                       int64_t sxb_k) {
  const int64_t total = m * k * wp;
  // the ring after it may start its blocks (launch_ring's kDependent)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t c = e % wp, i = e / wp % k, v = e / wp / k;
    Acc<T> o = Acc<T>(0);
    if (c < w) {
      const int64_t g = cols[v * w + c];
      o = widen<Acc<T>>(Xbar[i * sxb_k + g]);
      if constexpr (kDiff) o -= widen<Acc<T>>(X[v * sx_w + i * sx_k + g]);
    }
    O[e] = o;
  }
}

// The sparse gathers' row dot over vals_w (p x w) against the support
// operand O_w (k x wp at O + w·so_w, in Acc<T>): the tensor-core form's
// (kSparseMma; R = 32 rows a warp) or gather_block's Cimmino form with a
// per-worker X̄.  Its two kernels are one; each keeps its name.
template <typename TM, typename T, int KC, int R>
__device__ __forceinline__ void sparse_row_dot(
    const TM* __restrict__ vals, const Acc<T>* __restrict__ O,
    T* __restrict__ U, int64_t p, int64_t w, int64_t k, int64_t so_w,
    int64_t so_k, int64_t su_w, int64_t su_k) {
  if constexpr (kSparseMma<TM, T>) {
    mma_row_dot<TM, T, KC, false>(vals, nullptr, O, p, w, k, 0, 0, so_w,
                                  so_k, MmaStore{U, su_w, su_k});
  } else {
    __shared__ Acc<T> Vs[KC][kChunk];
    gather_block<TM, T, KC, R, false, Acc<T>>(vals, nullptr, O, U, p, w, k, 0,
                                              0, so_w, so_k, su_w, su_k, Vs);
  }
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_gather_kernel(const TM* __restrict__ vals,
                     const Acc<T>* __restrict__ O, T* __restrict__ U,
                     int64_t p, int64_t w, int64_t k, int64_t so_w,
                     int64_t so_k, int64_t su_w, int64_t su_k) {
  sparse_row_dot<TM, T, KC, R>(vals, O, U, p, w, k, so_w, so_k, su_w, su_k);
}

template <typename TM, typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_cimmino_gather_kernel(const TM* __restrict__ vals,
                             const Acc<T>* __restrict__ O, T* __restrict__ U,
                             int64_t p, int64_t w, int64_t k, int64_t so_w,
                             int64_t so_k, int64_t su_w, int64_t su_k) {
  sparse_row_dot<TM, T, KC, R>(vals, O, U, p, w, k, so_w, so_k, su_w, su_k);
}

// The ring over the m·ceil(k/KC)·p rows of M (p x n a worker): warps
// 8..11 copy (ring_produce), warps 0..7 compute and hand each tile's sums
// to `store`; both walk the block's tiles.  kMma: the tensor-core form's
// stage layout, walk (MmaWalk; kSpan, sparse_scatter's: SpanWalk, its
// stage holding two units' operand rows) and consumer (mma_consume).
template <typename TM, typename T, int KC, bool kDiff, bool kPerWorker,
          bool kMma, bool kSpan = false, typename Store>
__device__ __forceinline__ void ring_run(
    const TM* __restrict__ M, const T* __restrict__ X,
    const T* __restrict__ Xbar, int64_t m, int64_t p, int64_t n, int64_t k,
    int64_t sx_w, int64_t sx_k, int64_t sxb_w, int64_t sxb_k, Store store) {
  using Cfg = Ring<TM, T, KC, kDiff || kSpan, kMma>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&ring_full[s], 32 * kRingLoaders);  // every producer thread
      mbar_init(&ring_empty[s], kRingWarps);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if constexpr (kMma) {
    using Walk = std::conditional_t<kSpan, SpanWalk, MmaWalk>;
    Walk walk = Walk::template of<KC>(m, p, k);
    if (warp >= kRingWarps) {
      // a dependent launch's copies wait for the kernel before it (a no-op
      // otherwise: launch_ring's kDependent)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      uint32_t it = 0;
      for (RingTile tl; walk.template next<KC>(tl, p, k);)
        ring_produce<TM, T, KC, kDiff, kPerWorker, true, kSpan>(
            tl, M, X, Xbar, p, n, sx_w, sx_k, sxb_w, sxb_k, it);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      mma_consume<TM, T, KC, kDiff, kSpan>(walk, p, n, k, store);
    }
  } else {
    const int64_t total = m * ((k + KC - 1) / KC) * p;
    int64_t g = total * blockIdx.x / gridDim.x;
    const int64_t end = total * (blockIdx.x + 1) / gridDim.x;
    if (warp >= kRingWarps) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      uint32_t it = 0;
      while (g < end) {
        const RingTile tl = ring_tile<KC>(g, end, p, k);
        ring_produce<TM, T, KC, kDiff, kPerWorker, false>(
            tl, M, X, Xbar, p, n, sx_w, sx_k, sxb_w, sxb_k, it);
        g += tl.rows;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      ring_consume<TM, T, KC, kDiff>(g, end, p, n, k, store);
    }
  }
}

// U[w, i, l] = sum_j (X̄[i, j] − X[w, i, j]) · A[w, l, j] (kDiff; X̄[i, j]
// alone otherwise, X unused).
template <typename TM, typename T, int KC, bool kDiff>
__device__ __forceinline__ void gather_ring(
    const TM* __restrict__ A, const T* __restrict__ X,
    const T* __restrict__ Xbar, T* __restrict__ U, int64_t m, int64_t p,
    int64_t n, int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k,
    int64_t su_w, int64_t su_k) {
  if constexpr (kMmaForm<TM, T>) {
    ring_run<TM, T, KC, kDiff, false, true>(A, X, Xbar, m, p, n, k, sx_w,
                                            sx_k, 0, sxb_k,
                                            MmaStore{U, su_w, su_k});
  } else {
    ring_run<TM, T, KC, kDiff, false, false>(
        A, X, Xbar, m, p, n, k, sx_w, sx_k, 0, sxb_k,
        RingGatherStore<T, KC>{U, su_w, su_k});
  }
}

// The sparse gathers' ring: the Cimmino form over vals_w (p x w) with
// the per-worker support operand O_w in Acc<T> for X̄ (the tensor-core
// form's under kSparseMma), storing U in T.
template <typename TM, typename T, int KC>
__device__ __forceinline__ void sparse_ring(
    const TM* __restrict__ vals, const Acc<T>* __restrict__ O,
    T* __restrict__ U, int64_t m, int64_t p, int64_t w, int64_t k,
    int64_t so_w, int64_t so_k, int64_t su_w, int64_t su_k) {
  if constexpr (kSparseMma<TM, T>) {
    ring_run<TM, T, KC, false, true, true>(vals, nullptr, O, m, p, w, k, 0, 0,
                                           so_w, so_k,
                                           MmaStore{U, su_w, su_k});
  } else {
    ring_run<TM, Acc<T>, KC, false, true, false>(
        vals, nullptr, O, m, p, w, k, 0, 0, so_w, so_k,
        RingGatherStore<T, KC>{U, su_w, su_k});
  }
}

// C[w, i, j] = sum_l U[w, i, l] · M[w, j, l] over the rows j of M = B_w
// (n x p; Bvals_w, w x p, under kSparse), streamed as the Cimmino
// gathers stream A with U_w (V_w) as their X̄, then the scatter's
// epilogue (RingScatterStore; in the dense tensor-core forms
// MmaScatterStore under kAxpy, MmaStore otherwise; in sparse_scatter's,
// kSparseScatterMma, MmaSparseStore on the span walk).
template <typename TM, typename T, int KC, bool kAxpy, bool kSparse>
__device__ __forceinline__ void scatter_ring(
    const TM* __restrict__ M, const int64_t* __restrict__ cols,
    const T* __restrict__ X, const T* __restrict__ Xbar,
    const T* __restrict__ U, Acc<T> gamma, T* __restrict__ Y, int64_t m,
    int64_t n, int64_t p, int64_t k, int64_t sx_w, int64_t sx_k,
    int64_t sxb_k, int64_t su_w, int64_t su_k, int64_t sy_w, int64_t sy_k) {
  constexpr bool kMma = kMmaForm<TM, T> && !kSparse;
  if constexpr (kSparse && kSparseScatterMma<TM, T>) {
    ring_run<TM, T, KC, false, true, true, true>(
        M, nullptr, U, m, n, p, k, 0, 0, su_w, su_k,
        MmaSparseStore<T, kAxpy>{cols, X, Xbar, gamma, Y, n, sx_w, sx_k,
                                 sxb_k, sy_w, sy_k});
  } else if constexpr (kMma && kAxpy) {
    ring_run<TM, T, KC, false, true, true>(
        M, nullptr, U, m, n, p, k, 0, 0, su_w, su_k,
        MmaScatterStore{X, Xbar, gamma, Y, sx_w, sx_k, sxb_k, sy_w, sy_k});
  } else if constexpr (kMma || (kMmaF64Form<TM, T, kAxpy> && !kSparse)) {
    ring_run<TM, T, KC, false, true, true>(M, nullptr, U, m, n, p, k, 0, 0,
                                           su_w, su_k,
                                           MmaStore{Y, sy_w, sy_k});
  } else {
    ring_run<TM, T, KC, false, true, false>(
        M, nullptr, U, m, n, p, k, 0, 0, su_w, su_k,
        RingScatterStore<T, KC, kAxpy, kSparse>{
            cols, X, Xbar, gamma, Y, n, sx_w, sx_k, sxb_k, sy_w, sy_k});
  }
}

// The dense gather ring kernels share one parameter list; the Cimmino
// one does not read X and its strides.
template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
apc_gather_ring_kernel(const TM* __restrict__ A, const T* __restrict__ X,
                       const T* __restrict__ Xbar, T* __restrict__ U,
                       int64_t m, int64_t p, int64_t n, int64_t k,
                       int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                       int64_t su_w, int64_t su_k) {
  gather_ring<TM, T, KC, true>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k,
                               su_w, su_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
cimmino_gather_ring_kernel(const TM* __restrict__ A, const T* __restrict__ X,
                           const T* __restrict__ Xbar, T* __restrict__ U,
                           int64_t m, int64_t p, int64_t n, int64_t k,
                           int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                           int64_t su_w, int64_t su_k) {
  gather_ring<TM, T, KC, false>(A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k,
                                su_w, su_k);
}

// The sparse gathers' ring kernels: one ring, each kernel its name.
template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
sparse_gather_ring_kernel(const TM* __restrict__ vals,
                          const Acc<T>* __restrict__ O, T* __restrict__ U,
                          int64_t m, int64_t p, int64_t w, int64_t k,
                          int64_t so_w, int64_t so_k, int64_t su_w,
                          int64_t su_k) {
  sparse_ring<TM, T, KC>(vals, O, U, m, p, w, k, so_w, so_k, su_w, su_k);
}

template <typename TM, typename T, int KC>
__global__ void __launch_bounds__(kRingThreads, 1)
sparse_cimmino_gather_ring_kernel(const TM* __restrict__ vals,
                                  const Acc<T>* __restrict__ O,
                                  T* __restrict__ U, int64_t m, int64_t p,
                                  int64_t w, int64_t k, int64_t so_w,
                                  int64_t so_k, int64_t su_w, int64_t su_k) {
  sparse_ring<TM, T, KC>(vals, O, U, m, p, w, k, so_w, so_k, su_w, su_k);
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
// once per device and kernel.  kDependent (the sparse gathers' ring,
// after their pre-pass): a programmatic dependent launch, so the ring's
// blocks start while the pre-pass runs and its producers wait for it
// (griddepcontrol.wait, ring_run); its consumers read no global memory
// the pre-pass or a kernel before it writes.  A probe on the card timed
// it 0.6–1.9 µs a call ahead of a plain launch (PERF.md).
template <auto kKernel, int KC, bool kMma = false, bool kDependent = false,
          typename... Args>
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
  const int64_t units = m * ((k + KC - 1) / KC);
  const int64_t tiles =
      kMma ? units * ((rows + kMmaRows - 1) / kMmaRows)
           : (units * rows + kRingRows - 1) / kRingRows;
  const unsigned grid = static_cast<unsigned>(min64(sms, tiles));
  if constexpr (kDependent) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kRingThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, kKernel, args...);
  } else {
    kKernel<<<grid, kRingThreads, smem, s>>>(args...);
  }
}

// The dense gathers' ring: the kernel of its form, over the rows of A.
template <typename TM, typename T, int KC, bool kDiff>
void launch_gather_ring(const void* A, const void* X, const void* Xbar,
                        void* U, int64_t m, int64_t p, int64_t n, int64_t k,
                        int64_t sx_w, int64_t sx_k, int64_t sxb_k,
                        int64_t su_w, int64_t su_k, cudaStream_t s) {
  constexpr auto kernel = kDiff ? &apc_gather_ring_kernel<TM, T, KC>
                                : &cimmino_gather_ring_kernel<TM, T, KC>;
  constexpr bool kMma = kMmaForm<TM, T>;
  launch_ring<kernel, KC, kMma>(
      Ring<TM, T, KC, kDiff, kMma>::kSmem, m, p, k, s,
      static_cast<const TM*>(A), static_cast<const T*>(X),
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
      launch_gather_ring<TM, T, KC, true>(A, X, Xbar, U, m, p, n, k, sx_w,
                                          sx_k, sxb_k, su_w, su_k, s);
      return;
    }
    // the tensor-core form's row dot takes a tile's 256 rows a block
    constexpr int R = kMmaForm<TM, T> ? kMmaRows / kWarps : kGatherRows;
    apc_gather_kernel<TM, T, KC, R>
        <<<grid_for(p, m, k, KC, R), kThreads, 0, s>>>(
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
      launch_gather_ring<TM, T, KC, false>(A, nullptr, Xbar, U, m, p, n, k,
                                           0, 0, sxb_k, su_w, su_k, s);
      return;
    }
    constexpr int R = kMmaForm<TM, T> ? kMmaRows / kWarps : kGatherRows;
    cimmino_gather_kernel<TM, T, KC, R>
        <<<grid_for(p, m, k, KC, R), kThreads, 0, s>>>(
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
      constexpr bool kMma = kMmaForm<TM, T>;
      launch_ring<&apc_scatter_ring_kernel<TM, T, KC>, KC, kMma>(
          Ring<TM, T, KC, false, kMma>::kSmem, m, n, k, s,
          static_cast<const TM*>(B), static_cast<const T*>(X),
          static_cast<const T*>(Xbar), static_cast<const T*>(U),
          gamma_of<T>(gamma), static_cast<T*>(Y), m, n, p, k, sx_w, sx_k,
          sxb_k, su_w, su_k, sy_w, sy_k);
      return;
    }
    constexpr int R =
        kMmaForm<TM, T> ? kMmaRows / kWarps : scatter_rows<TM, KC>();
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
    constexpr bool kMma = kMmaForm<TM, T> || kMmaF64Form<TM, T, false>;
    if (instance == kRing) {
      launch_ring<&cimmino_scatter_ring_kernel<TM, T, KC>, KC, kMma>(
          Ring<TM, T, KC, false, kMma>::kSmem, m, n, k, s,
          static_cast<const TM*>(B), static_cast<const T*>(V),
          static_cast<T*>(Rout), m, n, p, k, sv_w, sv_k, sr_w, sr_k);
      return;
    }
    constexpr int R = kMma ? kMmaRows / kWarps : scatter_rows<TM, KC>();
    cimmino_scatter_kernel<TM, T, KC, R>
        <<<grid_for(n, m, k, KC, R), kThreads, 0, s>>>(
            static_cast<const TM*>(B), static_cast<const T*>(V),
            static_cast<T*>(Rout), n, p, k, sv_w, sv_k, sr_w, sr_k);
  });
  return static_cast<int>(cudaGetLastError());
}

// The sparse gathers (header): the pre-pass writes the support operand
// O (m, k, wp) in Acc<T> (wp ≥ w, O's rows 16-byte multiples), then the
// ring or the row dot over vals reads it.  kDiff: sparse_gather (O =
// X̄ₛ − Xₛ); else sparse_cimmino_gather (O = X̄ₛ, X unused).
template <typename TM, typename T, bool kDiff>
int sparse_gathers(const void* vals, const void* cols, const void* X,
                   const void* Xbar, void* U, void* O, int64_t m, int64_t p,
                   int64_t w, int64_t wp, int64_t k, int64_t sx_w,
                   int64_t sx_k, int64_t sxb_k, int64_t su_w, int64_t su_k,
                   int64_t instance, int64_t kc, void* stream) {
  using TA = Acc<T>;
  if ((instance != kRowDot && instance != kRing) || !kc_valid(kc) ||
      wp < w || wp * static_cast<int64_t>(sizeof(TA)) % 16 != 0)
    return cudaErrorInvalidValue;
  if (m == 0 || p == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wp > 0) {
    const int64_t blocks = min64((m * k * wp + kThreads - 1) / kThreads,
                                 int64_t{1} << 20);
    support_operand_kernel<T, kDiff>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            static_cast<const int64_t*>(cols), static_cast<const T*>(X),
            static_cast<const T*>(Xbar), static_cast<TA*>(O), m, w, wp, k,
            sx_w, sx_k, sxb_k);
  }
  const TA* Ot = static_cast<const TA*>(O);
  T* Ut = static_cast<T*>(U);
  with_kc(kc_of(k, kc), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    constexpr bool kMma = kSparseMma<TM, T>;
    const TM* M = static_cast<const TM*>(vals);
    if (instance == kRing) {
      constexpr auto kernel = kDiff
                                  ? &sparse_gather_ring_kernel<TM, T, KC>
                                  : &sparse_cimmino_gather_ring_kernel<TM, T, KC>;
      launch_ring<kernel, KC, kMma, true>(
          Ring<TM, TA, KC, false, kMma>::kSmem, m, p, k, s, M, Ot, Ut, m, p,
          w, k, k * wp, wp, su_w, su_k);
      return;
    }
    constexpr int R = kMma ? kMmaRows / kWarps : kGatherRows;
    constexpr auto kernel = kDiff
                                ? &sparse_gather_kernel<TM, T, KC, R>
                                : &sparse_cimmino_gather_kernel<TM, T, KC, R>;
    kernel<<<grid_for(p, m, k, KC, R), kThreads, 0, s>>>(
        M, Ot, Ut, p, w, k, k * wp, wp, su_w, su_k);
  });
  return static_cast<int>(cudaGetLastError());
}

// sparse_scatter's ring stage: the span ring's (two units' operand rows)
// in its tensor-core forms, the Cimmino form's otherwise.
template <typename TM, typename T, int KC>
constexpr int sparse_scatter_smem() {
  constexpr bool kMma = kSparseScatterMma<TM, T>;
  return Ring<TM, T, KC, kMma, kMma>::kSmem;
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
    constexpr bool kMma = kSparseScatterMma<TM, T>;
    if (instance == kRing) {
      const auto ring = [&](auto axpy) {
        launch_ring<&sparse_scatter_ring_kernel<TM, T, KC, decltype(axpy)::value>,
                    KC, kMma>(
            sparse_scatter_smem<TM, T, KC>(), m, w, k, s,
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
    constexpr int R = kMma ? kMmaRows / kWarps : scatter_rows<TM, KC>();
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

// The C entries of each (matrix, compute) type pair: <kernel>_<SUFFIX>,
// every kernel for every pair of block_projection.PAIRS.  kc is the
// k-chunk (0: the library's own, kc_for(k)).
#define REPRO_ENTRIES(SUFFIX, TM, T)                                         \
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
  }                                                                          \
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
  int sparse_gather_##SUFFIX(                                                \
      const void* vals, const void* cols, const void* X, const void* Xbar,   \
      void* U, void* O, int64_t m, int64_t p, int64_t w, int64_t wp,         \
      int64_t k, int64_t sx_w, int64_t sx_k, int64_t sxb_k, int64_t su_w,    \
      int64_t su_k, int64_t instance, int64_t kc, void* stream) {            \
    return sparse_gathers<TM, T, true>(vals, cols, X, Xbar, U, O, m, p, w,   \
                                       wp, k, sx_w, sx_k, sxb_k, su_w, su_k, \
                                       instance, kc, stream);                \
  }                                                                          \
  int sparse_cimmino_gather_##SUFFIX(                                        \
      const void* vals, const void* cols, const void* Xbar, void* U,         \
      void* O, int64_t m, int64_t p, int64_t w, int64_t wp, int64_t k,       \
      int64_t sxb_k, int64_t su_w, int64_t su_k, int64_t instance,           \
      int64_t kc, void* stream) {                                            \
    return sparse_gathers<TM, T, false>(vals, cols, nullptr, Xbar, U, O, m,  \
                                        p, w, wp, k, 0, 0, sxb_k, su_w,      \
                                        su_k, instance, kc, stream);         \
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

// One pair a library (REPRO_PAIR: its place in block_projection.PAIRS).
#if REPRO_PAIR == 0
REPRO_ENTRIES(f64, double, double)
#elif REPRO_PAIR == 1
REPRO_ENTRIES(f32, float, float)
#elif REPRO_PAIR == 2
REPRO_ENTRIES(bf16_f64, __nv_bfloat16, double)
#elif REPRO_PAIR == 3
REPRO_ENTRIES(bf16_f32, __nv_bfloat16, float)
#elif REPRO_PAIR == 4
REPRO_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
#else
#error "compile with -DREPRO_PAIR=0..4 (block_projection.build)"
#endif

#undef REPRO_ENTRIES

// The ring instance's dynamic shared memory at the k-chunk of k, in
// bytes, for a matrix of matrix_itemsize bytes (8, 4 or 2), a compute
// type of itemsize bytes (8, 4, or 2 beside a bf16 matrix) and a form
// (kApcForm, kCimminoForm, for bf16/f64 kApcMmaForm and kCimminoMmaForm,
// for f64 kCimminoMmaForm: the float64 Cimmino scatter's; kSparseForm:
// the sparse gathers' stage, kSparseScatterForm: sparse_scatter's, each
// whatever its consumer); 0 for any other.
int64_t gather_ring_smem(int64_t matrix_itemsize, int64_t itemsize,
                         int64_t k, int64_t form) {
  const bool mma = form == kApcMmaForm || form == kCimminoMmaForm;
  if (form < kApcForm || form > kSparseScatterForm ||
      (mma && !(itemsize == 8 && (matrix_itemsize == 2 ||
                                  (matrix_itemsize == 8 &&
                                   form == kCimminoMmaForm)))))
    return 0;
  const bool diff = form == kApcForm || form == kApcMmaForm;
  int64_t bytes = 0;
  with_kc(kc_for(k), [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    const auto of = [&](auto tm, auto t) {
      using TM = decltype(tm);
      using T = decltype(t);
      if (form == kSparseForm) {
        bytes = Ring<TM, Acc<T>, KC, false, kSparseMma<TM, T>>::kSmem;
        return;
      }
      if (form == kSparseScatterForm) {
        bytes = sparse_scatter_smem<TM, T, KC>();
        return;
      }
      if constexpr (kMmaForm<TM, T> || kMmaF64Form<TM, T, false>) {
        if (mma) {
          bytes = diff ? Ring<TM, T, KC, true, true>::kSmem
                       : Ring<TM, T, KC, false, true>::kSmem;
          return;
        }
      }
      bytes = diff ? Ring<TM, T, KC, true>::kSmem
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
