// The tensor-core block of the tile kernels (sm_90a).  The shapes it takes
// (tm, tn multiples of 128, tk of 32 for f32 tiles or 64 for bf16) run on
// it in all four main-path tile kernels:
//   tile_spgemm.cu  one block per piece of a C tile, over its run;
//   tile_stream.cu  one block per piece of a group of C tiles;
//   tile_panel.cu   as tile_spgemm, A k-transposed, f32 or bf16 output;
//   tile_grid.cu    one block per piece of one item, added into C with f32
//                   atomics.
// tile_probe_mma.cuh runs it with one part stripped or changed per mode
// (piece's and slice_mma's compile-time M, kFull everywhere else), and every
// other shape runs the SIMT blocks of tile_wide.cuh / tile_pipe.cuh.
//
// Work unit.  A block of 256 threads (8 warps, 2 along rows x 4 along
// columns, each warp 64 x 32) computes one 128 x 128 piece (row0, col0) of
// the C tiles of a contiguous item range [lo, hi) of an o-sorted worklist.
// It walks the range as one flat sequence of BK-deep k-slices (BK = 32 for
// f32 tiles, 64 for bf16) that cp.async copies, 16 bytes at a time, into a
// ring of STAGES shared-memory stages, STAGES - 1 slices ahead of the
// tensor cores.  The ring runs on across C-tile boundaries inside the
// range.  The accumulator lives in registers; at the end of a run the block
// hands its piece of that C tile to the kernel's epilogue (Store: written
// once and never read, f32 or rounded once to bf16; Add: f32 atomic adds),
// gives it the range's C tiles that have no items as zeros, and starts
// again from zero.
//
// Layouts.  B is staged as it lies (rows of [tk][tn]), and A as it lies
// too: natural A (rows of a [tm][tk] tile, the A fragment's row-major
// m x k) as As[m][k], k-transposed A (rows of [tk][tm]) as As[k][m], which
// is the B slice's copy applied to A.  No transposed copy is made.  Each
// staged row carries 16 (natural A) or 8-element ([k][*] rows) padding, so
// that a warp's fragment reads fall in 32 distinct banks: natural A row
// pitch BK + 16 bytes (bank 4*row + k), [k][*] row pitch 128 + 8 elements
// (f32: bank 8*k + m or n; bf16: ldmatrix.trans rows 16 bytes apart mod
// 128).  The bf16 A fragment of [k][m] rows is ldmatrix.trans of four 8 x 8
// matrices, as B's is.
//
// Arithmetic.
//   f32 tiles: 3xTF32 on mma.sync.m16n8k8 (tf32 in, f32 sums).  Each operand
//     element is split after its shared-memory read, big = cvt.rna.tf32(x),
//     small = cvt.rna.tf32(x - big), and d += a_small*b_big,
//     d += a_big*b_small, d += a_big*b_big, small terms first.  The dropped
//     small*small term is 2^-22 of a product, so the sum has f32-level
//     error, as the TPU's 'highest' (bf16 x 6 passes) does.
//   bf16 tiles: mma.sync.m16n8k16 (bf16 in, f32 sums): products exact.
//   The tensor cores' f32 sums round toward zero, so a sum carried through
//   them over a whole run drifts one way: on an H100, runs of 64 items at
//   tk = 512 missed the f64 product by 2.4e-4 of max|C| (f32 tiles) and
//   3.8e-5 (bf16), against 4e-7 for an f32 sum.  So the mmas of one k-slice
//   (four steps) sum into a register tile d that starts at zero, and d is
//   added into the accumulator with f32 adds, which round to nearest:
//   1.3e-6 (f32) and 8.4e-7 (bf16) on the same runs.
// mma.sync and not wgmma: the split happens in registers after the
// shared-memory read, and wgmma reads B from shared memory (the split would
// be stored there twice); TF32 wgmma also takes K-major B only, and B tiles
// are [tk][tn].
//
// What bounds it on an H100.  At 3xTF32 the tensor cores give about a third
// of the 495 TFLOP/s TF32 rate, 2.5x the 67 TFLOP/s FP32 SIMT peak.  A
// 128 x 128 piece at tk = 512 reads 512 KB of operands per 16.8 MFLOP of
// products, so near 100 TFLOP/s the SMs pull about 3 TB/s of operands: L2
// hits, not HBM, decide whether the loads bind.
//
// Launch order.  Blocks launch x-fastest, and x runs over a unit's pieces
// first (a C tile's, a group's, or tile_grid's item's), then over the
// units.  Measured on an H100 80GB HBM3 at 700 W (PERF.md), with the
// per-slice fold: on the nn pair, this order and the C-tile-fastest one
// (pieces in y and z) were within 0.5% of each other (this one ahead in
// four runs of six), and on runs of two 384^2 bf16 tiles this one was 2-3%
// faster in three runs of three, so it is the order used.  The fold cost
// 5.0-5.6% in this order and 0.4-0.7% in the other, against forms that sum
// in the tensor cores over the whole run, which fail the 1e-5 gate.  Pieces
// of 128 x 256 (half the blocks, half A's re-reads from L2) ran 20-30%
// slower.

#pragma once

#include <type_traits>

#include "tile_pipe.cuh"

namespace spada {
namespace mma {

constexpr int kBM = 128;       // piece rows
constexpr int kBN = 128;       // piece columns
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpsN = 4;     // warps along the piece's columns
constexpr int kWM = 64;        // rows per warp
constexpr int kMT = kWM / 16;  // m16 fragments per warp
constexpr int kNT = kBN / kWarpsN / 8;  // n8 fragments per warp
constexpr int kDeepest = 4;    // deepest ring compiled

// ---- probe modes (tile_probe_mma.cuh; M = kFull is the block as it runs) --

using namespace mode;
// the A/B slices are copied into the ring
template <int M>
constexpr bool kLoads = M != kNoDma && M != kDots && M != kStat && M != kNoBar;
// nothing is copied, and the worklist ids pick the (zeroed) stage multiplied
template <int M>
constexpr bool kIdsOnly = M == kNoDma || M == kDots || M == kNoBar;
// every item reads the same A and B tile: no worklist reads
template <int M>
constexpr bool kFixed = M == kStatSlot || M == kOneSlot || M == kNoAcc;
// f32 operands are rounded to TF32 once, not split into two TF32 parts
template <int M>
constexpr bool kNoSplit = M == kOnePass || M == kBigOnly;

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int BK = 32;  // k per ring stage
  static constexpr int KI = 8;   // k per mma
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr int KI = 16;
};

// One ring stage of a 128 x 128 piece: the A slice, As[m][k] (natural) or
// with A_T As[k][m] (k-transposed), then the B slice Bs[k][n], all padded.
template <typename T, bool A_T = false>
struct Stage {
  static constexpr int BK = Op<T>::BK;
  static constexpr int E = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int kBPitch = kBN + 8;
  static constexpr int kAPitch = A_T ? kBM + 8 : BK + E;
  static constexpr int kA = (A_T ? BK : kBM) * kAPitch;
  static constexpr int kElems = kA + BK * kBPitch;
  static constexpr size_t kBytes = (size_t)kElems * sizeof(T);
};

// Whether the block takes (tm, tk, tn): 128 x 128 pieces, whole k-slices.
template <typename T>
inline bool takes(int tm, int tk, int tn) {
  return tm > 0 && tm % kBM == 0 && tn > 0 && tn % kBN == 0 && tk > 0 &&
         tk % Op<T>::BK == 0;
}

// ---- fragments --------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (big's error is at most 2^-11 of x, small's
// 2^-22)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 b16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two of them: lanes 0-15 give the row addresses of matrices 0 and 1
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero(float (&x)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][j][e] = 0.0f;
}

// acc += d in f32 (round to nearest): a k-slice's tensor-core sums into
// the run's accumulator.
__device__ __forceinline__ void fold(float (&acc)[kMT][kNT][4],
                                     const float (&d)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
}

// x's TF32 parts for the mmas of mode M: both, or with kNoSplit the big one
// alone (one cvt, no subtraction)
template <int M>
__device__ __forceinline__ void parts(float x, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (kNoSplit<M>)
    big = to_tf32(x);
  else
    split(x, big, small);
}

// d += As @ Bs over one staged f32 slice, 3xTF32.  Fragment (m16n8k8):
// lane = 4g + t holds A[g | g+8][t | t+4], B[t | t+4][g],
// C[g | g+8][2t, 2t+1].  Probe modes: kOnePass one mma per fragment pair on
// the operands rounded to TF32 (a 1xTF32 product), kBigOnly three of those
// (the mma work of 3xTF32 without the split: d holds three times the 1xTF32
// product).
template <bool A_T, int M>
__device__ __forceinline__ void slice_sums(const float* As, const float* Bs,
                                           int wm0, int wn0, int lane,
                                           float (&d)[kMT][kNT][4]) {
  using S = Stage<float, A_T>;
  constexpr int P = S::kAPitch, PB = S::kBPitch, Q = S::BK / Op<float>::KI;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int kk = q * Op<float>::KI;
    uint32_t ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if constexpr (A_T) {  // As[k][m]: bank 8t + g, as B's reads
        const float* p = As + (kk + t) * P + wm0 + i * 16 + g;
        parts<M>(p[0], ab[i][0], as[i][0]);
        parts<M>(p[8], ab[i][1], as[i][1]);
        parts<M>(p[4 * P], ab[i][2], as[i][2]);
        parts<M>(p[4 * P + 8], ab[i][3], as[i][3]);
      } else {
        const float* p = As + (wm0 + i * 16 + g) * P + kk + t;
        parts<M>(p[0], ab[i][0], as[i][0]);
        parts<M>(p[8 * P], ab[i][1], as[i][1]);
        parts<M>(p[4], ab[i][2], as[i][2]);
        parts<M>(p[8 * P + 4], ab[i][3], as[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* p = Bs + (kk + t) * PB + wn0 + j * 8 + g;
      parts<M>(p[0], bb[j][0], bs[j][0]);
      parts<M>(p[4 * PB], bb[j][1], bs[j][1]);
    }
    if constexpr (kNoSplit<M>) {
#pragma unroll
      for (int pass = 0; pass < (M == kOnePass ? 1 : 3); ++pass)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(d[i][j], ab[i], bb[j]);
    } else {
      // three passes over all fragments, so neighbouring mmas are
      // independent
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(d[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(d[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(d[i][j], ab[i], bb[j]);
    }
  }
}

// d += As @ Bs over one staged bf16 slice.  Fragment (m16n8k16): lane =
// 4g + t holds
// A[g | g+8][2t, 2t+1 | 2t+8, 2t+9], B[2t, 2t+1 | 2t+8, 2t+9][g] (from
// ldmatrix.trans of [k][n] rows), C as for f32.  ldmatrix.trans gives lane
// 4g + t of an 8 x 8 matrix of [k][*] rows the elements of rows 2t, 2t+1
// in column g, so of [k][m] rows of A it gives A[g][2t, 2t+1]: the four
// matrices (m 0-7 | 8-15) x (k 0-7 | 8-15) are the A fragment's a[0..3].
template <bool A_T, int M>
__device__ __forceinline__ void slice_sums(const __nv_bfloat16* As,
                                           const __nv_bfloat16* Bs, int wm0,
                                           int wn0, int lane,
                                           float (&d)[kMT][kNT][4]) {
  using S = Stage<__nv_bfloat16, A_T>;
  constexpr int P = S::kAPitch, PB = S::kBPitch;
  constexpr int Q = S::BK / Op<__nv_bfloat16>::KI;
  static_assert(kNT % 2 == 0, "ldmatrix.x4 reads two n8 fragments");
  static_assert(!kNoSplit<M>, "bf16 operands are not split");
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: matrix q = lane / 8 is k half q & 1 of n8 fragment q >> 1
  const int lk = (lane & 7) + ((lane >> 3) & 1) * 8, ln = (lane >> 4) * 8;
  // and of A's [k][m] rows: m half q & 1, k half q >> 1
  const int ak = (lane & 7) + (lane >> 4) * 8, am = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int kk = q * Op<__nv_bfloat16>::KI;
    uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if constexpr (A_T) {
        ldmatrix_x4_trans(a[i], As + (kk + ak) * P + wm0 + i * 16 + am);
      } else {
        const __nv_bfloat16* p = As + (wm0 + i * 16 + g) * P + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * P);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * P + 8);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, Bs + (kk + lk) * PB + wn0 + j * 8 + ln);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(d[i][j], a[i], b[j]);
  }
}

// acc += As @ Bs over one staged slice: its mmas summed in a register tile
// d that starts at zero, and d folded into acc.  Probe mode kNoFold sums
// through the tensor cores straight into acc (no d: 64 registers fewer, and
// sums that round toward zero over the whole run).
template <bool A_T, int M, typename T>
__device__ __forceinline__ void slice_mma(const T* As, const T* Bs, int wm0,
                                          int wn0, int lane,
                                          float (&acc)[kMT][kNT][4]) {
  if constexpr (M == kNoFold) {
    slice_sums<A_T, M>(As, Bs, wm0, wn0, lane, acc);
  } else {
    float d[kMT][kNT][4];
    zero(d);
    slice_sums<A_T, M>(As, Bs, wm0, wn0, lane, d);
    fold(acc, d);
  }
}

// ---- staging and stores -----------------------------------------------------

// Start the copies of rows k0 .. k0 + BK - 1, columns col0 .. col0 + 127, of
// a [*][ld] tile into the [BK][128] slice `s` (pitch 128 + 8).
template <typename T>
__device__ __forceinline__ void issue_k_rows(T* s, const T* x, int ld,
                                             int col0, int k0, int tid) {
  using S = Stage<T>;
  constexpr int per = kBN / S::E;
  static_assert(S::BK * per % kThreads == 0, "copies per thread");
#pragma unroll
  for (int i = 0; i < S::BK * per / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int k = c / per, n = (c % per) * S::E;
    cp_async16(s + k * S::kBPitch + n, x + (size_t)(k0 + k) * ld + col0 + n);
  }
}

// Start the copies of k-slice k0 of the piece's rows of tile a, [tm][tk]
// (natural) or [tk][tm] (A_T), and columns of tile b [tk][tn] into one ring
// stage.
template <typename T, bool A_T>
__device__ __forceinline__ void issue(T* st, const T* a, const T* b, int tm,
                                      int tk, int tn, int row0, int col0,
                                      int k0, int tid) {
  using S = Stage<T, A_T>;
  if constexpr (A_T) {
    static_assert(S::kAPitch == S::kBPitch, "A slice staged as B's");
    issue_k_rows(st, a, tm, row0, k0, tid);
  } else {
    constexpr int per_a = S::BK / S::E;
    static_assert(kBM * per_a % kThreads == 0, "copies per thread");
#pragma unroll
    for (int i = 0; i < kBM * per_a / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / per_a, k = (c % per_a) * S::E;
      cp_async16(st + r * S::kAPitch + k,
                 a + (size_t)(row0 + r) * tk + k0 + k);
    }
  }
  issue_k_rows(st + S::kA, b, tn, col0, k0, tid);
}

// Call f(p, x, y) for each two adjacent values x, y of the warp's part of
// a piece of C tile `out` [tm][tn], p their place: one pair per fragment
// row, a warp's 8 rows x 8 pairs per call site.  The warp holds MT x NT
// m16n8 fragments (tile_mma_thin.cuh's fewer); HALF: only rows 0-7 of each
// exist (a tm = 8 piece).
template <bool HALF = false, typename OutT, int MT, int NT, class F>
__device__ __forceinline__ void each_pair(OutT* out, int tn, int row0,
                                          int col0, int lane,
                                          const float (&acc)[MT][NT][4],
                                          F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    OutT* p = out + (size_t)(row0 + i * 16 + g) * tn + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* v = acc[i][j];
      f(p + j * 8, v[0], v[1]);
      if constexpr (!HALF) f(p + 8 * (size_t)tn + j * 8, v[2], v[3]);
    }
  }
}

// Two adjacent C values stored as f32 (8 bytes) or rounded once to bf16
// (nearest, ties to even; 4 bytes), or added into f32 C by one two-wide
// atomic (sm_90), half the scalar atomics.
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void add2(float* p, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(x),
               "f"(y)
               : "memory");
}

// The epilogues: where piece() puts its finished C tiles, `out` [n_c][tm][tn].
// put<ZERO>(c, ...) takes the warp's part of C tile c (ZERO: a tile with no
// items).  Store writes each tile once, f32 or bf16, and Add adds into a C
// that starts zeroed, so an empty tile needs nothing; both take this
// block's or the thin block's fragments (HALF as each_pair's).
template <typename OutT>
struct Store {
  OutT* out;
  size_t c_size;
  int tn;
  template <bool ZERO, bool HALF = false, int MT, int NT>
  __device__ __forceinline__ void put(int c, int row0, int col0, int lane,
                                      const float (&acc)[MT][NT][4]) const {
    each_pair<HALF>(out + c * c_size, tn, row0, col0, lane, acc,
                    [](OutT* p, float x, float y) {
                      put2(p, ZERO ? 0.f : x, ZERO ? 0.f : y);
                    });
  }
};

struct Add {
  float* out;
  size_t c_size;
  int tn;
  template <bool ZERO, bool HALF = false, int MT, int NT>
  __device__ __forceinline__ void put(int c, int row0, int col0, int lane,
                                      const float (&acc)[MT][NT][4]) const {
    if constexpr (!ZERO)
      each_pair<HALF>(out + c * c_size, tn, row0, col0, lane, acc,
                      [](float* p, float x, float y) { add2(p, x, y); });
  }
};

// ---- launch shape -------------------------------------------------------------

// The block's unit (C tile, group or item) and piece origin: x runs over a
// unit's pieces, row-major, then over the units.
struct Place {
  int unit, row0, col0;
};

__device__ __forceinline__ Place place(int tm, int tn) {
  const int across = tn / kBN, pieces = (tm / kBM) * across;
  const int p = (int)(blockIdx.x % pieces);
  return {(int)(blockIdx.x / pieces), p / across * kBM, p % across * kBN};
}

inline dim3 grid(int units, int tm, int tn) {
  return dim3(units * (tm / kBM) * (tn / kBN));
}

// Call f(std::integral_constant<int, STAGES>) for a ring of `depth`
// stages, at most kDeepest.
template <class F>
int with_depth(int depth, F f) {
  if (depth <= 2) return f(std::integral_constant<int, 2>{});
  if (depth == 3) return f(std::integral_constant<int, 3>{});
  return f(std::integral_constant<int, kDeepest>{});
}

// ---- the block -------------------------------------------------------------------

// One 128 x 128 piece (row0, col0) of the C tiles c_first .. c_end - 1
// from the items [lo, hi) of an o-sorted worklist; o_of(w) is item w's C
// tile, and `out` (Store or Add) takes each finished tile.  A tiles are
// [tm][tk], or with A_T k-transposed [tk][tm].  smem holds STAGES stages of
// Stage<T, A_T>.
//
// M is a probe mode (tile_probe_mma.cuh), kFull in every main-path kernel; with
// kFull none of the branches below compiles to anything.  kNoDma, kDots and
// kNoBar copy nothing and multiply a zeroed ring, the stage picked from the
// item's worklist ids (kStat: without reading them; kNoBar: without the
// per-slice barrier, which then guards nothing); kStatSlot, kOneSlot and
// kNoAcc read A tile fix_a and B tile fix_b for every item, and kNoAcc
// zeroes the accumulator at each item; kOnePass, kBigOnly and kNoFold change
// slice_mma.  Whether C is written is the caller's `out`.
template <typename T, int STAGES, bool A_T, int M = kFull, class OTile,
          class Out>
__device__ __forceinline__ void piece(
    const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
    const int32_t* __restrict__ a_tid, const int32_t* __restrict__ b_tid,
    OTile o_of, int lo, int hi, int c_first, int c_end, const Out& out,
    int tm, int tk, int tn, int row0, int col0, unsigned char* smem,
    int fix_a = 0, int fix_b = 0) {
  using S = Stage<T, A_T>;
  static_assert(STAGES >= 2, "ring depth");
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / kWarpsN) * kWM;
  const int wn0 = (warp % kWarpsN) * (kBN / kWarpsN);
  const int k_steps = tk / S::BK;
  const size_t a_size = (size_t)tm * tk, b_size = (size_t)tk * tn;

  // the next slice to copy: k-slice ik of item iw, whose tiles are a_w, b_w
  int iw = lo, ik = 0;
  const T* a_w = a_tiles;
  const T* b_w = b_tiles;
  if constexpr (kFixed<M>) {
    a_w += (size_t)fix_a * a_size;
    b_w += (size_t)fix_b * b_size;
  } else if constexpr (kLoads<M>) {
    if (lo < hi) {
      a_w += (size_t)a_tid[lo] * a_size;
      b_w += (size_t)b_tid[lo] * b_size;
    }
  }
  auto issue_next = [&](int stage) {
    if constexpr (kLoads<M>) {
      if (iw < hi) {
        issue<T, A_T>(ring + stage * S::kElems, a_w, b_w, tm, tk, tn, row0,
                      col0, ik * S::BK, tid);
        if (++ik == k_steps) {
          ik = 0;
          if (++iw < hi && !kFixed<M>) {
            a_w = a_tiles + (size_t)a_tid[iw] * a_size;
            b_w = b_tiles + (size_t)b_tid[iw] * b_size;
          }
        }
      }
      cp_async_commit();  // one group per slice, empty past the end
    }
  };

  float acc[kMT][kNT][4];
  zero(acc);
  const int r0 = row0 + wm0, n0 = col0 + wn0;

  if constexpr (!kLoads<M>) {
    for (int i = tid; i < STAGES * S::kElems; i += kThreads) ring[i] = T(0.0f);
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next(s);
  int next_c = c_first;  // the first C tile not yet written
  int stage = 0;         // the stage of the slice in hand
  for (int w = lo, k = 0; w < hi;) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the slice ...
    if constexpr (M != kNoBar)
      __syncthreads();  // ... and everyone's; all are done with the last one
    issue_next(stage == 0 ? STAGES - 1 : stage - 1);  // refill the last's
    int use = stage;
    if constexpr (kIdsOnly<M>)
      use = (int)((unsigned)(stage ^ a_tid[w] ^ b_tid[w]) % STAGES);
    if constexpr (M == kNoAcc) {
      if (k == 0) zero(acc);
    }
    const T* st = ring + use * S::kElems;
    slice_mma<A_T, M>(st, st + S::kA, wm0, wn0, lane, acc);
    stage = stage == STAGES - 1 ? 0 : stage + 1;
    if (++k < k_steps) continue;
    k = 0;
    const int o = o_of(w);
    if (++w < hi && o_of(w) == o) continue;  // the run goes on
    for (; next_c < o; ++next_c)
      out.template put<true>(next_c, r0, n0, lane, acc);
    out.template put<false>(o, r0, n0, lane, acc);
    next_c = o + 1;
    zero(acc);
  }
  for (; next_c < c_end; ++next_c)
    out.template put<true>(next_c, r0, n0, lane, acc);
}

}  // namespace mma
}  // namespace spada
