// The thin tensor-core block (sm_90a): the row panels of height 8, 16, 32
// and 64 (and odd multiples of 64) that the planner's per-row-group choice
// (config.tm_choices) makes, which tile_mma.cuh's 128 x 128 piece cannot
// take.  Four kernels run their thin shapes on it, as tile_mma.cuh's
// block runs their wide ones:
//   tile_spgemm.cu  one block per piece of a C tile, over its run;
//   tile_stream.cu  one block per piece of a group of C tiles;
//   tile_panel.cu   as tile_spgemm, A k-transposed, f32 or bf16 output;
//   tile_grid.cu    one block per piece of a chunk of consecutive items in
//                   any order, each run's sum added into a zeroed C (Add).
//
// Work unit.  A block of 32 * kWarpsN threads (kWarpsN warps side by side
// along the columns, each BM x 128 / kWarpsN) computes one BM x 128 piece
// (row0, col0) of the C tiles of a contiguous item range [lo, hi) of an
// o-sorted worklist, BM in {16, 32, 64}: BM = tm for tm <= 32 (tm = 8 on a
// 16-row piece, below), 64 otherwise.  It walks the range as one flat
// sequence of BK-deep k-slices (BK = 32 f32 / 64 bf16, as tile_mma.cuh)
// that cp.async copies, 16 bytes at a time, into a ring of STAGES
// shared-memory stages, STAGES - 1 slices ahead of the tensor cores, across
// item and C-tile boundaries: at T = 128 a thin item is only 4 f32 or 2
// bf16 slices, so the ring must not drain between items.  The accumulator
// lives in registers; at the end of a run the block hands its piece of
// that C tile to the kernel's epilogue (tile_mma.cuh's Store: written once,
// f32 or rounded once to bf16; or Add: added into f32), gives the range's C
// tiles that have no items as zeros, and starts again from zero.
//
// With a mask (tile_spgemm.cu alone; ops.engine.thin_slice_mask builds it
// from A's values once per prepared launch) the sequence holds only the
// slices whose BM x BK block of the item's A tile has a nonzero: one 32-bit
// word per item and piece row, bit s for slice s, read beside a_tid and
// b_tid.  The producer copies the set slices in ascending s, still as one
// flat sequence; the consumer runs popcount(word) slice steps per item, so
// an item with an empty word costs neither a copy nor a step, and a C tile
// whose items all have one is written as zeros.  A skipped slice would
// have added +0 to every d, so C is the unmasked C bit for bit where B is
// finite.  With every bit set the masked loop took 1.3-6.3% longer than
// the unmasked one (its word, popcount and lowest-bit search per item), so
// the engine passes no mask where it would skip less than 1/16 of the
// slice steps (ops.engine.MASK_MIN_SKIP).
//
// Arithmetic: tile_mma.cuh's, fragment for fragment.  f32 tiles 3xTF32 on
// mma.sync.m16n8k8 (each operand split after its shared-memory read, small
// terms first), bf16 tiles mma.sync.m16n8k16 with f32 sums; the mmas of one
// k-slice sum into a register tile d that starts at zero, and d is folded
// into the accumulator with f32 adds (round to nearest), which keeps runs
// of 64 items inside 1e-5 of max|C|.  The same values in the same order
// whatever the range or the A layout, so tile_stream's C at ogroup 1 and
// tile_panel's f32 C are tile_spgemm's bit for bit.
//
// Layout.  Natural A ([tm][tk]) is staged as it lies, As[m][k] with rows
// BK + 16 bytes apart; k-transposed A ([tk][tm]) as it lies too, As[k][m]
// with rows MBM + 8 elements apart, the B slice's copy applied to A; B as
// Bs[k][n] with rows 128 + 8 elements apart.  So a warp's fragment reads
// fall in 32 distinct banks (f32: bank 4*row + k, or 8*k + m as the row
// pitch is 8 or 24 mod 32 words; bf16: ldmatrix.trans rows 16 bytes apart
// mod 128), as in tile_mma.cuh.
//
// tm = 8.  The piece is 16 rows and only rows 0-7 exist: they alone are
// copied, the A fragment's rows 8-15 are zero registers (never read from
// shared memory: the k-transposed bf16 A is read by ldmatrix.x2), and their
// accumulator rows are not stored.  The other way
// to fit 8 rows to m16n8 is to swap the operands (C^T = B^T A^T, tm in the
// mma's N = 8), which halves the mma work.  Padding was chosen: it keeps
// one fragment code for every BM, and a thin item is bound by its B slice,
// which both forms read whole (PERF.md: tm-8 items against tm-16 items on
// the sweep of tools/sweep_thin.py).
//
// What bounds it on an H100.  A thin item moves its B tile whole (tk x 128
// per piece) and a fraction BM / 128 of a 128-row item's A rows and
// products, so at tm <= 32 it is bound by reading B tiles (from L2 where
// neighbouring row panels share them), not by the tensor cores.  A masked
// item moves only its set slices' B rows (BK x 128 each), so its bytes and
// mmas scale with popcount(word).  On 32 x 32 block-pruned weights (1.15
// slices per tm-32 item) a slice step took 6.23 ns against 5.60 unmasked:
// the item's word, ids and the shorter stretch of slices between them add
// about a tenth (PERF.md).
//
// Warp layout and ring depth, picked by measurement: 4 warps along the
// columns (each BM x 32), a ring of 2 stages for f32 tiles and 3 for bf16
// (kWarpsN, kStages; the code takes any WN that divides 128 into pairs of
// n8 fragments and any depth >= 2).  The alternatives were timed once, a
// build for each, on tile_spgemm's cases of tools/sweep_thin.py (the banded
// 32768^2 pair at T = 128), each held to the plain version within 1e-5 of
// max|C|; to time another, set the two constants and rerun the sweep.  ms
// on an H100 80GB HBM3 at 700 W:
//
//   tiles tm   WN 4: 4 st  3 st  2 st   WN 8: 4 st  3 st  2 st
//   f32    8        2.931 2.757 2.720         3.266 3.166 3.117
//   f32   16        1.704 1.524 1.449         1.984 1.827 1.751
//   f32   32        1.259 1.149 1.142         1.445 1.417 1.412
//   f32   64        1.020 1.012 0.997         1.377 1.362 1.372
//   bf16   8        1.325 1.300 1.350         1.324 1.300 1.385
//   bf16  16        0.737 0.714 0.716         0.740 0.716 0.751
//   bf16  32        0.431 0.422 0.433         0.443 0.445 0.471
//   bf16  64        0.301 0.301 0.307         0.320 0.317 0.334
//
// Masked, on the same card, one build of each f32 depth in one run:
// the sweep's tile_spgemm cases, where the band's edge tiles skip a few
// slices, f32 tm 8 / 16 / 32 / 64: 2.660 / 1.370 / 1.059 / 0.981 ms at 2
// stages, 2.642 / 1.434 / 1.074 / 0.978 at 3; the benchmark's prefill-16k
// tile (tm 32 x 128 x 128, 182,784 items, 28.68% of slices set): 1.306 ms
// at 2 stages, 1.315 at 3 (4.092 and 4.053 unmasked).  2 stages stay.
//
// 8 warps (BM x 16 each, half the A-fragment reuse) lose on f32 tiles,
// where the split's conversions count; fewer stages leave shared memory
// for more blocks per SM (an f32 stage of a 16-row piece is 19.7 KB), which
// hides more latency than a deeper ring on items this short.  tile_stream's
// thin block rings kStages deep too: its nbuf sets the depth of its mma and
// SIMT rings only.
//
// The range loop: one do-while over the slices of each run, its end tested
// once per item.  Timed on the same sweep against the single flat slice
// loop that tested for a run's end after every item (f32 tiles 1-4% slower
// than the one-run block it replaced, tm 8-32) and against a separate
// one-count loop for single runs (as fast for tile_spgemm, up to 3% slower
// for tile_stream): this form matched the one-run block on tile_spgemm's
// cases and was the fastest for tile_stream (PERF.md).

#pragma once

#include "tile_mma.cuh"

namespace spada {
namespace thin {

constexpr int kBN = 128;     // piece columns
constexpr int kWarpsN = 4;   // warps along the piece's columns
// ring depth by tile type
template <typename T>
constexpr int kStages = std::is_same<T, float>::value ? 2 : 3;

// One ring stage of a BM x 128 piece: the A slice, As[m][k] (natural) or
// with A_T As[k][m] (k-transposed), then the B slice Bs[k][n], all padded.
// BM = 8 pieces are 16 rows.
template <typename T, int BM, bool A_T = false>
struct Shape {
  static constexpr int MBM = BM < 16 ? 16 : BM;  // rows of the mma piece
  static constexpr bool kHalf = BM == 8;         // rows 8-15 do not exist
  static constexpr int kRows = kHalf ? 8 : MBM;  // rows copied and stored
  static constexpr int kThreads = 32 * kWarpsN;
  static constexpr int kMT = MBM / 16;           // m16 fragments per warp
  static constexpr int kNT = kBN / kWarpsN / 8;  // n8 fragments per warp
  static constexpr int BK = mma::Op<T>::BK;
  static constexpr int E = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int kAPitch = A_T ? MBM + 8 : BK + E;
  static constexpr int kBPitch = kBN + 8;
  static constexpr int kA = (A_T ? BK : kRows) * kAPitch;
  static constexpr int kElems = kA + BK * kBPitch;
  static constexpr size_t kBytes = (size_t)kElems * sizeof(T);
  static_assert(kNT % 2 == 0, "ldmatrix.x4 reads two n8 fragments");
  static_assert(kA * sizeof(T) % 16 == 0 && kBytes % 16 == 0 &&
                    kAPitch * sizeof(T) % 16 == 0,
                "stages, slices and rows start 16-byte aligned");
};

// Whether the block takes (tm, tk, tn): thin panels (tm in {8, 16, 32} or a
// multiple of 64 that tile_mma.cuh does not take), whole 128-column pieces
// and whole k-slices.
template <typename T>
inline bool takes(int tm, int tk, int tn) {
  const bool rows = tm == 8 || tm == 16 || tm == 32 ||
                    (tm > 0 && tm % 64 == 0 && tm % mma::kBM != 0);
  return rows && tn > 0 && tn % kBN == 0 && tk > 0 &&
         tk % mma::Op<T>::BK == 0;
}

// The piece height for tm (takes() holds).
inline int piece_rows(int tm) { return tm < 64 ? tm : 64; }

// The block's unit (C tile or group) and piece origin: x runs over a
// unit's pieces, row-major, then over the units (tile_mma.cuh's order).
template <int BM>
__device__ __forceinline__ mma::Place place(int tm, int tn) {
  const int across = tn / kBN, pieces = (tm / BM) * across;
  const int p = (int)(blockIdx.x % pieces);
  return {(int)(blockIdx.x / pieces), p / across * BM, p % across * kBN};
}

inline dim3 grid(int units, int tm, int tn) {
  return dim3(units * (tm / piece_rows(tm)) * (tn / kBN));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&x)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][j][e] = 0.0f;
}

// d += As @ Bs over one staged f32 slice, 3xTF32 (fragments as in
// tile_mma.cuh: lane = 4g + t holds A[g | g+8][t | t+4], B[t | t+4][g]).
template <int BM, bool A_T>
__device__ __forceinline__ void slice_sums(
    const float* As, const float* Bs, int wn0, int lane,
    float (&d)[Shape<float, BM>::kMT][Shape<float, BM>::kNT][4]) {
  using S = Shape<float, BM, A_T>;
  constexpr int P = S::kAPitch, PB = S::kBPitch, MT = S::kMT, NT = S::kNT;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < S::BK; kk += mma::Op<float>::KI) {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // the elements (g, t), (g, t+4) and, for 16 rows, (g+8, t),
      // (g+8, t+4) of the fragment's m x k
      const float* p = A_T ? As + (kk + t) * P + i * 16 + g
                           : As + (i * 16 + g) * P + kk + t;
      constexpr int k4 = A_T ? 4 * P : 4, m8 = A_T ? 8 : 8 * P;
      mma::split(p[0], ab[i][0], as[i][0]);
      mma::split(p[k4], ab[i][2], as[i][2]);
      if constexpr (S::kHalf) {
        ab[i][1] = as[i][1] = ab[i][3] = as[i][3] = 0u;
      } else {
        mma::split(p[m8], ab[i][1], as[i][1]);
        mma::split(p[m8 + k4], ab[i][3], as[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* p = Bs + (kk + t) * PB + wn0 + j * 8 + g;
      mma::split(p[0], bb[j][0], bs[j][0]);
      mma::split(p[4 * PB], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_tf32(d[i][j], as[i], bb[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_tf32(d[i][j], ab[i], bs[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_tf32(d[i][j], ab[i], bb[j]);
  }
}

// d += As @ Bs over one staged bf16 slice (lane = 4g + t holds
// A[g | g+8][2t, 2t+1 | 2t+8, 2t+9]; B from ldmatrix.trans of [k][n] rows,
// and k-transposed A from ldmatrix.trans of [k][m] rows, as tile_mma.cuh).
template <int BM, bool A_T>
__device__ __forceinline__ void slice_sums(
    const __nv_bfloat16* As, const __nv_bfloat16* Bs, int wn0, int lane,
    float (&d)[Shape<__nv_bfloat16, BM>::kMT]
              [Shape<__nv_bfloat16, BM>::kNT][4]) {
  using S = Shape<__nv_bfloat16, BM, A_T>;
  constexpr int P = S::kAPitch, PB = S::kBPitch, MT = S::kMT, NT = S::kNT;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: matrix q = lane / 8 is k half q & 1 of n8 fragment q >> 1
  const int lk = (lane & 7) + ((lane >> 3) & 1) * 8, ln = (lane >> 4) * 8;
  // and of A's [k][m] rows: m half q & 1, k half q >> 1
  const int ak = (lane & 7) + (lane >> 4) * 8, am = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < S::BK; kk += mma::Op<__nv_bfloat16>::KI) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (A_T && S::kHalf) {
        // m 0-7 of k halves 0 and 1 (lanes 0-15 address their k rows)
        uint32_t r[2];
        mma::ldmatrix_x2_trans(r, As + (kk + (lane & 15)) * P + i * 16);
        a[i][0] = r[0];
        a[i][2] = r[1];
        a[i][1] = a[i][3] = 0u;
      } else if constexpr (A_T) {
        mma::ldmatrix_x4_trans(a[i], As + (kk + ak) * P + i * 16 + am);
      } else {
        const __nv_bfloat16* p = As + (i * 16 + g) * P + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        if constexpr (S::kHalf) {
          a[i][1] = a[i][3] = 0u;
        } else {
          a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * P);
          a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * P + 8);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, Bs + (kk + lk) * PB + wn0 + j * 8 + ln);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_bf16(d[i][j], a[i], b[j]);
  }
}

// One BM x 128 piece (row0, col0) of the C tiles c_first .. c_end - 1 from
// the items [lo, hi) of an o-sorted worklist; o_of(w) is item w's C tile,
// and `out` (tile_mma.cuh's Store or Add) takes each finished tile.  With
// Add the items may come in any order: a run is then each stretch of
// consecutive items with one o, added once.  A tiles are
// [tm][tk], or with A_T k-transposed [tk][tm]; B tiles [tk][tn].  smem
// holds STAGES stages of Shape<T, BM, A_T>.
//
// MASKED: mask[w * (tm / BM) + row0 / BM] is item w's word for this piece
// row, bit s set where slice s of its A rows holds a nonzero; only the set
// slices are copied and multiplied, in ascending s.  An item with no bit
// costs nothing, and a C tile whose items have none is written as zeros.
template <typename T, int BM, int STAGES, bool A_T, bool MASKED = false,
          class OTile, class Out>
__device__ __forceinline__ void piece(
    const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
    const int32_t* __restrict__ a_tid, const int32_t* __restrict__ b_tid,
    OTile o_of, int lo, int hi, int c_first, int c_end, const Out& out,
    int tm, int tk, int tn, int row0, int col0, unsigned char* smem,
    const uint32_t* __restrict__ mask = nullptr) {
  using S = Shape<T, BM, A_T>;
  constexpr int MT = S::kMT, NT = S::kNT, NTH = S::kThreads;
  static_assert(STAGES >= 2, "ring depth");
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wn0 = (tid >> 5) * (kBN / kWarpsN);
  const int k_steps = tk / S::BK;
  const size_t a_size = (size_t)tm * tk, b_size = (size_t)tk * tn;
  // the piece's first A row: row0 of [tm][tk], or column row0 of [tk][tm]
  const size_t a_row0 = A_T ? (size_t)row0 : (size_t)row0 * tk;
  // MASKED: item w's word is m_row[w * m_pitch]
  const uint32_t* m_row = MASKED ? mask + row0 / BM : nullptr;
  const size_t m_pitch = (size_t)(tm / BM);

  // the next slice to copy: k-slice ik of item iw (MASKED: the lowest bit
  // of `bits`, the item's slices not yet copied), whose piece rows of A
  // start at a_w and columns of B at b_w
  int iw = lo, ik = 0;
  uint32_t bits = 0;
  const T* a_w = a_tiles;
  const T* b_w = b_tiles;
  // move iw to the next item with a slice to copy (MASKED) and point a_w,
  // b_w at it
  auto seek = [&]() {
    if constexpr (MASKED) {
      for (; iw < hi; ++iw)
        if ((bits = m_row[iw * m_pitch]) != 0u) break;
    }
    if (iw < hi) {
      a_w = a_tiles + (size_t)a_tid[iw] * a_size + a_row0;
      b_w = b_tiles + (size_t)b_tid[iw] * b_size + col0;
    }
  };
  seek();
  auto issue_next = [&](int stage) {
    if (iw < hi) {
      T* st = ring + stage * S::kElems;
      const int k0 = (MASKED ? __ffs((int)bits) - 1 : ik) * S::BK;
      // A: kRows x BK (natural) or BK x kRows (A_T) in 16-byte pieces
      constexpr int per_a = (A_T ? S::kRows : S::BK) / S::E;
      constexpr int n_a = (A_T ? S::BK : S::kRows) * per_a;
#pragma unroll
      for (int i = 0; i < (n_a + NTH - 1) / NTH; ++i) {
        const int c = tid + i * NTH;
        if (n_a % NTH == 0 || c < n_a) {
          const int r = c / per_a, e = (c % per_a) * S::E;
          cp_async16(st + r * S::kAPitch + e,
                     A_T ? a_w + (size_t)(k0 + r) * tm + e
                         : a_w + (size_t)r * tk + k0 + e);
        }
      }
      constexpr int per_b = kBN / S::E, n_b = S::BK * per_b;
      static_assert(n_b % NTH == 0, "B copies per thread");
#pragma unroll
      for (int i = 0; i < n_b / NTH; ++i) {
        const int c = tid + i * NTH;
        const int k = c / per_b, n = (c % per_b) * S::E;
        cp_async16(st + S::kA + k * S::kBPitch + n,
                   b_w + (size_t)(k0 + k) * tn + n);
      }
      if constexpr (MASKED) {
        bits &= bits - 1u;
        if (bits == 0u) {
          ++iw;
          seek();
        }
      } else if (++ik == k_steps) {
        ik = 0;
        ++iw;
        seek();
      }
    }
    cp_async_commit();  // one group per slice, empty past the end
  };

  float acc[MT][NT][4];
  zero(acc);
  const int n0 = col0 + wn0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next(s);
  int stage = 0;  // the stage of the slice in hand
  // acc += the next slice's products
  auto slice = [&]() {
    mma::cp_async_wait<STAGES - 2>();  // this thread's copies of the slice
    __syncthreads();  // ... and everyone's; all are done with the last one
    issue_next(stage == 0 ? STAGES - 1 : stage - 1);  // refill the last's
    const T* st = ring + stage * S::kElems;
    float d[MT][NT][4];
    zero(d);
    slice_sums<BM, A_T>(st, st + S::kA, wn0, lane, d);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  };
  int next_c = c_first;  // the first C tile not yet written
  for (int w = lo, k = 0; w < hi;) {
    const int o = o_of(w);
    if constexpr (MASKED) {
      do {  // the set slices of each item of o's run
        for (int n = __popc(m_row[w * m_pitch]); n > 0; --n) slice();
      } while (++w < hi && o_of(w) == o);
    } else {
      do {  // the slices of o's run
        slice();
        if (++k == k_steps) {
          k = 0;
          ++w;
        }
      } while (k != 0 || (w < hi && o_of(w) == o));
    }
    for (; next_c < o; ++next_c)
      out.template put<true, S::kHalf>(next_c, row0, n0, lane, acc);
    out.template put<false, S::kHalf>(o, row0, n0, lane, acc);
    next_c = o + 1;
    zero(acc);
  }
  for (; next_c < c_end; ++next_c)
    out.template put<true, S::kHalf>(next_c, row0, n0, lane, acc);
}

// Call f(std::integral_constant<int, BM>) with BM = piece_rows(tm)
// (takes() holds).
template <class F>
int with_rows(int tm, F f) {
  switch (piece_rows(tm)) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return f(std::integral_constant<int, 64>{});
  }
}

}  // namespace thin
}  // namespace spada
