// The warpgroup block of tile_spgemm (sm_90a): the dense, unmasked f32 runs
// of 64-row panels (tm a multiple of 64) that a prepared launch hands over
// with a schedule of panel pairs (ops.engine.wg_schedule).  It stands beside
// the thin block of tile_mma_thin.cuh, which runs every other thin launch,
// and beside the same TPU kernel: spada_tpu/ops/engine.py:726
// _run_pallas_cached (tile_spgemm.cu's header).
//
// Work unit.  A unit is two 64-row pieces (C tile, piece row) whose runs
// read the same B tiles in the same order (consecutive panels of one
// expert, or the two halves of a taller tile), or one piece that pairs with
// none.  The grid is persistent: one block per SM walks the work items x =
// blockIdx.x, + gridDim.x, ..., item x being unit x / (tn / 128) and its
// 128 C columns x % (tn / 128), so the loads of the next item overlap the
// last one's epilogue.  A block is three warpgroups:
//   producer  warp 0, one thread: TMA loads of each 32-deep k-slice (the
//             two pieces' A rows, 2 x 64 x 32, and B's 32 x 128) into a ring
//             of kStages stages, across item and unit boundaries, each
//             stage's arrival on an mbarrier (full);
//   split     warps 1-3: the small TF32 part of each staged A slice, written
//             once into the stage's second A buffer (ready);
//   consumers two warpgroups of 64 C columns each, registers raised to 232
//             by setmaxnreg (the producer's lowered to 40): wgmma on the
//             stage, then it is released to the producer (empty).
// A unit's C pieces are written once at the end of its run, from registers
// (st.global.cs: C is not read again); a unit with no items writes zeros.
// A piece that pairs with none is loaded into both halves and stored once.
//
// Layout: the swapped product, C^T = B^T A^T.  TF32 wgmma reads its
// shared-memory operand K-major only.  A tiles ([tm][tk]) are K-major as they
// lie, so the A slice is wgmma's shared-memory operand (N = the pair's 128
// rows), as TMA lays it with the 128-byte swizzle; its big part is the raw
// f32, which the tensor cores read as TF32 (the low 13 bits ignored), and its
// small part, x - big rounded to TF32, is the second buffer.  B tiles
// ([tk][tn]) are MN-major, so the B slice is read from shared memory into
// wgmma's register operand (M = 64 C columns per warpgroup), which
// transposes it for free and splits it in registers (big = cvt.rna.tf32,
// small = the rest rounded).  Which C column a register row holds is free:
// the map below puts a warp's 32 reads of the swizzled B rows in 32 banks.
// The other design, B transposed and split in shared memory, stores B twice
// and reads it back through wgmma: a stage would move 192 KB through shared
// memory against this design's 176 (below), and the block's time follows
// those bytes (measured below), so it was not built.
//
// Arithmetic: 3xTF32, as the thin block: per k-step B_big.A_small,
// B_small.A_big, B_big.A_big, small terms first; the small.small term is
// dropped.  The tensor cores' f32 sums round toward zero, so the wgmmas of a
// fold span (kFold stages, 4 x 32 = 128 deep) sum into a fresh register tile
// d (scale-d 0 on the first), and d is added into the f32 accumulator with
// round-to-nearest adds.  The span, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (max|C - C_f64| / max|C_f64| on the expert cell's shape of
// tools/sweep_wgmma, then on runs of 64 items at tk = tn = 512, with the
// kernel's ms on the first, before the per-warp arrivals below; the thin
// block's errors are 4.45e-7 and 1.32e-6):
//
//   fold span (k)      32        64        128       256       whole run
//   expert shape       4.77e-7   5.75e-7   1.16e-6   2.01e-6   1.64e-5
//   64 items, tk 512   1.52e-6   1.17e-6   1.19e-6   2.04e-6   2.31e-4
//   ms                 11.27     10.86     10.61     -         10.89
//
// so a span of 128 (1.2e-6, within 1e-5 of max|C| where the whole run is
// not) at 3-6% less time than a span of 32.
//
// What bounds it on an H100.  3xTF32 on the tensor cores: 165 TFLOP/s of
// f32 work, 5.78 ms for the expert cell's 954-961 useful GFLOP.  A stage's
// 12 m64n128k8 wgmmas per consumer read 48 KB of A from shared memory, and
// the stage's TMA writes, the split and the B reads add 80 KB: 176 KB per
// 1,536 tensor cycles.  Shared memory is what binds it: on the expert shape,
// in one run, the block took 10.25-10.67 ms, 9.09 without B's TMA loads
// (160 KB a stage), 6.61 with one wgmma of the three (112 KB) and 5.10
// with none (80 KB), times that follow the stage's shared-memory bytes and
// not its tensor work; storing the small part and reading B through shared
// memory are what a faster block would cut first.  Operands from L2:
// a work item reads its two pieces' A rows and 128 columns of B, 32 KB per
// 32-deep slice for 128 x 128 C values, where the thin block reads 24 KB
// for 64 x 128; on the expert cell's shape (7,280 units, 14,560 work items of
// 64 slices) about 29.8 GB per product against the thin block's 44 GB.
//
// Block shape and ring, timed on tools/sweep_wgmma's expert shape (ms; the
// same card and call as the thin block's 17.7-18.2): ring 4 stages 9.51-9.69
// against 3 stages 9.69 (the ring is the TMA's only buffer; 4 kept, 197 KB of
// shared memory); one barrier arrival per warp, not per thread, 10.93 ->
// 9.55; units in B-run order 10.81-11.26 against C-tile order 11.33-11.53;
// two consumer warpgroups taking turns to issue (named barriers) 9.63-9.82
// against 9.68-10.05 (no gain, not kept); one group in flight across stages
// (fragments of two stages in registers) 10.19-10.41: ptxas serializes the
// wgmmas there (C7518).  Two consumer warpgroups of 64 x 128 are what the
// registers hold: acc and d take 128 of a thread's 232.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver

#include "tile_mma.cuh"

namespace spada {
namespace wg {

constexpr int kRows = 64;                 // rows of a piece
constexpr int kPair = 2 * kRows;          // rows of a unit
constexpr int kBN = 128;                  // C columns of a work item
constexpr int kBK = 32;                   // k per stage: one 128-byte row
constexpr int kSteps = kBK / 8;           // wgmma k-steps per stage
constexpr int kStages = 4;                // ring depth
constexpr int kFold = 4;                  // stages per fold span
constexpr int kConsumers = 2;             // warpgroups of 64 columns
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSplit = 96;                // threads of the split warps
constexpr int kABytes = kPair * kBK * 4;  // a stage's A (and A small) slice
constexpr int kBBox = kBK * 32 * 4;       // one B box: 32 k x 32 columns
constexpr int kBBytes = kBK * kBN * 4;
constexpr int kStageBytes = 2 * kABytes + kBBytes;
constexpr int kTx = kABytes + kBBytes;    // bytes TMA lands per stage
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 3 * kStages * 8 +
                         1024;  // the ring 1024-aligned, then the barriers
static_assert(kStageBytes % 1024 == 0 && kBBox % 1024 == 0,
              "swizzled tiles start 1024-byte aligned");

// Whether the block takes (tm, tk, tn) f32 tiles.
inline bool takes(int tm, int tk, int tn) {
  return tm > 0 && tm % kRows == 0 && tn > 0 && tn % kBN == 0 && tk > 0 &&
         tk % kBK == 0;
}

// ---- host: tensor maps --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of rows x cols f32 (row-major), boxes of box_rows x 32 columns
// (128 bytes) landed with the 128-byte swizzle.
inline int tensor_map(CUtensorMap* m, const float* base, uint64_t cols,
                      uint64_t rows, uint32_t box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(float)};
  const cuuint32_t box[2] = {32, box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r =
      enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
          dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---- device: barriers, TMA, wgmma ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that never
// ends (a fault in the schedule) traps after 2^26 polls, seconds, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 26)) asm volatile("trap;\n");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// box (c0 = column, c1 = row) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the shared-memory descriptor of a K-major operand: rows of 128 bytes,
// 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// the part of x the tensor cores drop when they read it as TF32, rounded
// to TF32
__device__ __forceinline__ float small_part(float x) {
  const float big = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(mma::to_tf32(x - big));
}

template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ void keep(uint32_t (&x)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

#define SPADA_WG_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, scale_d 0: d = 0 first) += a (64 x 8 TF32, registers) @
// the 8 x 128 K-major operand at `b`
__device__ __forceinline__ void mma_64x128(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SPADA_WG_D8(0), SPADA_WG_D8(8), SPADA_WG_D8(16), SPADA_WG_D8(24),
        SPADA_WG_D8(32), SPADA_WG_D8(40), SPADA_WG_D8(48), SPADA_WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef SPADA_WG_D8

// ---- the block ----------------------------------------------------------------

// A unit of the schedule: its two pieces (C tile o, piece row r; a piece
// that pairs with none is both), the first item of each run and the run's
// length.
struct Unit {
  int o1, r1, o2, r2, lo1, lo2, n;
  bool pair;
};

__device__ __forceinline__ Unit unit_of(const int32_t* __restrict__ units,
                                        const int32_t* __restrict__ tile_ptr,
                                        int u, int pieces) {
  const int p1 = units[2 * u], p2 = units[2 * u + 1];
  const int q = p2 >= 0 ? p2 : p1;
  Unit x;
  x.o1 = p1 / pieces;
  x.r1 = p1 % pieces;
  x.o2 = q / pieces;
  x.r2 = q % pieces;
  x.pair = p2 >= 0;
  x.lo1 = tile_ptr[x.o1];
  x.n = tile_ptr[x.o1 + 1] - x.lo1;
  x.lo2 = tile_ptr[x.o2];
  return x;
}

// The block over work items blockIdx.x, + gridDim.x, ... < n_work of the
// schedule `units` (int32 [U][2]: two piece ids o * (tm / 64) + r, the
// second -1 where the first pairs with none), tn / 128 items per unit.
// a_map: A tiles as (n_a * tm) x tk, boxes of 64 x 32; b_map: B tiles as
// (n_b * tk) x tn, boxes of 32 x 32.
__device__ __forceinline__ void block(
    const CUtensorMap* a_map, const CUtensorMap* b_map,
    const int32_t* __restrict__ a_tid, const int32_t* __restrict__ b_tid,
    const int32_t* __restrict__ tile_ptr, const int32_t* __restrict__ units,
    int n_work, float* __restrict__ c_tiles, int tm, int tk, int tn,
    unsigned char* smem_raw) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(ready(s), kSplit / 32);
      bar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int pieces = tm / kRows, across = tn / kBN, k_slices = tk / kBK;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int stage = 0;
    uint32_t phase = 0;
    if (tid == 0) {  // producer
      for (int x = blockIdx.x; x < n_work; x += gridDim.x) {
        const Unit u = unit_of(units, tile_ptr, x / across, pieces);
        const int col0 = (x % across) * kBN;
        for (int i = 0; i < u.n; ++i) {
          const int a1 = a_tid[u.lo1 + i] * tm + u.r1 * kRows;
          const int a2 = a_tid[u.lo2 + i] * tm + u.r2 * kRows;
          const int b = b_tid[u.lo1 + i] * tk;
          for (int k = 0; k < tk; k += kBK) {
            bar_wait(empty(stage), phase ^ 1);
            const uint32_t st = base + stage * kStageBytes, bar = full(stage);
            bar_expect(bar, kTx);
            tma_load(st, a_map, k, a1, bar);
            tma_load(st + kABytes / 2, a_map, k, a2, bar);
#pragma unroll
            for (int q = 0; q < kBN / 32; ++q)
              tma_load(st + 2 * kABytes + q * kBBox, b_map, col0 + 32 * q,
                       b + k, bar);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (tid >= 32) {  // split
      for (int x = blockIdx.x; x < n_work; x += gridDim.x) {
        const Unit u = unit_of(units, tile_ptr, x / across, pieces);
        for (int s = u.n * k_slices; s > 0; --s) {
          bar_wait(full(stage), phase);
          const float4* src =
              reinterpret_cast<const float4*>(smem + stage * kStageBytes);
          float4* dst = reinterpret_cast<float4*>(smem + stage * kStageBytes +
                                                  kABytes);
#pragma unroll 4
          for (int e = tid - 32; e < kABytes / 16; e += kSplit) {
            const float4 v = src[e];
            dst[e] = make_float4(small_part(v.x), small_part(v.y),
                                 small_part(v.z), small_part(v.w));
          }
          // the async proxy (wgmma) reads what the generic stores wrote;
          // one arrival per warp
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if ((tid & 31) == 0) bar_arrive(ready(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cg = tid / 128 - 1, ct = tid % 128;
  const int w = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  // Register row 16w + 8h + g of this warpgroup's 64 x 8 operand holds C
  // column n0 + 4h: its B box is 2cg + (w >> 1), and its 16-byte chunk of a
  // B row is chunk0 + h, so that the swizzle (chunk ^ k % 8) spreads a warp's
  // 32 reads of one register over 32 banks.
  const int n0 =
      64 * cg + 32 * (w >> 1) + 16 * (g >> 2) + 8 * (w & 1) + (g & 3);
  const int chunk0 = 4 * (g >> 2) + 2 * (w & 1);
  const int b_off = 2 * kABytes + (2 * cg + (w >> 1)) * kBBox + 4 * (g & 3);
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int x = blockIdx.x; x < n_work; x += gridDim.x) {
    const Unit u = unit_of(units, tile_ptr, x / across, pieces);
    const int col0 = (x % across) * kBN;
    const int n_s = u.n * k_slices;
    for (int s = 0, span = 0; s < n_s; ++s) {
      bar_wait(full(stage), phase);
      bar_wait(ready(stage), phase);
      const unsigned char* st = smem + stage * kStageBytes;
      const uint64_t da = desc(base + stage * kStageBytes);
      const uint64_t ds = desc(base + stage * kStageBytes + kABytes);
      // each k-step's B fragment is read and split while the tensor cores
      // run the k-steps before it; the registers stay untouched until the
      // wait (wgmma reads them asynchronously)
      uint32_t fb[kSteps][4], fs[kSteps][4];
      keep(d);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 8 * ks + 4 * kh + t;
            const float v = *reinterpret_cast<const float*>(
                st + b_off + k * 128 + (((chunk0 + h) ^ (k & 7)) << 4));
            mma::split(v, fb[ks][h + 2 * kh], fs[ks][h + 2 * kh]);
          }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        mma_64x128(d, fb[ks], ds + 2 * ks, (span == 0 && ks == 0) ? 0 : 1);
        mma_64x128(d, fs[ks], da + 2 * ks, 1);
        mma_64x128(d, fb[ks], da + 2 * ks, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep(d);
      keep(fb);
      keep(fs);
      if (lane == 0) bar_arrive(empty(stage));  // the warp is done with it
      if (++span == kFold || s == n_s - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        span = 0;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // d[4j + e]: C row 8j + 2t + (e & 1) of the pair (rows 64.. the second
    // piece's), C column n0 + 4 (e >> 1)
    float* out[2] = {
        c_tiles + ((size_t)u.o1 * tm + (size_t)u.r1 * kRows) * tn + col0 + n0,
        c_tiles + ((size_t)u.o2 * tm + (size_t)u.r2 * kRows) * tn + col0 + n0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j >= 8 && !u.pair) break;
      float* p = out[j >> 3] + (size_t)(8 * (j & 7) + 2 * t) * tn;
      __stcs(p, acc[4 * j]);
      __stcs(p + tn, acc[4 * j + 1]);
      __stcs(p + 4, acc[4 * j + 2]);
      __stcs(p + tn + 4, acc[4 * j + 3]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  }
}

}  // namespace wg
}  // namespace spada
