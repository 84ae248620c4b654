// Device helpers shared by the tile kernels of spada_tpu_torch (sm_90a).
//
// tile_spgemm.cu takes the element loads; tile_stream.cu, tile_panel.cu and
// tile_grid.cu also take the block shapes and the k pipeline below: a block
// computes a BM x BN piece of one C tile in registers (RM x RN per thread,
// f32 FMAs) from BK-deep k-slices of A and B that cp.async copies into a
// ring of shared-memory stages.  Shared memory holds the tiles' own type
// (f32 or bf16); bf16 is widened to f32 as the FMA loop reads it.  Every
// shared-memory read of the FMA loop is a 16-byte (8-byte bf16) vector, and
// a warp's reads of one instruction fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spada {

// The part a probe build of a block strips (tile_probe.cu and
// tile_probe_mma.cuh hold the tables and run every mode; the main-path
// kernels build kFull only).  The SIMT wide block (tile_wide.cuh) has the
// first twelve, the tensor-core block (tile_mma.cuh) all; the values are the
// probe entry points' `mode` argument.
namespace mode {
enum : int {
  kFull = 0,
  kNoDma,
  kStatSlot,
  kOneSlot,
  kNoAcc,
  kNoCopy,
  kDots,
  kStat,
  kLoop,
  kEmpty,
  kEmpty0,
  kFlat,
  kOnePass,
  kBigOnly,
  kNoFold,
  kNoBar
};
}  // namespace mode

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ---- cp.async -------------------------------------------------------------

// 16 bytes global -> shared, cached in L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are pending.  The count
// must be an immediate; n above 7 waits for 7, which only waits longer.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// ---- block shapes ----------------------------------------------------------

// A block's BM x BN piece of a C tile, BK-deep k-slices, RM x RN per thread.
template <int BM_, int BN_, int BK_, int RM_, int RN_>
struct Geo {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, RM = RM_, RN = RN_;
  static constexpr int TX = BN / RN, TY = BM / RM, NT = TX * TY;
  static_assert(RN % 4 == 0 && (RM < 4 || RM % 4 == 0) && BK % 4 == 0,
                "thread tile");
  // The thread's i-th row and j-th column of the piece.  Groups of four
  // neighbours sit TY*4 (TX*4) apart, so that a warp's float4 reads of a
  // shared-memory row do not conflict.
  __device__ static int row(int ty, int i) {
    return RM >= 4 ? (i / 4) * (TY * 4) + ty * 4 + i % 4 : ty * RM + i;
  }
  __device__ static int col(int tx, int j) {
    return (j / 4) * (TX * 4) + tx * 4 + j % 4;
  }
};

// The shapes tile_spgemm.cu takes: wide blocks for tm, tn multiples of 128,
// narrow BM x 64 blocks (BM = min(tm, 64)) for short panels.
using GeoWide = Geo<128, 128, 8, 8, 8>;
using Geo8 = Geo<8, 64, 16, 1, 4>;
using Geo16 = Geo<16, 64, 16, 1, 4>;
using Geo32 = Geo<32, 64, 16, 2, 4>;
using Geo64 = Geo<64, 64, 16, 4, 4>;

// Call f(G{}) with the block shape for (tm, tk, tn); cudaErrorInvalidValue
// for a shape none takes (the wrappers check this first).
template <class F>
int with_geo(int tm, int tk, int tn, F f) {
  if (tm > 0 && tm % 128 == 0 && tn > 0 && tn % 128 == 0 && tk > 0 &&
      tk % 8 == 0)
    return f(GeoWide{});
  if (tk <= 0 || tk % 16 != 0 || tn <= 0 || tn % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (tm == 8) return f(Geo8{});
  if (tm == 16) return f(Geo16{});
  if (tm == 32) return f(Geo32{});
  if (tm > 0 && tm % 64 == 0) return f(Geo64{});
  return (int)cudaErrorInvalidValue;
}

// The block a launch ran on, as tile_spgemm.cu, tile_stream.cu and
// tile_panel.cu report it through their int* out-parameter
// (ops.engine._BLOCKS names them in this order): the tensor-core blocks of
// tile_mma.cuh and tile_mma_thin.cuh, the wide SIMT block, the narrow ones,
// and tile_spgemm.cu's warpgroup block (tile_wgmma.cuh).
enum : int {
  kBlockMma = 0,
  kBlockThin = 1,
  kBlockWide = 2,
  kBlockNarrow = 3,
  kBlockWg = 4
};

// What a launch on the SIMT block shape G reports.
template <class G>
constexpr int simt_block() {
  return std::is_same<G, GeoWide>::value ? kBlockWide : kBlockNarrow;
}

// Dynamic shared memory above the 48 KB default must be asked for.
template <class Kernel>
int allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the k pipeline --------------------------------------------------------

// One ring stage of T elements: the A slice, then the B slice Bs[k][n].  A
// natural ([tm][tk]) is staged As[m][k], each row padded by 16 bytes so that
// the float4 reads of a warp's two rows (four rows apart) miss each other's
// banks; A k-transposed ([tk][tm]) is staged As[k][m], unpadded.
template <typename T, class G, bool A_KMAJOR>
struct Stage {
  static constexpr int kAPitch =
      A_KMAJOR ? G::BM : G::BK + 16 / (int)sizeof(T);
  static constexpr int kA = (A_KMAJOR ? G::BK : G::BM) * kAPitch;
  static constexpr int kElems = kA + G::BK * G::BN;
};

// Start the copies of one k-slice (rows row0.., columns col0.., k0..k0+BK)
// of tile a and tile b into a ring stage.  a is [tm][tk] (natural) or, with
// A_KMAJOR, [tk][tm] (k-transposed); the stage keeps that order: As[m][k] or
// As[k][m].  B is [tk][tn] and staged Bs[k][n].
template <typename T, class G, bool A_KMAJOR>
__device__ __forceinline__ void issue_slice(T* As, T* Bs, const T* a,
                                            const T* b, int tm, int tk,
                                            int tn, int row0, int col0,
                                            int k0, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int P = Stage<T, G, A_KMAJOR>::kAPitch;
  if constexpr (A_KMAJOR) {
    static_assert(G::BM % E == 0, "A row of a slice");
    constexpr int per = G::BM / E;
    for (int c = tid; c < G::BK * per; c += G::NT) {
      const int k = c / per, m = (c % per) * E;
      cp_async16(As + k * P + m, a + (size_t)(k0 + k) * tm + row0 + m);
    }
  } else {
    static_assert(G::BK % E == 0, "A row of a slice");
    constexpr int per = G::BK / E;
    for (int c = tid; c < G::BM * per; c += G::NT) {
      const int r = c / per, k = (c % per) * E;
      cp_async16(As + r * P + k, a + (size_t)(row0 + r) * tk + k0 + k);
    }
  }
  constexpr int per_b = G::BN / E;
  for (int c = tid; c < G::BK * per_b; c += G::NT) {
    const int k = c / per_b, n = (c % per_b) * E;
    cp_async16(Bs + k * G::BN + n, b + (size_t)(k0 + k) * tn + col0 + n);
  }
}

// acc += As @ Bs over one staged k-slice, four k at a time: a[i][kk] holds
// A[row i][k4 + kk], read as one vector per row (As[m][k]) or per four rows
// (As[k][m]); the FMAs run in ascending k, as in tile_spgemm.
template <typename T, class G, bool A_KMAJOR>
__device__ __forceinline__ void fma_slice(const T* As, const T* Bs, int tx,
                                          int ty,
                                          float (&acc)[G::RM][G::RN]) {
  constexpr int P = Stage<T, G, A_KMAJOR>::kAPitch;
#pragma unroll
  for (int k4 = 0; k4 < G::BK; k4 += 4) {
    float a[G::RM][4];
    if constexpr (!A_KMAJOR) {
#pragma unroll
      for (int i = 0; i < G::RM; ++i) {
        const float4 v = load4(As + G::row(ty, i) * P + k4);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
    } else if constexpr (G::RM >= 4) {
#pragma unroll
      for (int i = 0; i < G::RM; i += 4)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = load4(As + (k4 + kk) * P + G::row(ty, i));
          a[i][kk] = v.x;
          a[i + 1][kk] = v.y;
          a[i + 2][kk] = v.z;
          a[i + 3][kk] = v.w;
        }
    } else {
#pragma unroll
      for (int i = 0; i < G::RM; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          a[i][kk] = to_f32(As[(k4 + kk) * P + G::row(ty, i)]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[G::RN];
#pragma unroll
      for (int j = 0; j < G::RN; j += 4) {
        const float4 v = load4(Bs + (k4 + kk) * G::BN + G::col(tx, j));
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < G::RM; ++i)
#pragma unroll
        for (int j = 0; j < G::RN; ++j)
          acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
    }
  }
}

// A block's k loop over `steps` k-slices, staged through a ring of nbuf >= 2
// shared-memory stages that cp.async fills nbuf - 1 slices ahead of the FMAs.
// issue(s, As, Bs) starts the copies of slice s (issue_slice); done(s) runs
// after slice s is in the accumulator, the same s on every thread, and must
// not touch shared memory.  Slice s is copy group s of every thread.
template <typename T, class G, bool A_KMAJOR, class Issue, class Done>
__device__ __forceinline__ void pipeline(unsigned char* smem, int nbuf,
                                         int steps, int tx, int ty,
                                         float (&acc)[G::RM][G::RN],
                                         Issue issue, Done done) {
  using S = Stage<T, G, A_KMAJOR>;
  T* ring = reinterpret_cast<T*>(smem);
  for (int s = 0; s < nbuf - 1; ++s) {
    if (s < steps) {
      T* st = ring + (size_t)s * S::kElems;
      issue(s, st, st + S::kA);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait(nbuf - 2);  // slice s has landed for this thread ...
    __syncthreads();  // ... and for all; everyone is done with slice s - 1
    const int f = s + nbuf - 1;  // refill slice s - 1's stage
    if (f < steps) {
      T* st = ring + (size_t)(f % nbuf) * S::kElems;
      issue(f, st, st + S::kA);
    }
    cp_async_commit();
    const T* st = ring + (size_t)(s % nbuf) * S::kElems;
    fma_slice<T, G, A_KMAJOR>(st, st + S::kA, tx, ty, acc);
    done(s);
  }
}

// ---- epilogues ------------------------------------------------------------

__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// rounds each value to the nearest bf16 (ties to even), once
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}

// Write the thread's part of a block's piece of C tile `out` [tm][tn]; with
// ZERO, zeros instead of acc.
template <class G, bool ZERO = false, typename OutT>
__device__ __forceinline__ void store_piece(OutT* out, int tn, int row0,
                                            int col0, int tx, int ty,
                                            const float (&acc)[G::RM][G::RN]) {
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    OutT* p = out + (size_t)(row0 + G::row(ty, i)) * tn + col0;
#pragma unroll
    for (int j = 0; j < G::RN; j += 4)
      put4(p + G::col(tx, j),
           ZERO ? make_float4(0.f, 0.f, 0.f, 0.f)
                : make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                              acc[i][j + 3]));
  }
}

}  // namespace spada
