// tile_probe_mma: the tensor-core block of the tile kernels (tile_mma.cuh)
// with one part stripped or changed per mode, to attribute its time (sm_90a).
// tile_probe_mma_f32.cu and tile_probe_mma_bf16.cu each build one tile type
// from this header, so that the two compile side by side.
//
// Replaces, with tile_probe.cu (the same modes on the FP32 SIMT block):
// tools/probe_kernel.py : make_variant / run_variant and
// tools/probe_manual.py : make_kernel / make_flat_kernel / run_variant, the
// Pallas ablation variants of the cached megakernel
// (spada_tpu/ops/engine.py : _make_cached_kernel).
//
// What it computes.  The kernel is tile_spgemm's tensor-core kernel (one
// 128 x 128 piece of a C tile per block of 256 threads over the tile's run,
// a ring of cp.async stages, 3xTF32 or bf16 mma.sync, each k-slice's sums
// folded into an f32 accumulator) in mode full.  Tiles: tm, tn multiples of
// 128, tk of 32 (f32) or 64 (bf16): what spada::mma::takes accepts.
//
//   mode      what changes                                   C it writes
//   full      nothing                                        the C of the run
//   nodma     no copies of A/B: mmas over a zeroed ring, the  0
//             stage of each step picked from the worklist ids
//   statslot  A[c % a_slots], B[c % b_slots] for every item  run length x A.B
//             of C tile c: no worklist reads
//   oneslot   A[0], B[0] for every item                      run length x A[0].B[0]
//   noacc     oneslot with the accumulator zeroed at each    A[0].B[0] (0 for an
//             item: store, not accumulate                    empty run)
//   nocopy    copies and mmas, no C store                    nothing (C keeps its
//                                                            sentinel)
//   dots      nodma without the C store                      nothing
//   stat      dots without the worklist reads                nothing
//   loop      one loop over the run reading the worklist     0
//             ids, no copies, no mmas
//   empty     the (item, k-slice) loop with an empty body    0
//   empty0    no loop, no worklist: the grid and the store   0
//   flat      full on a persistent grid: one block per SM,   the C of the run
//             looping over the pieces
//   onepass   f32 tiles: operands rounded to TF32 once, one   the 1xTF32 product
//             mma per fragment pair (no split, no small      (TF32 accuracy)
//             parts)
//   bigonly   f32 tiles: the three mmas of 3xTF32, all on the nothing
//             big parts: no x - big, no second cvt
//   nofold    the mmas sum straight into the run's            the C of the run,
//             accumulator: no per-slice register tile, no    sums rounded toward
//             f32 fold                                       zero
//   nobar     nodma without the per-slice __syncthreads      0
//             (nothing is copied, so it guards nothing)
//   ring2,    full with a ring of 2 or 3 stages instead of 4  the C of the run
//   ring3
//   akmajor   full with A staged [k][m] from k-transposed     the C of the run
//             tiles (tile_panel's layout; the caller passes
//             the transposed copy)
//
// So full - bigonly prices the split's conversions, bigonly - onepass the
// two extra mma passes, full - nofold the fold, nodma - nobar the barrier,
// full - nodma the copies, dots - stat the worklist reads, stat - loop the
// mmas and their shared-memory reads.
//
// A mode that writes no C keeps its result alive by a store under a
// condition the compiler cannot decide and that never holds
// (tile_ptr[0] < 0), so the work it times is not removed.

#pragma once

#include "tile_mma.cuh"

namespace spada {
namespace probe {

namespace mma = spada::mma;
using namespace spada::mode;

// the accumulator is kept but C is not written
template <int M>
constexpr bool kSink =
    M == kNoCopy || M == kDots || M == kStat || M == kBigOnly;
// no mma at all: the kernel's skeleton
template <int M>
constexpr bool kSkeleton = M == kLoop || M == kEmpty || M == kEmpty0;

// Store, when `on`: never, but the compiler cannot tell.
struct Sink {
  mma::Store<float> store;
  bool on;
  template <bool ZERO>
  __device__ __forceinline__ void put(
      int c, int row0, int col0, int lane,
      const float (&acc)[mma::kMT][mma::kNT][4]) const {
    if (on) store.template put<ZERO>(c, row0, col0, lane, acc);
  }
};

// The piece (row0, col0) of C tile c in mode M.
template <typename T, int M, int STAGES, bool A_T>
__device__ __forceinline__ void piece(
    const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
    const int32_t* __restrict__ a_tid, const int32_t* __restrict__ b_tid,
    const int32_t* __restrict__ tile_ptr, float* __restrict__ c_tiles, int c,
    int row0, int col0, int tm, int tk, int tn, int a_slots, int b_slots,
    unsigned char* smem) {
  const mma::Store<float> store{c_tiles, (size_t)tm * tn, tn};
  if constexpr (kSkeleton<M>) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = row0 + (warp / mma::kWarpsN) * mma::kWM;
    const int n0 = col0 + (warp % mma::kWarpsN) * (mma::kBN / mma::kWarpsN);
    float acc[mma::kMT][mma::kNT][4];
    mma::zero(acc);
    if constexpr (M != kEmpty0) {
      const int lo = tile_ptr[c], hi = tile_ptr[c + 1];
      if constexpr (M == kEmpty) {
        const int steps = (hi - lo) * (tk / mma::Stage<T>::BK);
        for (int s = 0; s < steps; ++s) asm volatile("");
      } else {
        int x = 0;
        for (int w = lo; w < hi; ++w) x += a_tid[w] ^ b_tid[w];
        if (tile_ptr[0] < 0) c_tiles[0] = (float)x;  // never true
      }
    }
    store.template put<true>(c, r0, n0, lane, acc);
  } else {
    int fix_a = 0, fix_b = 0;
    if constexpr (M == kStatSlot) {
      fix_a = c % a_slots;
      fix_b = c % b_slots;
    }
    const auto run = [&](const auto& out) {
      mma::piece<T, STAGES, A_T, M>(
          a_tiles, b_tiles, a_tid, b_tid, [c](int) { return c; }, tile_ptr[c],
          tile_ptr[c + 1], c, c + 1, out, tm, tk, tn, row0, col0, smem, fix_a,
          fix_b);
    };
    if constexpr (kSink<M>)
      run(Sink{store, tile_ptr[0] < 0});
    else
      run(store);
  }
}

// grid: the pieces of a C tile, then the C tiles (mma::place)
template <typename T, int M, int STAGES, bool A_T>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_probe_mma(const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
                   const int32_t* __restrict__ a_tid,
                   const int32_t* __restrict__ b_tid,
                   const int32_t* __restrict__ tile_ptr,
                   float* __restrict__ c_tiles, int tm, int tk, int tn,
                   int a_slots, int b_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Place p = mma::place(tm, tn);
  piece<T, M, STAGES, A_T>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles,
                           p.unit, p.row0, p.col0, tm, tk, tn, a_slots,
                           b_slots, smem);
}

// loop, empty, empty0: the same grid and store without the block
template <typename T, int M>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_probe_skeleton(const T* __restrict__ a_tiles,
                        const T* __restrict__ b_tiles,
                        const int32_t* __restrict__ a_tid,
                        const int32_t* __restrict__ b_tid,
                        const int32_t* __restrict__ tile_ptr,
                        float* __restrict__ c_tiles, int tm, int tk, int tn) {
  static_assert(kSkeleton<M>, "a mode without mmas");
  const mma::Place p = mma::place(tm, tn);
  piece<T, M, mma::kDeepest, false>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                                    c_tiles, p.unit, p.row0, p.col0, tm, tk, tn,
                                    1, 1, nullptr);
}

// flat: one block per SM walks the pieces in grid order
template <typename T>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_probe_mma_flat(const T* __restrict__ a_tiles,
                        const T* __restrict__ b_tiles,
                        const int32_t* __restrict__ a_tid,
                        const int32_t* __restrict__ b_tid,
                        const int32_t* __restrict__ tile_ptr,
                        float* __restrict__ c_tiles, int n_c, int tm, int tk,
                        int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int across = tn / mma::kBN, pieces = (tm / mma::kBM) * across;
  const long long n_pieces = (long long)n_c * pieces;
  for (long long p = blockIdx.x; p < n_pieces; p += gridDim.x) {
    const int c = (int)(p / pieces), q = (int)(p % pieces);
    piece<T, kFull, mma::kDeepest, false>(
        a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, c,
        q / across * mma::kBM, q % across * mma::kBN, tm, tk, tn, 1, 1, smem);
    __syncthreads();  // the next piece's copies overwrite the ring
  }
}

template <typename T, int M, int STAGES = mma::kDeepest, bool A_T = false>
int launch_mode(const T* a, const T* b, const int32_t* ai, const int32_t* bi,
                const int32_t* tp, float* c, int n_c, int tm, int tk, int tn,
                int a_slots, int b_slots, cudaStream_t s) {
  const dim3 grid = mma::grid(n_c, tm, tn);
  if constexpr (kSkeleton<M>) {
    tile_probe_skeleton<T, M><<<grid, mma::kThreads, 0, s>>>(a, b, ai, bi, tp,
                                                           c, tm, tk, tn);
  } else if constexpr (M == kFlat) {
    const size_t smem = mma::kDeepest * mma::Stage<T>::kBytes;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int err = spada::allow_smem(tile_probe_mma_flat<T>, smem);
    if (err) return err;
    tile_probe_mma_flat<T><<<sms, mma::kThreads, smem, s>>>(a, b, ai, bi, tp,
                                                           c, n_c, tm, tk, tn);
  } else {
    const size_t smem = STAGES * mma::Stage<T, A_T>::kBytes;
    const int err =
        spada::allow_smem(tile_probe_mma<T, M, STAGES, A_T>, smem);
    if (err) return err;
    tile_probe_mma<T, M, STAGES, A_T><<<grid, mma::kThreads, smem, s>>>(
        a, b, ai, bi, tp, c, tm, tk, tn, a_slots, b_slots);
  }
  return (int)cudaGetLastError();
}

// mode: tile_pipe.cuh's spada::mode (0 full .. 15 nobar).  stages: the ring's
// depth, 2, 3 or 4; a_t: a_tiles are k-transposed [tk][tm]; both only with
// mode full (ring2, ring3, akmajor).  F32: build the modes of f32 tiles.
template <typename T, bool F32 = std::is_same<T, float>::value>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* tile_ptr, void* c_tiles, int n_c,
           int tm, int tk, int tn, int a_slots, int b_slots, int mode,
           int stages, int a_t, void* stream) {
  // the wrapper checks these; a direct caller gets an error, not a bad launch
  if (n_c <= 0 || !mma::takes<T>(tm, tk, tn) || a_slots < 1 || b_slots < 1 ||
      ((stages != mma::kDeepest || a_t) && mode != kFull) ||
      (stages != mma::kDeepest && a_t))
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(a_tiles);
  const T* b = static_cast<const T*>(b_tiles);
  const int32_t* ai = static_cast<const int32_t*>(a_tid);
  const int32_t* bi = static_cast<const int32_t*>(b_tid);
  const int32_t* tp = static_cast<const int32_t*>(tile_ptr);
  float* c = static_cast<float*>(c_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPADA_PROBE_ARGS a, b, ai, bi, tp, c, n_c, tm, tk, tn, a_slots, b_slots, s
  if (a_t) return launch_mode<T, kFull, mma::kDeepest, true>(SPADA_PROBE_ARGS);
  if (stages == 2) return launch_mode<T, kFull, 2>(SPADA_PROBE_ARGS);
  if (stages == 3) return launch_mode<T, kFull, 3>(SPADA_PROBE_ARGS);
  if (stages != mma::kDeepest) return (int)cudaErrorInvalidValue;
#define SPADA_PROBE_CASE(m) \
  case m:                   \
    return launch_mode<T, m>(SPADA_PROBE_ARGS);
  switch (mode) {
    SPADA_PROBE_CASE(kFull)
    SPADA_PROBE_CASE(kNoDma)
    SPADA_PROBE_CASE(kStatSlot)
    case kOneSlot:  // statslot with one slot each
      return launch_mode<T, kStatSlot>(a, b, ai, bi, tp, c, n_c, tm, tk, tn, 1,
                                       1, s);
    SPADA_PROBE_CASE(kNoAcc)
    SPADA_PROBE_CASE(kNoCopy)
    SPADA_PROBE_CASE(kDots)
    SPADA_PROBE_CASE(kStat)
    SPADA_PROBE_CASE(kLoop)
    SPADA_PROBE_CASE(kEmpty)
    SPADA_PROBE_CASE(kEmpty0)
    SPADA_PROBE_CASE(kFlat)
    SPADA_PROBE_CASE(kNoFold)
    SPADA_PROBE_CASE(kNoBar)
    default:
      break;
  }
  if constexpr (F32) {
    switch (mode) {
      SPADA_PROBE_CASE(kOnePass)
      SPADA_PROBE_CASE(kBigOnly)
      default:
        break;
    }
  }
#undef SPADA_PROBE_CASE
#undef SPADA_PROBE_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace probe
}  // namespace spada
