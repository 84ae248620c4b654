// tile_probe: the FP32 SIMT wide block of the tile kernels with components
// stripped, to attribute its time (written for Hopper, sm_90a).
//
// Replaces: tools/probe_kernel.py : make_variant / run_variant and
// tools/probe_manual.py : make_kernel / make_flat_kernel / run_variant, the
// Pallas ablation variants of the cached megakernel
// (spada_tpu/ops/engine.py : _make_cached_kernel).
//
// What it computes.  The kernel is the SIMT wide block (tile_wide.cuh:
// one 128 x 128 piece of a C tile per block of 256 threads, 8 x 8 per
// thread, BK = 8 k-slices staged through two shared-memory stages,
// accumulator in registers) with a compile-time mode that removes one part
// at a time.  tile_spgemm.cu runs the same code in mode full only for wide
// tiles whose tk the tensor-core block (tile_mma.cuh) does not take; its
// usual wide path is that tensor-core block, whose modes are
// tile_probe_mma.cuh's.  This kernel stays for the shapes that block does
// not take and for rerunning the SIMT block's table (the wrapper's
// block="simt").  Tiles: tm, tn multiples of 128, tk of 8; f32 or bf16
// (widened on load).
//
//   mode      GPU kernel                                    C it writes
//   full      unchanged                                     the C of the run
//   nodma     no global loads of A/B: FMAs over a zeroed     0
//             stage chosen per step from the worklist ids
//   statslot  A[c % a_slots], B[c % b_slots] for every item  run length x A.B
//             of C tile c: no worklist reads
//   oneslot   A[0], B[0] for every item                      run length x A[0].B[0]
//   noacc     oneslot with the accumulator zeroed at each    A[0].B[0] (0 for an
//             item: store, not accumulate                    empty run)
//   nocopy    loads and FMAs, no C store                     nothing (C keeps its
//                                                            sentinel)
//   dots      nodma without the C store                      nothing
//   stat      dots without the worklist reads                nothing
//   loop      one loop over the run reading the worklist     0
//             ids, no loads, no FMAs
//   empty     the (item, k-slice) loop with an empty body    0
//   empty0    no loop, no worklist: the grid and the store   0
//   flat      full on a persistent grid: one block per SM,   the C of the run
//             looping over the pieces
//
// Each TPU mode maps to the GPU mode that means the same on an SM
// (spada_tpu_torch/tools/tile_probe.py holds the table, TPU_MODES): v2full,
// v3acc and real are full (an accumulator always lives in registers here,
// so carrying it as a loop value changes nothing); v2nodma is nodma; v2store
// is noacc, the one mode that stores instead of accumulating (the TPU's
// v2store also read dynamic slots and skipped the DMAs and the copy-out;
// noacc loads slot 0 and writes C, as probe_kernel's noacc did); v2nocopy
// is nocopy; v2dots is dots; v2stat, v3st, v4stat and
// v4unroll are stat (compile-time slots, and a compile-time trip count
// changes nothing in an FMA-bound loop); v2loop and emptyD are loop; empty1
// is empty (a block walks one run, never a group); emptyS and nozero are
// empty0 (a static empty loop compiles to nothing, and there is no output
// window to write back apart from the store).  Of probe_kernel's suffixes,
// _par (a parallel grid) is the base mode, as every GPU grid is parallel;
// _bf16 (bf16 C) and _tiny (an 8 x 128 output window) have no mode here:
// the kernel writes whole f32 C tiles, and nocopy removes the store.
//
// What bounds it on an H100: the card could do the probe's work (bf16 tiles,
// the useful products of a banded pair) at the bytes of its tiles and C;
// this kernel widens bf16 to f32 and runs FP32 FMAs over whole tiles,
// zeros included, so the FMA rate is what it reaches.  The modes split the time into loads (full - nodma), the C store
// (full - nocopy), worklist reads (dots - stat), FMAs and shared-memory
// reads (stat - loop) and the loop, grid and zero store (loop, empty,
// empty0).
//
// A mode that writes no C keeps its result alive by a store under a
// condition the compiler cannot decide and that never holds
// (blockIdx.x == n_c), so the work it times is not removed.
//
// Launch: tile_probe_f32 / tile_probe_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_wide.cuh"

namespace {

using namespace spada::wide;

// grid (C tile, row piece, column piece), as tile_spgemm_wide
template <typename T, int M>
__global__ void __launch_bounds__(256)
    tile_probe_kernel(const T* __restrict__ a_tiles,
                      const T* __restrict__ b_tiles,
                      const int32_t* __restrict__ a_tid,
                      const int32_t* __restrict__ b_tid,
                      const int32_t* __restrict__ tile_ptr,
                      float* __restrict__ c_tiles, int n_c, int tm, int tk,
                      int tn, int a_slots, int b_slots) {
  __shared__ __align__(16) float As[2][kBK][kP];  // k-major A slice
  __shared__ __align__(16) float Bs[2][kBK][kP];
  piece<T, M>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, blockIdx.x,
              blockIdx.y * kP, blockIdx.z * kP, n_c, tm, tk, tn, a_slots,
              b_slots, As, Bs);
}

// flat: one block per SM walks the pieces in grid order
template <typename T>
__global__ void __launch_bounds__(256)
    tile_probe_flat(const T* __restrict__ a_tiles,
                    const T* __restrict__ b_tiles,
                    const int32_t* __restrict__ a_tid,
                    const int32_t* __restrict__ b_tid,
                    const int32_t* __restrict__ tile_ptr,
                    float* __restrict__ c_tiles, int n_c, int tm, int tk,
                    int tn) {
  __shared__ __align__(16) float As[2][kBK][kP];
  __shared__ __align__(16) float Bs[2][kBK][kP];
  const int pr = tm / kP, pc = tn / kP;
  const long long n_pieces = (long long)n_c * pr * pc;
  for (long long p = blockIdx.x; p < n_pieces; p += gridDim.x) {
    const int c = (int)(p / (pr * pc));
    const int rc = (int)(p % (pr * pc));
    piece<T, kFull>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, c,
                    (rc / pc) * kP, (rc % pc) * kP, n_c, tm, tk, tn, 1, 1, As,
                    Bs);
  }
}

template <typename T, int M>
int launch_mode(const T* a, const T* b, const int32_t* ai, const int32_t* bi,
                const int32_t* tp, float* c, int n_c, int tm, int tk, int tn,
                int a_slots, int b_slots, cudaStream_t s) {
  if constexpr (M == kFlat) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    tile_probe_flat<T><<<sms, 256, 0, s>>>(a, b, ai, bi, tp, c, n_c, tm, tk,
                                          tn);
  } else {
    const dim3 grid(n_c, tm / kP, tn / kP);
    tile_probe_kernel<T, M><<<grid, 256, 0, s>>>(a, b, ai, bi, tp, c, n_c, tm,
                                                tk, tn, a_slots, b_slots);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* tile_ptr, void* c_tiles, int n_c,
           int tm, int tk, int tn, int a_slots, int b_slots, int mode,
           void* stream) {
  // the wrapper checks these; a direct caller gets an error, not a bad launch
  if (n_c <= 0 || tm <= 0 || tk <= 0 || tn <= 0 || tm % kP || tn % kP ||
      tk % kBK || a_slots < 1 || b_slots < 1)
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(a_tiles);
  const T* b = static_cast<const T*>(b_tiles);
  const int32_t* ai = static_cast<const int32_t*>(a_tid);
  const int32_t* bi = static_cast<const int32_t*>(b_tid);
  const int32_t* tp = static_cast<const int32_t*>(tile_ptr);
  float* c = static_cast<float*>(c_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPADA_PROBE_CASE(m)                                             \
  case m:                                                               \
    return launch_mode<T, m>(a, b, ai, bi, tp, c, n_c, tm, tk, tn,      \
                             a_slots, b_slots, s);
  switch (mode) {
    SPADA_PROBE_CASE(kFull)
    SPADA_PROBE_CASE(kNoDma)
    SPADA_PROBE_CASE(kStatSlot)
    SPADA_PROBE_CASE(kOneSlot)
    SPADA_PROBE_CASE(kNoAcc)
    SPADA_PROBE_CASE(kNoCopy)
    SPADA_PROBE_CASE(kDots)
    SPADA_PROBE_CASE(kStat)
    SPADA_PROBE_CASE(kLoop)
    SPADA_PROBE_CASE(kEmpty)
    SPADA_PROBE_CASE(kEmpty0)
    SPADA_PROBE_CASE(kFlat)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPADA_PROBE_CASE
}

}  // namespace

// mode: 0 full, 1 nodma, 2 statslot, 3 oneslot, 4 noacc, 5 nocopy, 6 dots,
// 7 stat, 8 loop, 9 empty, 10 empty0, 11 flat
extern "C" int tile_probe_f32(const void* a_tiles, const void* b_tiles,
                              const void* a_tid, const void* b_tid,
                              const void* tile_ptr, void* c_tiles, int n_c,
                              int tm, int tk, int tn, int a_slots,
                              int b_slots, int mode, void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, n_c,
                       tm, tk, tn, a_slots, b_slots, mode, stream);
}

extern "C" int tile_probe_bf16(const void* a_tiles, const void* b_tiles,
                               const void* a_tid, const void* b_tid,
                               const void* tile_ptr, void* c_tiles, int n_c,
                               int tm, int tk, int tn, int a_slots,
                               int b_slots, int mode, void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                               c_tiles, n_c, tm, tk, tn, a_slots, b_slots,
                               mode, stream);
}
