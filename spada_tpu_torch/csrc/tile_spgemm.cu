// tile_spgemm: the tile engine of spada_tpu_torch, written for Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_cached_kernel / _run_pallas_cached
// (the Pallas kernel behind run_worklist_cached).
//
// What it computes.  For every C tile c, the o-sorted worklist holds one run
// of items tile_ptr[c] .. tile_ptr[c+1]; item w contributes
// A[a_tid[w]] (tm x tk) @ B[b_tid[w]] (tk x tn).  C[c] is the f32 sum of its
// run, and an empty run gives an exact zero tile (the TPU kernel's lo == hi
// branch).  A and B tiles are f32 or bf16.
//
// What bounds it on an H100.  Per item the kernel does 2*tm*tk*tn FLOPs and
// moves (tm*tk + tk*tn) tile elements.  For the tile edges the planner picks
// (tk = tn = T in 128..512) and tm = T this is T/4 = 32-128 FLOP per byte of
// f32, so tall panels are bound by the arithmetic (and by L2's operand
// traffic once that runs on tensor cores, tile_mma.cuh); short panels (tm =
// 8..32) drop to a few FLOP per byte and are bound by reading B tiles.
//
// Design.  The TPU kernel kept whole tiles in VMEM slot caches planned on
// the host (Belady) and added each item's product into a VMEM accumulator.
// An SM has 227 KB of shared memory, less than one 512 x 512 f32 C tile, so
// here a C tile is split across blocks, one per piece (row block, column
// block); tile_mma.cuh sets the order they launch in.  A block walks its C
// tile's whole run, streaming k-slices of the A rows and B columns it needs
// through shared memory, and keeps its part of the accumulator in registers
// for the whole run, so C is written
// exactly once and never read.  Tile reuse across C tiles is left to the
// 50 MB L2 instead of a host slot plan.  Four block shapes, tried in this
// order (ops.engine.tile_block mirrors the rule):
//   mma    (tm a multiple of 128, tn of 128, tk of 32 f32 / 64 bf16): the
//          tensor-core block of tile_mma.cuh over the item range
//          tile_ptr[c] .. tile_ptr[c+1], a 4-stage cp.async ring; f32 tiles
//          run 3xTF32 (f32-level error), bf16 tiles bf16 mma with f32 sums.
//          The planner's shape where rows are dense.
//   thin   (tm in {8, 16, 32} or a multiple of 64 that mma does not take, tn
//          a multiple of 128, tk of 32 f32 / 64 bf16): the thin tensor-core
//          block of tile_mma_thin.cuh, a BM x 128 piece (BM = min(tm, 64),
//          tm = 8 on a 16-row piece), the same arithmetic, a 2-stage (f32)
//          or 3-stage (bf16) ring.  The row panels the per-row-group
//          planner picks on sparse rows.
//   wide   (tm and tn multiples of 128, tk of 8 but not of the mma BK): the
//          FP32 SIMT block of tile_wide.cuh (128 x 128, 8 x 8 per thread),
//          which tile_probe.cu also runs; every product and sum an f32 FMA.
//   narrow (every other tm in {8, 16, 32} or a multiple of 64, tn a multiple
//          of 64, tk of 16): BM = min(tm, 64) rows x 64 columns per block,
//          RM x 4 per thread, BK = 16, one stage, f32 FMAs.
// and a fifth that no shape picks by itself:
//   wg     (f32 tiles, tm a multiple of 64, tn of 128, tk of 32): the
//          warpgroup block of tile_wgmma.cuh (TMA, an mbarrier ring, wgmma),
//          persistent, over a schedule of 64-row pieces paired by their B
//          runs.  tile_spgemm_wg_f32 launches it; ops.engine routes a
//          prepared launch of dense f32 runs of 64-row panels to it.
//
// Launch: tile_spgemm_f32 / tile_spgemm_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream, write the block it runs on to
// *block (tile_pipe.cuh's kBlock*: 0 mma, 1 thin, 2 wide, 3 narrow, 4 wg) and
// return cudaGetLastError().  `mask`, null or the thin block's slice words
// (uint32 [items][tm / BM], bit s: slice s of that piece row of the item's A
// tile has a nonzero), skips the k-slices of A that are all zero; another
// block with a mask is an invalid value.  tile_spgemm_occupancy launches nothing: it
// reports the block a shape runs on and how many of it one SM holds at once.

#include "tile_mma.cuh"
#include "tile_mma_thin.cuh"
#include "tile_wgmma.cuh"
#include "tile_wide.cuh"

namespace {

using spada::kBlockMma;
using spada::kBlockNarrow;
using spada::kBlockThin;
using spada::kBlockWg;
using spada::kBlockWide;
using spada::to_f32;

// ---- mma: 128 x 128 of one C tile per block, tensor cores -----------------
constexpr int kStages = spada::mma::kDeepest;

template <typename T>
__global__ void __launch_bounds__(spada::mma::kThreads, 1)
    tile_spgemm_mma(const T* __restrict__ a_tiles,
                    const T* __restrict__ b_tiles,
                    const int32_t* __restrict__ a_tid,
                    const int32_t* __restrict__ b_tid,
                    const int32_t* __restrict__ tile_ptr,
                    float* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const spada::mma::Place p = spada::mma::place(tm, tn);
  const int c = p.unit;
  spada::mma::piece<T, kStages, false>(
      a_tiles, b_tiles, a_tid, b_tid, [c](int) { return c; }, tile_ptr[c],
      tile_ptr[c + 1], c, c + 1,
      spada::mma::Store<float>{c_tiles, (size_t)tm * tn, tn}, tm, tk, tn,
      p.row0, p.col0, smem);
}

// ---- thin: BM x 128 of one C tile per block, tensor cores -----------------
// MASKED: only the k-slices that item w's words of `mask` set
// (tile_mma_thin.cuh's piece)
template <typename T, int BM, bool MASKED>
__global__ void __launch_bounds__(32 * spada::thin::kWarpsN)
    tile_spgemm_thin(const T* __restrict__ a_tiles,
                     const T* __restrict__ b_tiles,
                     const int32_t* __restrict__ a_tid,
                     const int32_t* __restrict__ b_tid,
                     const int32_t* __restrict__ tile_ptr,
                     const uint32_t* __restrict__ mask,
                     float* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const spada::mma::Place p = spada::thin::place<BM>(tm, tn);
  const int c = p.unit;
  spada::thin::piece<T, BM, spada::thin::kStages<T>, false, MASKED>(
      a_tiles, b_tiles, a_tid, b_tid, [c](int) { return c; }, tile_ptr[c],
      tile_ptr[c + 1], c, c + 1,
      spada::mma::Store<float>{c_tiles, (size_t)tm * tn, tn}, tm, tk, tn,
      p.row0, p.col0, smem, mask);
}

// ---- wg: 128 x 128 of a pair of 64-row pieces per work item, persistent ---
__global__ void __launch_bounds__(spada::wg::kThreads, 1)
    tile_spgemm_wg(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const int32_t* __restrict__ a_tid,
                   const int32_t* __restrict__ b_tid,
                   const int32_t* __restrict__ tile_ptr,
                   const int32_t* __restrict__ units, int n_work,
                   float* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  spada::wg::block(&a_map, &b_map, a_tid, b_tid, tile_ptr, units, n_work,
                   c_tiles, tm, tk, tn, smem);
}

// ---- wide: 128 x 128 of one C tile per block, 256 threads -----------------
constexpr int kWide = spada::wide::kP;
constexpr int kWideBK = spada::wide::kBK;

template <typename T>
__global__ void __launch_bounds__(256)
    tile_spgemm_wide(const T* __restrict__ a_tiles,
                     const T* __restrict__ b_tiles,
                     const int32_t* __restrict__ a_tid,
                     const int32_t* __restrict__ b_tid,
                     const int32_t* __restrict__ tile_ptr,
                     float* __restrict__ c_tiles, int tm, int tk, int tn) {
  __shared__ __align__(16) float As[2][kWideBK][kWide];  // k-major A slice
  __shared__ __align__(16) float Bs[2][kWideBK][kWide];
  spada::wide::piece<T, spada::wide::kFull>(
      a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, blockIdx.x,
      blockIdx.y * kWide, blockIdx.z * kWide, 0, tm, tk, tn, 1, 1, As, Bs);
}

// ---- narrow: BM x 64 of one C tile per block ------------------------------
constexpr int kNarrowBN = 64;
constexpr int kNarrowBK = 16;
constexpr int kNarrowTN = 4;  // C columns per thread

// thread (ty, tx) owns RM rows x 4 columns of the block's piece
template <typename T, int BM, int RM>
__global__ void __launch_bounds__((BM / RM) * (kNarrowBN / kNarrowTN))
    tile_spgemm_narrow(const T* __restrict__ a_tiles,
                       const T* __restrict__ b_tiles,
                       const int32_t* __restrict__ a_tid,
                       const int32_t* __restrict__ b_tid,
                       const int32_t* __restrict__ tile_ptr,
                       float* __restrict__ c_tiles, int tm, int tk, int tn) {
  constexpr int BN = kNarrowBN, BK = kNarrowBK, TN = kNarrowTN;
  constexpr int NT = (BM / RM) * (BN / TN);
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int c = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[RM][TN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int lo = tile_ptr[c];
  const int hi = tile_ptr[c + 1];
  for (int w = lo; w < hi; ++w) {
    const T* a = a_tiles + (size_t)a_tid[w] * tm * tk + (size_t)row0 * tk;
    const T* b = b_tiles + (size_t)b_tid[w] * tk * tn + col0;
    for (int k0 = 0; k0 < tk; k0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, k = i % BK;
        As[k][r] = to_f32(a[(size_t)r * tk + k0 + k]);
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int k = i / BN, j = i % BN;
        Bs[k][j] = to_f32(b[(size_t)(k0 + k) * tn + j]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[RM], bv[TN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = As[k][ty * RM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // one 16-byte store per row: tn and col0 are multiples of 64
  float* out = c_tiles + (size_t)c * tm * tn + (size_t)(row0 + ty * RM) * tn +
               col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    *reinterpret_cast<float4*>(out + (size_t)i * tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// mask: null, or the thin block's slice words (tile_mma_thin.cuh's piece),
// one per item and piece row; the other blocks take no mask.
template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* tile_ptr, const void* mask,
           void* c_tiles, int n_c, int tm, int tk, int tn, int* block,
           void* stream) {
  if (n_c <= 0 || tm <= 0 || tk <= 0 || tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(a_tiles);
  const T* b = static_cast<const T*>(b_tiles);
  const int32_t* ai = static_cast<const int32_t*>(a_tid);
  const int32_t* bi = static_cast<const int32_t*>(b_tid);
  const int32_t* tp = static_cast<const int32_t*>(tile_ptr);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  float* c = static_cast<float*>(c_tiles);
  // a word holds the slices of one item's piece row
  if (m && (!spada::thin::takes<T>(tm, tk, tn) ||
            tk / spada::mma::Op<T>::BK > 32))
    return (int)cudaErrorInvalidValue;
  if (spada::mma::takes<T>(tm, tk, tn)) {
    *block = kBlockMma;
    const size_t smem = kStages * spada::mma::Stage<T>::kBytes;
    const int err = spada::allow_smem(tile_spgemm_mma<T>, smem);
    if (err) return err;
    tile_spgemm_mma<T><<<spada::mma::grid(n_c, tm, tn), spada::mma::kThreads,
                         smem, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
    return (int)cudaGetLastError();
  }
  if (spada::thin::takes<T>(tm, tk, tn)) {
    *block = kBlockThin;
    return spada::thin::with_rows(tm, [&](auto rows) {
      constexpr int BM = decltype(rows)::value;
      using S = spada::thin::Shape<T, BM>;
      const size_t smem = spada::thin::kStages<T> * S::kBytes;
      auto run = [&](auto kernel) {
        const int err = spada::allow_smem(kernel, smem);
        if (err) return err;
        kernel<<<spada::thin::grid(n_c, tm, tn), S::kThreads, smem, s>>>(
            a, b, ai, bi, tp, m, c, tm, tk, tn);
        return (int)cudaGetLastError();
      };
      return m ? run(tile_spgemm_thin<T, BM, true>)
               : run(tile_spgemm_thin<T, BM, false>);
    });
  }
  if (tm % kWide == 0 && tn % kWide == 0 && tk % kWideBK == 0) {
    *block = kBlockWide;
    const dim3 grid(n_c, tm / kWide, tn / kWide);
    tile_spgemm_wide<T><<<grid, 256, 0, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
    return (int)cudaGetLastError();
  }
  // the wrapper checks these; a direct caller gets an error, not a bad launch
  if (tk % kNarrowBK != 0 || tn % kNarrowBN != 0)
    return (int)cudaErrorInvalidValue;
  const int bm = tm < 64 ? tm : 64;
  if (tm % bm != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_c, tm / bm, tn / kNarrowBN);
  *block = kBlockNarrow;
  switch (bm) {
    case 8:
      tile_spgemm_narrow<T, 8, 1>
          <<<grid, 8 * 16, 0, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
      break;
    case 16:
      tile_spgemm_narrow<T, 16, 1>
          <<<grid, 16 * 16, 0, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
      break;
    case 32:
      tile_spgemm_narrow<T, 32, 2>
          <<<grid, 16 * 16, 0, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
      break;
    case 64:
      tile_spgemm_narrow<T, 64, 4>
          <<<grid, 16 * 16, 0, s>>>(a, b, ai, bi, tp, c, tm, tk, tn);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wg block over the schedule `units` (int32 [n_units][2], tile_wgmma.cuh's
// block) of n_a A tiles and n_b B tiles, f32.
int launch_wg(const void* a_tiles, const void* b_tiles, const void* a_tid,
              const void* b_tid, const void* tile_ptr, const void* units,
              int n_units, void* c_tiles, int n_a, int n_b, int tm, int tk,
              int tn, int* block, void* stream) {
  namespace W = spada::wg;
  if (n_units <= 0 || n_a <= 0 || n_b <= 0 || !W::takes(tm, tk, tn) ||
      (long long)n_a * tm >= (1LL << 31) || (long long)n_b * tk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  *block = kBlockWg;
  CUtensorMap a_map, b_map;
  int err = W::tensor_map(&a_map, static_cast<const float*>(a_tiles), tk,
                          (uint64_t)n_a * tm, W::kRows);
  if (err) return err;
  err = W::tensor_map(&b_map, static_cast<const float*>(b_tiles), tn,
                      (uint64_t)n_b * tk, W::kBK);
  if (err) return err;
  err = spada::allow_smem(tile_spgemm_wg, W::kSmem);
  if (err) return err;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int n_work = n_units * (tn / W::kBN);
  tile_spgemm_wg<<<n_work < sms ? n_work : sms, W::kThreads, W::kSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<const int32_t*>(a_tid),
      static_cast<const int32_t*>(b_tid), static_cast<const int32_t*>(tile_ptr),
      static_cast<const int32_t*>(units), n_work, static_cast<float*>(c_tiles),
      tm, tk, tn);
  return (int)cudaGetLastError();
}

// The blocks of `kernel` (threads, dynamic shared memory smem) that stay
// resident on one SM at once.
template <class Kernel>
int resident(Kernel* kernel, int threads, size_t smem, int* per_sm) {
  const int err = spada::allow_smem(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                           threads, smem);
}

// The block launch() runs (tm, tk, tn) on, and how many of it stay resident
// on one SM: the card's tile model (plan/card_model.py) prices a grid of
// more blocks than the SMs hold at once wave by wave.  Launches nothing.
template <typename T>
int occupancy(int tm, int tk, int tn, int* block, int* per_sm) {
  if (tm <= 0 || tk <= 0 || tn <= 0) return (int)cudaErrorInvalidValue;
  if (spada::mma::takes<T>(tm, tk, tn)) {
    *block = kBlockMma;
    return resident(tile_spgemm_mma<T>, spada::mma::kThreads,
                    kStages * spada::mma::Stage<T>::kBytes, per_sm);
  }
  if (spada::thin::takes<T>(tm, tk, tn)) {
    *block = kBlockThin;
    return spada::thin::with_rows(tm, [&](auto rows) {
      constexpr int BM = decltype(rows)::value;
      using S = spada::thin::Shape<T, BM>;
      return resident(tile_spgemm_thin<T, BM, false>, S::kThreads,
                      spada::thin::kStages<T> * S::kBytes, per_sm);
    });
  }
  if (tm % kWide == 0 && tn % kWide == 0 && tk % kWideBK == 0) {
    *block = kBlockWide;
    return resident(tile_spgemm_wide<T>, 256, 0, per_sm);
  }
  if (tk % kNarrowBK != 0 || tn % kNarrowBN != 0)
    return (int)cudaErrorInvalidValue;
  const int bm = tm < 64 ? tm : 64;
  if (tm % bm != 0) return (int)cudaErrorInvalidValue;
  *block = kBlockNarrow;
  switch (bm) {
    case 8:
      return resident(tile_spgemm_narrow<T, 8, 1>, 8 * 16, 0, per_sm);
    case 16:
      return resident(tile_spgemm_narrow<T, 16, 1>, 16 * 16, 0, per_sm);
    case 32:
      return resident(tile_spgemm_narrow<T, 32, 2>, 16 * 16, 0, per_sm);
    case 64:
      return resident(tile_spgemm_narrow<T, 64, 4>, 16 * 16, 0, per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tile_spgemm_f32(const void* a_tiles, const void* b_tiles,
                               const void* a_tid, const void* b_tid,
                               const void* tile_ptr, const void* mask,
                               void* c_tiles, int n_c, int tm, int tk, int tn,
                               int* block, void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, mask,
                       c_tiles, n_c, tm, tk, tn, block, stream);
}

extern "C" int tile_spgemm_bf16(const void* a_tiles, const void* b_tiles,
                                const void* a_tid, const void* b_tid,
                                const void* tile_ptr, const void* mask,
                                void* c_tiles, int n_c, int tm, int tk,
                                int tn, int* block, void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                               mask, c_tiles, n_c, tm, tk, tn, block, stream);
}

// launch_wg(): f32 tiles on the wg block over a schedule of 64-row pieces
extern "C" int tile_spgemm_wg_f32(const void* a_tiles, const void* b_tiles,
                                  const void* a_tid, const void* b_tid,
                                  const void* tile_ptr, const void* units,
                                  int n_units, void* c_tiles, int n_a,
                                  int n_b, int tm, int tk, int tn, int* block,
                                  void* stream) {
  return launch_wg(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, units, n_units,
                   c_tiles, n_a, n_b, tm, tk, tn, block, stream);
}

// occupancy() of (tm, tk, tn) f32 (bf16 0) or bf16 (bf16 1) tiles.
extern "C" int tile_spgemm_occupancy(int bf16, int tm, int tk, int tn,
                                     int* block, int* per_sm) {
  return bf16 ? occupancy<__nv_bfloat16>(tm, tk, tn, block, per_sm)
              : occupancy<float>(tm, tk, tn, block, per_sm);
}

// The name of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* spada_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
