// tile_spgemm: the tile engine of spada_tpu_torch, written for Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_cached_kernel / _run_pallas_cached
// (the Pallas kernel behind run_worklist_cached).
//
// What it computes.  For every C tile c, the o-sorted worklist holds one run
// of items tile_ptr[c] .. tile_ptr[c+1]; item w contributes
// A[a_tid[w]] (tm x tk) @ B[b_tid[w]] (tk x tn).  C[c] is the f32 sum of its
// run, and an empty run gives an exact zero tile (the TPU kernel's lo == hi
// branch).  A and B tiles are f32 or bf16; bf16 is widened to f32 on load, so
// every product and every sum is an f32 FMA (no TF32, no bf16 rounding of
// products).
//
// What bounds it on an H100.  Per item the kernel does 2*tm*tk*tn FLOPs and
// moves (tm*tk + tk*tn) tile elements.  For the tile edges the planner picks
// (tk = tn = T in 128..512) and tm = T this is T/4 = 32-128 FLOP per byte of
// f32, above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, about 20), so
// tall panels are bound by FP32 FMA throughput; short panels (tm = 8..32)
// drop to a few FLOP per byte and are bound by reading B tiles.
//
// Design.  The TPU kernel kept whole tiles in VMEM slot caches planned on
// the host (Belady) and added each item's product into a VMEM accumulator.
// An SM has 227 KB of shared memory, less than one 512 x 512 f32 C tile, so
// here a C tile is split across blocks: grid = (C tile, row block, column
// block).  A block walks its C tile's whole run, streaming BK-deep slices of
// the A rows and B columns it needs through shared memory, and keeps its
// part of the accumulator in registers for the whole run, so C is written
// exactly once and never read.  Tile reuse across C tiles is left to the
// 50 MB L2 instead of a host slot plan.  Two block shapes:
//   wide   (tm and tn multiples of 128, tk of 8): 128 x 128 per block, 8 x 8
//          per thread (two 4 x 4 quadrants 64 apart, so the shared-memory
//          reads are conflict-free float4s), BK = 8, two shared-memory
//          stages: the next slice is fetched into registers while the
//          current one is multiplied.  This is the planner's usual shape.
//   narrow (tm in {8, 16, 32} or a multiple of 64, tn a multiple of 64, tk
//          of 16): BM = min(tm, 64) rows x 64 columns per block, RM x 4 per
//          thread, BK = 16, one stage.
// No tensor cores and no TMA yet: this is the simple, right first version.
//
// Launch: tile_spgemm_f32 / tile_spgemm_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_pipe.cuh"

namespace {

using spada::load4;
using spada::to_f32;

// ---- wide: 128 x 128 of one C tile per block, 256 threads -----------------
constexpr int kWide = 128;
constexpr int kWideBK = 8;

template <typename T>
__global__ void __launch_bounds__(256)
    tile_spgemm_wide(const T* __restrict__ a_tiles,
                     const T* __restrict__ b_tiles,
                     const int32_t* __restrict__ a_tid,
                     const int32_t* __restrict__ b_tid,
                     const int32_t* __restrict__ tile_ptr,
                     float* __restrict__ c_tiles, int tm, int tk, int tn) {
  constexpr int BK = kWideBK;
  __shared__ __align__(16) float As[2][BK][kWide];  // k-major A slice
  __shared__ __align__(16) float Bs[2][BK][kWide];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kWide;
  const int col0 = blockIdx.z * kWide;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lo = tile_ptr[c];
  const int k_steps = tk / BK;
  const int steps = (tile_ptr[c + 1] - lo) * k_steps;  // (item, k slice)
  // each thread stages four A elements (row a_r, k a_k..+3) and four B
  // elements (k b_k, columns b_c..+3) of every slice
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_c = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra, rb;
  auto fetch = [&](int s) {
    const int w = lo + s / k_steps;
    const int k0 = (s % k_steps) * BK;
    ra = load4(a_tiles + (size_t)a_tid[w] * tm * tk +
               (size_t)(row0 + a_r) * tk + k0 + a_k);
    rb = load4(b_tiles + (size_t)b_tid[w] * tk * tn +
               (size_t)(k0 + b_k) * tn + col0 + b_c);
  };
  auto stash = [&](int buf) {
    As[buf][a_k + 0][a_r] = ra.x;
    As[buf][a_k + 1][a_r] = ra.y;
    As[buf][a_k + 2][a_r] = ra.z;
    As[buf][a_k + 3][a_r] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_c]) = rb;
  };

  if (steps > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch(s + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = c_tiles + (size_t)c * tm * tn;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    float* p = out + (size_t)r * tn + col0;
    *reinterpret_cast<float4*>(p + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
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

template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* tile_ptr, void* c_tiles, int n_c,
           int tm, int tk, int tn, void* stream) {
  if (n_c <= 0 || tm <= 0 || tk <= 0 || tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(a_tiles);
  const T* b = static_cast<const T*>(b_tiles);
  const int32_t* ai = static_cast<const int32_t*>(a_tid);
  const int32_t* bi = static_cast<const int32_t*>(b_tid);
  const int32_t* tp = static_cast<const int32_t*>(tile_ptr);
  float* c = static_cast<float*>(c_tiles);
  if (tm % kWide == 0 && tn % kWide == 0 && tk % kWideBK == 0) {
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

}  // namespace

extern "C" int tile_spgemm_f32(const void* a_tiles, const void* b_tiles,
                               const void* a_tid, const void* b_tid,
                               const void* tile_ptr, void* c_tiles, int n_c,
                               int tm, int tk, int tn, void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, n_c,
                       tm, tk, tn, stream);
}

extern "C" int tile_spgemm_bf16(const void* a_tiles, const void* b_tiles,
                                const void* a_tid, const void* b_tid,
                                const void* tile_ptr, void* c_tiles, int n_c,
                                int tm, int tk, int tn, void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                               c_tiles, n_c, tm, tk, tn, stream);
}

// The name of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* spada_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
