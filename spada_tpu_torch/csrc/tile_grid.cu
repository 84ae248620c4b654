// tile_grid: the item-per-step tile engine of spada_tpu_torch, written for
// Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_spgemm_kernel / _run_pallas
// (the Pallas kernel behind run_worklist_pallas, engine="pallas_grid" and
// SpadaConfig.use_pallas).
//
// What it computes.  The C that tile_spgemm computes from the same worklist:
// C[o_tid[w]] += A[a_tid[w]] (tm x tk) @ B[b_tid[w]] (tk x tn) for every item
// w, in f32.  C must be zero on entry (the wrapper allocates it zeroed), so a
// C tile with no items stays an exact zero tile.  bf16 tiles are widened to
// f32 as they are read; every product is an f32 FMA (no TF32).
//
// What bounds it on an H100.  Per item the same 2*tm*tk*tn FLOPs and tile
// reads as tile_spgemm, plus tm*tn f32 atomic adds into C.  The TPU kernel
// ran one item per step of a sequential grid, carried the output block in
// VMEM across the steps of a run and zeroed it at the run's first item; its
// data-dependent output index forced a flush per step.
//
// Design.  A GPU grid has no order, so "one item per grid step" becomes
// item-parallel: grid = (item w, row block, column block).  A block computes
// its piece of A[a_tid[w]] @ B[b_tid[w]] in registers (a k loop of BK-deep
// slices through a two-stage cp.async ring, tile_pipe.cuh) and adds it into
// C[o_tid[w]] with f32 atomicAdd.  The zeroed allocation does what the
// first-item flag did, once for all tiles.  The order of the adds differs
// from run to run, so the result is held to a tolerance, not bitwise.  Any
// item order is right, k-major included.  Block shapes are tile_spgemm's;
// no tensor cores yet.
//
// Launch: tile_grid_f32 / tile_grid_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_pipe.cuh"

namespace {

using namespace spada;

constexpr int kStages = 2;

template <typename T, class G>
__global__ void __launch_bounds__(G::NT)
    tile_grid_kernel(const T* __restrict__ a_tiles,
                     const T* __restrict__ b_tiles,
                     const int32_t* __restrict__ a_tid,
                     const int32_t* __restrict__ b_tid,
                     const int32_t* __restrict__ o_tid,
                     float* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x;
  const int row0 = blockIdx.y * G::BM;
  const int col0 = blockIdx.z * G::BN;
  const int tid = threadIdx.x;
  const int tx = tid % G::TX, ty = tid / G::TX;
  const T* a = a_tiles + (size_t)a_tid[w] * tm * tk;
  const T* b = b_tiles + (size_t)b_tid[w] * tk * tn;
  float acc[G::RM][G::RN] = {};

  pipeline<T, G, false>(
      smem, kStages, tk / G::BK, tx, ty, acc,
      [&](int s, T* As, T* Bs) {
        issue_slice<T, G, false>(As, Bs, a, b, tm, tk, tn, row0, col0,
                                 s * G::BK, tid);
      },
      [](int) {});
  float* out = c_tiles + (size_t)o_tid[w] * tm * tn;
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    float* p = out + (size_t)(row0 + G::row(ty, i)) * tn + col0;
#pragma unroll
    for (int j = 0; j < G::RN; ++j) atomicAdd(p + G::col(tx, j), acc[i][j]);
  }
}

template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* o_tid, void* c_tiles, int n_items,
           int tm, int tk, int tn, void* stream) {
  if (n_items <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_geo(tm, tk, tn, [&](auto geo) {
    using G = decltype(geo);
    const size_t smem =
        (size_t)kStages * Stage<T, G, false>::kElems * sizeof(T);
    const int err = allow_smem(tile_grid_kernel<T, G>, smem);
    if (err) return err;
    const dim3 grid(n_items, tm / G::BM, tn / G::BN);
    tile_grid_kernel<T, G><<<grid, G::NT, smem, s>>>(
        static_cast<const T*>(a_tiles), static_cast<const T*>(b_tiles),
        static_cast<const int32_t*>(a_tid), static_cast<const int32_t*>(b_tid),
        static_cast<const int32_t*>(o_tid), static_cast<float*>(c_tiles), tm,
        tk, tn);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tile_grid_f32(const void* a_tiles, const void* b_tiles,
                             const void* a_tid, const void* b_tid,
                             const void* o_tid, void* c_tiles, int n_items,
                             int tm, int tk, int tn, void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, o_tid, c_tiles,
                       n_items, tm, tk, tn, stream);
}

extern "C" int tile_grid_bf16(const void* a_tiles, const void* b_tiles,
                              const void* a_tid, const void* b_tid,
                              const void* o_tid, void* c_tiles, int n_items,
                              int tm, int tk, int tn, void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                               c_tiles, n_items, tm, tk, tn, stream);
}
