// tile_panel: the panel-dot tile engine of spada_tpu_torch, written for
// Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_panel_kernel / _run_pallas_panel
// (the Pallas kernel behind run_worklist_panel, engine="panel").
//
// What it computes.  The C that tile_spgemm computes from the same o-sorted
// worklist: C tile c's run tile_ptr[c] .. tile_ptr[c+1] is ONE contraction of
// depth L*tk, the k-concatenation of its A tiles against the k-concatenation
// of its B tiles.  A comes k-transposed, a_tiles_t [nA, tk, tm]; B is
// [nB, tk, tn].  The sum is f32 and is written as f32, or rounded once to
// bf16 (round to nearest even).  An empty run writes an exact zero tile.
// bf16 tiles are widened to f32 as they are read; no TF32.
//
// What bounds it on an H100.  As tile_spgemm: the FP32 FMA rate for tall
// panels, reading B tiles for short ones.  The TPU kernel was built against
// the per-item read-modify-write of a VMEM accumulator: it placed a run's
// tiles in adjacent cache slots so that one MXU dot over the whole panel
// accumulated internally.  It stored A k-transposed so that the run's A
// tiles concatenate along k as rows.
//
// Design.  On an SM the accumulator of a block's piece lives in registers
// for the whole contraction, so "one dot per run" is a k loop over the
// concatenated panel with no boundary between items and no max_panel limit:
// grid = (C tile, row block, column block), and the block walks the run as
// one flat sequence of BK-deep k-slices.  The k-transposed A is what makes
// the staging a straight copy here too: a row of a_tiles_t[id] is
// contiguous along m, so each k-slice goes by cp.async into the k-major
// shared-memory layout the FMA loop reads (four rows per float4), with no
// transpose on the way.  A ring of kStages stages keeps the copies ahead of
// the FMAs (tile_pipe.cuh).  The epilogue writes the piece once, as f32 or
// as bf16.  The slot plans, the VMEM fit and the item split of the TPU
// kernel have no counterpart.  Block shapes are tile_spgemm's; no tensor
// cores yet.
//
// Launch: tile_panel_f32 / tile_panel_bf16 (the A/B tile type; plain C
// interface for ctypes) enqueue one kernel on the given stream and return
// cudaGetLastError().  out_bf16 != 0 selects the bf16 output.

#include "tile_pipe.cuh"

namespace {

using namespace spada;

constexpr int kStages = 3;

template <typename T, typename OutT, class G>
__global__ void __launch_bounds__(G::NT)
    tile_panel_kernel(const T* __restrict__ a_tiles_t,
                      const T* __restrict__ b_tiles,
                      const int32_t* __restrict__ a_tid,
                      const int32_t* __restrict__ b_tid,
                      const int32_t* __restrict__ tile_ptr,
                      OutT* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * G::BM;
  const int col0 = blockIdx.z * G::BN;
  const int tid = threadIdx.x;
  const int tx = tid % G::TX, ty = tid / G::TX;
  const int lo = tile_ptr[c];
  const int k_steps = tk / G::BK;
  float acc[G::RM][G::RN] = {};

  pipeline<T, G, true>(
      smem, kStages, (tile_ptr[c + 1] - lo) * k_steps, tx, ty, acc,
      [&](int s, T* As, T* Bs) {
        const int w = lo + s / k_steps;
        issue_slice<T, G, true>(As, Bs, a_tiles_t + (size_t)a_tid[w] * tk * tm,
                                b_tiles + (size_t)b_tid[w] * tk * tn, tm, tk,
                                tn, row0, col0, (s % k_steps) * G::BK, tid);
      },
      [](int) {});
  store_piece<G>(c_tiles + (size_t)c * tm * tn, tn, row0, col0, tx, ty, acc);
}

template <typename T, typename OutT>
int launch(const void* a_tiles_t, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* tile_ptr, void* c_tiles, int n_c,
           int tm, int tk, int tn, void* stream) {
  if (n_c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_geo(tm, tk, tn, [&](auto geo) {
    using G = decltype(geo);
    const size_t smem =
        (size_t)kStages * Stage<T, G, true>::kElems * sizeof(T);
    const int err = allow_smem(tile_panel_kernel<T, OutT, G>, smem);
    if (err) return err;
    const dim3 grid(n_c, tm / G::BM, tn / G::BN);
    tile_panel_kernel<T, OutT, G><<<grid, G::NT, smem, s>>>(
        static_cast<const T*>(a_tiles_t), static_cast<const T*>(b_tiles),
        static_cast<const int32_t*>(a_tid), static_cast<const int32_t*>(b_tid),
        static_cast<const int32_t*>(tile_ptr), static_cast<OutT*>(c_tiles), tm,
        tk, tn);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tile_panel_f32(const void* a_tiles_t, const void* b_tiles,
                              const void* a_tid, const void* b_tid,
                              const void* tile_ptr, void* c_tiles, int n_c,
                              int tm, int tk, int tn, int out_bf16,
                              void* stream) {
  return out_bf16
             ? launch<float, __nv_bfloat16>(a_tiles_t, b_tiles, a_tid, b_tid,
                                            tile_ptr, c_tiles, n_c, tm, tk,
                                            tn, stream)
             : launch<float, float>(a_tiles_t, b_tiles, a_tid, b_tid,
                                    tile_ptr, c_tiles, n_c, tm, tk, tn,
                                    stream);
}

extern "C" int tile_panel_bf16(const void* a_tiles_t, const void* b_tiles,
                               const void* a_tid, const void* b_tid,
                               const void* tile_ptr, void* c_tiles, int n_c,
                               int tm, int tk, int tn, int out_bf16,
                               void* stream) {
  return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                        a_tiles_t, b_tiles, a_tid, b_tid, tile_ptr, c_tiles,
                        n_c, tm, tk, tn, stream)
                  : launch<__nv_bfloat16, float>(a_tiles_t, b_tiles, a_tid,
                                                 b_tid, tile_ptr, c_tiles, n_c,
                                                 tm, tk, tn, stream);
}
