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
//
// What bounds it on an H100.  As tile_spgemm: the tensor cores' rate
// (3xTF32 for f32 tiles, bf16 mma for bf16) for tall panels, reading B tiles
// for short ones.  The TPU kernel was built against the per-item
// read-modify-write of a VMEM accumulator: it placed a run's tiles in
// adjacent cache slots so that one MXU dot over the whole panel accumulated
// internally.  It stored A k-transposed so that the run's A tiles
// concatenate along k as rows.
//
// Design.  On an SM the accumulator of a block's piece lives in registers
// for the whole contraction, so "one dot per run" is a k loop over the
// concatenated panel with no boundary between items and no max_panel limit:
// one block per piece of a C tile, walking the run as one flat sequence of
// BK-deep k-slices.  The k-transposed A is what makes the staging a straight
// copy here too: a row of a_tiles_t[id] is contiguous along m, so each
// k-slice goes by cp.async into a [k][m] shared-memory slice with no
// transpose on the way.  The epilogue writes the piece once, as f32 or as
// bf16.  The slot plans, the VMEM fit and the item split of the TPU kernel
// have no counterpart.  Two paths:
//   mma  (tm, tn multiples of 128, tk of 32 f32 / 64 bf16): the tensor-core
//        block of tile_mma.cuh with A k-transposed, a 4-stage ring: f32
//        tiles 3xTF32, bf16 tiles bf16 mma, each k-slice's tensor-core sums
//        added into the f32 accumulator: tile_spgemm's arithmetic on the
//        same values, so the f32 output is its C bit for bit.
//   SIMT (the other shapes: tk not such a multiple, or tm, tn not multiples
//        of 128, the short panels tm in {8..64} among them): the k pipeline
//        of tile_pipe.cuh, tile_spgemm's block shapes, a 3-stage ring, bf16
//        widened to f32 and every product an f32 FMA.
//
// Launch: tile_panel_f32 / tile_panel_bf16 (the A/B tile type; plain C
// interface for ctypes) enqueue one kernel on the given stream and return
// cudaGetLastError().  out_bf16 != 0 selects the bf16 output.

#include "tile_mma.cuh"

namespace {

using namespace spada;

constexpr int kStages = 3;  // SIMT ring

// ---- mma: 128 x 128 of one C tile per block, tensor cores -----------------
template <typename T, typename OutT>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_panel_mma(const T* __restrict__ a_tiles_t,
                   const T* __restrict__ b_tiles,
                   const int32_t* __restrict__ a_tid,
                   const int32_t* __restrict__ b_tid,
                   const int32_t* __restrict__ tile_ptr,
                   OutT* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Place p = mma::place(tm, tn);
  const int c = p.unit;
  mma::piece<T, mma::kDeepest, true>(
      a_tiles_t, b_tiles, a_tid, b_tid, [c](int) { return c; }, tile_ptr[c],
      tile_ptr[c + 1], c, c + 1,
      mma::Store<OutT>{c_tiles, (size_t)tm * tn, tn}, tm, tk, tn, p.row0,
      p.col0, smem);
}

// ---- SIMT: tile_pipe.cuh's block shapes, f32 FMAs -------------------------
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
  if (mma::takes<T>(tm, tk, tn)) {
    const size_t smem = mma::kDeepest * mma::Stage<T, true>::kBytes;
    const int err = allow_smem(tile_panel_mma<T, OutT>, smem);
    if (err) return err;
    tile_panel_mma<T, OutT>
        <<<mma::grid(n_c, tm, tn), mma::kThreads, smem, s>>>(
            static_cast<const T*>(a_tiles_t), static_cast<const T*>(b_tiles),
            static_cast<const int32_t*>(a_tid),
            static_cast<const int32_t*>(b_tid),
            static_cast<const int32_t*>(tile_ptr),
            static_cast<OutT*>(c_tiles), tm, tk, tn);
    return (int)cudaGetLastError();
  }
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
