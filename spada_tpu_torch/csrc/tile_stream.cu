// tile_stream: the streaming tile engine of spada_tpu_torch, written for
// Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_streaming_kernel_grouped /
// _run_pallas_streaming_grouped (the Pallas kernel behind
// run_worklist_streaming, engine="streaming").
//
// What it computes.  The C that tile_spgemm computes from the same o-sorted
// worklist, walked by groups of ogroup consecutive C tiles: group g owns the
// items item_ptr[g] .. item_ptr[g+1] and the C tiles g*ogroup .. +ogroup-1;
// C[o_tid[w]] is the f32 sum of A[a_tid[w]] (tm x tk) @ B[b_tid[w]]
// (tk x tn) over its items.  A C tile with no items is an exact zero tile.
// f32 tiles on the tensor-core path run 3xTF32 (f32-level error), bf16
// tiles bf16 mma with f32 sums; the SIMT paths widen bf16 to f32 FMAs.
//
// What bounds it on an H100.  As tile_spgemm: 2*tm*tk*tn FLOPs per item
// against (tm*tk + tk*tn) tile elements read, so tall panels are bound by
// the arithmetic and short ones (tm = 8..32) by reading B tiles.  What the
// TPU kernel fought was the latency of each item's tile copy: it kept an
// nbuf-deep ring of async DMAs running across C-tile boundaries, so the
// copies never drained at the end of a run.
//
// Design.  The same idea on an SM: one block per (group, row block, column
// block); a block walks every item of its group as one flat sequence of
// k-slices of its A rows and B columns, and cp.async keeps the next slices in flight in
// a ring of shared-memory stages that runs on across C-tile boundaries.  The
// accumulator lives in registers; when the next item belongs to another C
// tile, the block writes its piece of the finished tile (and zeros for the
// group's empty tiles before it) and starts again from zero.  So each C
// tile is written once, by exactly one block per piece, and never read; the
// padded n_groups*ogroup output of the TPU kernel does not exist.  With
// ogroup = 1, item_ptr is tile_spgemm's tile_ptr, and the wide shapes run
// the same block as tile_spgemm:
//   mma    (tm, tn multiples of 128, tk of 32 f32 / 64 bf16): tile_mma.cuh
//          over the range item_ptr[g] .. item_ptr[g+1], C tiles g*ogroup ..
//          min((g+1)*ogroup, n_c), its ring min(nbuf, 4) stages deep (a
//          compile-time depth: 2, 3 or 4).
//   the rest (tile_pipe.cuh, f32 FMAs): 128 x 128 for tm, tn multiples of
//          128 and tk of 8, BM x 64 for short panels, an nbuf-stage ring.
//
// Launch: tile_stream_f32 / tile_stream_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_mma.cuh"

namespace {

using namespace spada;

template <typename T, class G>
__global__ void __launch_bounds__(G::NT)
    tile_stream_kernel(const T* __restrict__ a_tiles,
                       const T* __restrict__ b_tiles,
                       const int32_t* __restrict__ a_tid,
                       const int32_t* __restrict__ b_tid,
                       const int32_t* __restrict__ o_tid,
                       const int32_t* __restrict__ item_ptr,
                       float* __restrict__ c_tiles, int n_c, int ogroup,
                       int tm, int tk, int tn, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int row0 = blockIdx.y * G::BM;
  const int col0 = blockIdx.z * G::BN;
  const int tid = threadIdx.x;
  const int tx = tid % G::TX, ty = tid / G::TX;
  const int lo = item_ptr[g], hi = item_ptr[g + 1];
  const int k_steps = tk / G::BK;
  const int end = min((g + 1) * ogroup, n_c);
  int next_c = g * ogroup;  // the group's first C tile not yet written
  float acc[G::RM][G::RN] = {};
  auto tile = [&](int c) { return c_tiles + (size_t)c * tm * tn; };

  pipeline<T, G, false>(
      smem, nbuf, (hi - lo) * k_steps, tx, ty, acc,
      [&](int s, T* As, T* Bs) {
        const int w = lo + s / k_steps;
        issue_slice<T, G, false>(As, Bs, a_tiles + (size_t)a_tid[w] * tm * tk,
                                 b_tiles + (size_t)b_tid[w] * tk * tn, tm, tk,
                                 tn, row0, col0, (s % k_steps) * G::BK, tid);
      },
      [&](int s) {
        if (s % k_steps != k_steps - 1) return;  // not an item's last slice
        const int w = lo + s / k_steps;
        const int o = o_tid[w];
        if (w + 1 < hi && o_tid[w + 1] == o) return;  // the run goes on
        for (; next_c < o; ++next_c)
          store_piece<G, true>(tile(next_c), tn, row0, col0, tx, ty, acc);
        store_piece<G>(tile(o), tn, row0, col0, tx, ty, acc);
        next_c = o + 1;
#pragma unroll
        for (int i = 0; i < G::RM; ++i)
#pragma unroll
          for (int j = 0; j < G::RN; ++j) acc[i][j] = 0.0f;
      });
  for (; next_c < end; ++next_c)
    store_piece<G, true>(tile(next_c), tn, row0, col0, tx, ty, acc);
}

template <typename T, int STAGES>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_stream_mma(const T* __restrict__ a_tiles,
                    const T* __restrict__ b_tiles,
                    const int32_t* __restrict__ a_tid,
                    const int32_t* __restrict__ b_tid,
                    const int32_t* __restrict__ o_tid,
                    const int32_t* __restrict__ item_ptr,
                    float* __restrict__ c_tiles, int n_c, int ogroup, int tm,
                    int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Place p = mma::place(tm, tn);
  const int g = p.unit;
  mma::piece<T, STAGES, false>(
      a_tiles, b_tiles, a_tid, b_tid, [o_tid](int w) { return o_tid[w]; },
      item_ptr[g], item_ptr[g + 1], g * ogroup, min((g + 1) * ogroup, n_c),
      mma::Store<float>{c_tiles, (size_t)tm * tn, tn}, tm, tk, tn, p.row0,
      p.col0, smem);
}

template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* o_tid, const void* item_ptr,
           void* c_tiles, int n_c, int ogroup, int tm, int tk, int tn,
           int nbuf, void* stream) {
  if (n_c <= 0 || ogroup <= 0 || nbuf < 2) return (int)cudaErrorInvalidValue;
  const int n_groups = (n_c + ogroup - 1) / ogroup;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma::takes<T>(tm, tk, tn)) {
    return mma::with_depth(nbuf, [&](auto depth) {
      constexpr int STAGES = decltype(depth)::value;
      const size_t smem = STAGES * mma::Stage<T>::kBytes;
      const int err = allow_smem(tile_stream_mma<T, STAGES>, smem);
      if (err) return err;
      tile_stream_mma<T, STAGES>
          <<<mma::grid(n_groups, tm, tn), mma::kThreads, smem, s>>>(
              static_cast<const T*>(a_tiles), static_cast<const T*>(b_tiles),
              static_cast<const int32_t*>(a_tid),
              static_cast<const int32_t*>(b_tid),
              static_cast<const int32_t*>(o_tid),
              static_cast<const int32_t*>(item_ptr),
              static_cast<float*>(c_tiles), n_c, ogroup, tm, tk, tn);
      return (int)cudaGetLastError();
    });
  }
  return with_geo(tm, tk, tn, [&](auto geo) {
    using G = decltype(geo);
    const size_t smem =
        (size_t)nbuf * Stage<T, G, false>::kElems * sizeof(T);
    const int err = allow_smem(tile_stream_kernel<T, G>, smem);
    if (err) return err;
    const dim3 grid(n_groups, tm / G::BM, tn / G::BN);
    tile_stream_kernel<T, G><<<grid, G::NT, smem, s>>>(
        static_cast<const T*>(a_tiles), static_cast<const T*>(b_tiles),
        static_cast<const int32_t*>(a_tid), static_cast<const int32_t*>(b_tid),
        static_cast<const int32_t*>(o_tid),
        static_cast<const int32_t*>(item_ptr), static_cast<float*>(c_tiles),
        n_c, ogroup, tm, tk, tn, nbuf);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tile_stream_f32(const void* a_tiles, const void* b_tiles,
                               const void* a_tid, const void* b_tid,
                               const void* o_tid, const void* item_ptr,
                               void* c_tiles, int n_c, int ogroup, int tm,
                               int tk, int tn, int nbuf, void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, o_tid, item_ptr,
                       c_tiles, n_c, ogroup, tm, tk, tn, nbuf, stream);
}

extern "C" int tile_stream_bf16(const void* a_tiles, const void* b_tiles,
                                const void* a_tid, const void* b_tid,
                                const void* o_tid, const void* item_ptr,
                                void* c_tiles, int n_c, int ogroup, int tm,
                                int tk, int tn, int nbuf, void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                               item_ptr, c_tiles, n_c, ogroup, tm, tk, tn,
                               nbuf, stream);
}
