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
// bf16 tiles are widened to f32 as they are read; every product and sum is
// an f32 FMA (no TF32).
//
// What bounds it on an H100.  As tile_spgemm: 2*tm*tk*tn FLOPs per item
// against (tm*tk + tk*tn) tile elements read, so tall panels are bound by
// the FP32 FMA rate and short ones (tm = 8..32) by reading B tiles.  What
// the TPU kernel fought was the latency of each item's tile copy: it kept
// an nbuf-deep ring of async DMAs running across C-tile boundaries, so the
// copies never drained at the end of a run.
//
// Design.  The same idea on an SM: grid = (group, row block, column block);
// a block walks every item of its group as one flat sequence of BK-deep
// k-slices of its A rows and B columns, and cp.async keeps nbuf - 1 slices
// in flight in a ring of nbuf shared-memory stages (tile_pipe.cuh).  The
// ring runs on across C-tile boundaries inside the group.  The accumulator
// lives in registers; when the next item belongs to another C tile, the
// block writes its piece of the finished tile (and zeros for the group's
// empty tiles before it) and starts again from zero.  So each C tile is
// written once, by exactly one block per piece, and never read; the padded
// n_groups*ogroup output of the TPU kernel does not exist.  Block shapes are
// tile_spgemm's (128 x 128 or BM x 64); no tensor cores yet.
//
// Launch: tile_stream_f32 / tile_stream_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_pipe.cuh"

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

template <typename T>
int launch(const void* a_tiles, const void* b_tiles, const void* a_tid,
           const void* b_tid, const void* o_tid, const void* item_ptr,
           void* c_tiles, int n_c, int ogroup, int tm, int tk, int tn,
           int nbuf, void* stream) {
  if (n_c <= 0 || ogroup <= 0 || nbuf < 2) return (int)cudaErrorInvalidValue;
  const int n_groups = (n_c + ogroup - 1) / ogroup;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
