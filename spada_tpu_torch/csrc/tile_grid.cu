// tile_grid: the item-per-step tile engine of spada_tpu_torch, written for
// Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/engine.py : _make_spgemm_kernel / _run_pallas
// (the Pallas kernel behind run_worklist_pallas, engine="pallas_grid" and
// SpadaConfig.use_pallas).
//
// What it computes.  The C that tile_spgemm computes from the same worklist:
// C[o_tid[w]] += A[a_tid[w]] (tm x tk) @ B[b_tid[w]] (tk x tn) for every item
// w, in f32, in any item order.  C must be zero on entry (the wrapper
// allocates it zeroed), so a C tile with no items stays an exact zero tile.
//
// What bounds it on an H100.  Per item the same 2*tm*tk*tn FLOPs and tile
// reads as tile_spgemm, plus tm*tn f32 atomic adds into C: 1/256 byte of
// read-modify-write per FLOP at tk = 512, into a C that need not fit in L2.
// The TPU kernel ran one item per step of a sequential grid, carried the
// output block in VMEM across the steps of a run and zeroed it at the run's
// first item; its data-dependent output index forced a flush per step.
//
// Design.  A GPU grid has no order, so "one item per grid step" becomes
// item-parallel: one block per (item w, piece of its C tile).  A block
// computes its piece of A[a_tid[w]] @ B[b_tid[w]] in registers and adds it
// into C[o_tid[w]] with f32 atomics.  The zeroed allocation does what the
// first-item flag did, once for all tiles.  The order of the adds differs
// from run to run, so the result is held to a tolerance, not bitwise.  Two
// paths:
//   mma  (tm, tn multiples of 128, tk of 32 f32 / 64 bf16): the tensor-core
//        block of tile_mma.cuh over the one-item range [w, w + 1): tk / BK
//        k-slices (16 for f32 tiles at tk = 512, 8 for bf16) through its
//        4-stage ring, 3xTF32 or bf16 mma, each k-slice's sums folded into
//        the f32 accumulator; its epilogue (Add) adds each two adjacent
//        values with one red.global.add.v2.f32.  Blocks launch with an
//        item's pieces adjacent.
//   SIMT (the other shapes, the short panels tm in {8..64} among them):
//        tile_spgemm's block shapes over the k pipeline of tile_pipe.cuh, a
//        two-stage ring, bf16 widened to f32 and every product an f32 FMA,
//        one scalar atomicAdd per value.
//
// Launch: tile_grid_f32 / tile_grid_bf16 (plain C interface for ctypes)
// enqueue one kernel on the given stream and return cudaGetLastError().

#include "tile_mma.cuh"

namespace {

using namespace spada;

constexpr int kStages = 2;  // SIMT ring

// ---- mma: 128 x 128 of one item's product per block, tensor cores ---------
template <typename T>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_grid_mma(const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
                  const int32_t* __restrict__ a_tid,
                  const int32_t* __restrict__ b_tid,
                  const int32_t* __restrict__ o_tid,
                  float* __restrict__ c_tiles, int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Place p = mma::place(tm, tn);
  const int w = p.unit, o = o_tid[w];
  mma::piece<T, mma::kDeepest, false>(
      a_tiles, b_tiles, a_tid, b_tid, [o](int) { return o; }, w, w + 1, o,
      o + 1, mma::Add{c_tiles, (size_t)tm * tn, tn}, tm, tk, tn, p.row0,
      p.col0, smem);
}

// ---- SIMT: tile_pipe.cuh's block shapes, f32 FMAs -------------------------
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
  if (mma::takes<T>(tm, tk, tn)) {
    const size_t smem = mma::kDeepest * mma::Stage<T>::kBytes;
    const int err = allow_smem(tile_grid_mma<T>, smem);
    if (err) return err;
    tile_grid_mma<T><<<mma::grid(n_items, tm, tn), mma::kThreads, smem, s>>>(
        static_cast<const T*>(a_tiles), static_cast<const T*>(b_tiles),
        static_cast<const int32_t*>(a_tid), static_cast<const int32_t*>(b_tid),
        static_cast<const int32_t*>(o_tid), static_cast<float*>(c_tiles), tm,
        tk, tn);
    return (int)cudaGetLastError();
  }
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
