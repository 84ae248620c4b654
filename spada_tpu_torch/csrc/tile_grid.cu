// tile_grid: the item-order-free tile engine of spada_tpu_torch, written for
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
// The TPU kernel ran one item per step of a sequential grid, carried the
// output block in VMEM across the steps of a run and zeroed it at the run's
// first item.  A GPU grid has no order, so here blocks add their sums into
// C with f32 atomics, and the order of the adds differs from run to run:
// the result is held to a tolerance, not bitwise.
//
// Three paths, tried in this order (ops.engine.tile_block mirrors the rule):
//   mma  (tm, tn multiples of 128, tk of 32 f32 / 64 bf16): one block per
//        (item, 128 x 128 piece), tile_mma.cuh's block over the one-item
//        range [w, w + 1): its 4-stage ring, 3xTF32 or bf16 mma, each
//        k-slice folded into the f32 accumulator, and its Add epilogue (one
//        red.global.add.v2.f32 per two adjacent values).  A wide item is
//        long enough (tk / BK k-slices of a 128-row piece) to fill the ring.
//   thin (tm in {8, 16, 32} or a multiple of 64 that mma does not take, tn
//        a multiple of 128, tk of 32 / 64): one block per (chunk, BM x 128
//        piece), a chunk being up to G consecutive items of the worklist,
//        tile_mma_thin.cuh's block over the range [lo, min(lo + G, W)) with
//        o_of(w) = o_tid[w], its Add epilogue on the thin fragments.
//   SIMT (the other shapes: tn = 64, tk not of the k-slice): tile_pipe.cuh's
//        block shapes, a two-stage ring, bf16 widened to f32 and every
//        product an f32 FMA, one scalar atomicAdd per value, one block per
//        (item, piece).
//
// What bounds the thin path on an H100.  Per item 2*tm*tk*tn products and
// a B tile of tk x tn read whole (from L2 where neighbouring row panels
// share it), so at tm <= 64 the B bytes set the time, as in tile_spgemm's
// thin block; then the adds: BM x 128 f32 values of read-modify-write per
// run of a chunk.  One block per item (the SIMT path's form) pays those adds
// once per item, tm * tn * 4 bytes, about 0.81 GB over the whole banded
// sweep at every tm (W * tm is constant there), twice the bytes the bound
// counts; and each item's ring starts empty, so the copies of its first
// slices are waited on bare.
//
// What the chunk does about both.  thin::piece merges the consecutive items
// of a range that share an output into one run: it keeps the run's sum in
// registers, puts it once (here: adds it) and restarts from zero when o
// changes.  On an o-sorted worklist a chunk of G items therefore adds once
// per run it touches, not once per item, and its ring runs on across the
// chunk's items, as in tile_spgemm_thin.  A run cut by a chunk boundary is
// added by both chunks' blocks; a shuffled worklist degrades to one add per
// item and stays right.  Larger G also means fewer blocks, so G is chosen
// on the host (ops.engine.grid_chunk): 1, one block per item, while the
// items' pieces do not fill the card several times over (cari's 130 items),
// else the largest power of two up to a cap that leaves every SM a few
// waves of blocks.  The cap and the fill were set by timing G = 1-16 and
// the rule's choice (tools/sweep_thin --grid-chunks 1,2,4,8,16, and with
// --pair cari) on the banded 32768^2 pair at T = 128 (W = 198,464 / 99,232
// / 49,616 / 24,808 items at tm 8 / 16 / 32 / 64) and on cari at the same
// heights; ms on an H100 80GB HBM3 at 700 W:
//
//   pair   tiles tm    G=1    G=2    G=4    G=8   G=16  rule: ms  tile_spgemm
//   banded f32    8  3.143  2.983  2.936  2.896  2.887  16: 2.887   2.825
//   banded bf16   8  1.453  1.386  1.359  1.351  1.354  16: 1.353   1.301
//   banded f32   16  1.771  1.603  1.589  1.547  1.543  16: 1.556   1.478
//   banded bf16  16  0.947  0.837  0.786  0.774  0.777  16: 0.776   0.713
//   banded f32   32  1.382  1.297  1.265  1.250  1.257  16: 1.267   1.147
//   banded bf16  32  0.701  0.590  0.536  0.512  0.506  16: 0.504   0.422
//   banded f32   64  1.279  1.178  1.127  1.130  1.119  16: 1.120   1.010
//   banded bf16  64  0.636  0.479  0.424  0.403  0.415  16: 0.414   0.300
//   cari   f32    8  0.022  0.024  0.027  0.031  0.054   1: 0.022   0.027
//   cari   bf16   8  0.015  0.015  0.015  0.016  0.024   1: 0.015   0.014
//   cari   f32   16  0.017  0.017  0.020  0.032  0.056   1: 0.017   0.023
//   cari   bf16  16  0.013  0.012  0.012  0.016  0.025   1: 0.013   0.012
//   cari   f32   32  0.016  0.017  0.025  0.042  0.076   1: 0.016   0.029
//   cari   bf16  32  0.012  0.011  0.013  0.018  0.029   1: 0.012   0.012
//   cari   f32   64  0.016  0.022  0.034  0.059  0.108   1: 0.017   0.041
//   cari   bf16  64  0.013  0.013  0.016  0.023  0.037   1: 0.013   0.015
//
// (cari: 862 / 439 / 233 / 130 items at tm 8 / 16 / 32 / 64; the rule's G
// at the card's 132 SMs, a cap of 16 and a fill of 8 blocks per SM.)  On
// the banded pair G = 1 costs 8-58% more than G = 8-16, most on bf16 tm
// 32-64, whose items are shortest; 8 and 16 differ by at most 3% either
// way.  On cari a grid of one block per item is already below the card's
// width, and every G above 2 is slower.  What is left against
// tile_spgemm's store (0.05-0.12 ms at every tm, 1.02-1.38x) is the
// contract's zeroed C: the wrapper's memset of all C (215 MB on the sweep
// at every tm) and the read half of every add's read-modify-write, which
// L2 cannot hold; it weighs most where tile_spgemm is fastest (bf16 tm 64).
//
// Launch: tile_grid_f32 / tile_grid_bf16 (plain C interface for ctypes)
// take G as `chunk` (the thin path's items per block; the other paths run
// one item per block), enqueue one kernel on the given stream, write the
// block it runs on to *block (tile_pipe.cuh's kBlock*) and return
// cudaGetLastError().

#include "tile_mma.cuh"
#include "tile_mma_thin.cuh"

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

// ---- thin: BM x 128 of a chunk of items per block, tensor cores -----------
template <typename T, int BM>
__global__ void __launch_bounds__(32 * thin::kWarpsN)
    tile_grid_thin(const T* __restrict__ a_tiles,
                   const T* __restrict__ b_tiles,
                   const int32_t* __restrict__ a_tid,
                   const int32_t* __restrict__ b_tid,
                   const int32_t* __restrict__ o_tid,
                   float* __restrict__ c_tiles, int n_items, int chunk,
                   int tm, int tk, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Place p = thin::place<BM>(tm, tn);
  const int lo = p.unit * chunk, hi = min(lo + chunk, n_items);
  const int first = o_tid[lo];  // nothing to zero: C starts zeroed
  thin::piece<T, BM, thin::kStages<T>, false>(
      a_tiles, b_tiles, a_tid, b_tid, [o_tid](int w) { return o_tid[w]; },
      lo, hi, first, first, mma::Add{c_tiles, (size_t)tm * tn, tn}, tm, tk,
      tn, p.row0, p.col0, smem);
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
           int tm, int tk, int tn, int chunk, int* block, void* stream) {
  if (n_items <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(a_tiles);
  const T* b = static_cast<const T*>(b_tiles);
  const int32_t* ai = static_cast<const int32_t*>(a_tid);
  const int32_t* bi = static_cast<const int32_t*>(b_tid);
  const int32_t* oi = static_cast<const int32_t*>(o_tid);
  float* c = static_cast<float*>(c_tiles);
  if (mma::takes<T>(tm, tk, tn)) {
    *block = kBlockMma;
    const size_t smem = mma::kDeepest * mma::Stage<T>::kBytes;
    const int err = allow_smem(tile_grid_mma<T>, smem);
    if (err) return err;
    tile_grid_mma<T><<<mma::grid(n_items, tm, tn), mma::kThreads, smem, s>>>(
        a, b, ai, bi, oi, c, tm, tk, tn);
    return (int)cudaGetLastError();
  }
  if (thin::takes<T>(tm, tk, tn)) {
    *block = kBlockThin;
    const int n_chunks = (n_items + chunk - 1) / chunk;
    return thin::with_rows(tm, [&](auto rows) {
      constexpr int BM = decltype(rows)::value;
      using S = thin::Shape<T, BM>;
      const size_t smem = thin::kStages<T> * S::kBytes;
      const int err = allow_smem(tile_grid_thin<T, BM>, smem);
      if (err) return err;
      tile_grid_thin<T, BM>
          <<<thin::grid(n_chunks, tm, tn), S::kThreads, smem, s>>>(
              a, b, ai, bi, oi, c, n_items, chunk, tm, tk, tn);
      return (int)cudaGetLastError();
    });
  }
  return with_geo(tm, tk, tn, [&](auto geo) {
    using G = decltype(geo);
    *block = simt_block<G>();
    const size_t smem =
        (size_t)kStages * Stage<T, G, false>::kElems * sizeof(T);
    const int err = allow_smem(tile_grid_kernel<T, G>, smem);
    if (err) return err;
    const dim3 grid(n_items, tm / G::BM, tn / G::BN);
    tile_grid_kernel<T, G><<<grid, G::NT, smem, s>>>(a, b, ai, bi, oi, c, tm,
                                                     tk, tn);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tile_grid_f32(const void* a_tiles, const void* b_tiles,
                             const void* a_tid, const void* b_tid,
                             const void* o_tid, void* c_tiles, int n_items,
                             int tm, int tk, int tn, int chunk, int* block,
                             void* stream) {
  return launch<float>(a_tiles, b_tiles, a_tid, b_tid, o_tid, c_tiles,
                       n_items, tm, tk, tn, chunk, block, stream);
}

extern "C" int tile_grid_bf16(const void* a_tiles, const void* b_tiles,
                              const void* a_tid, const void* b_tid,
                              const void* o_tid, void* c_tiles, int n_items,
                              int tm, int tk, int tn, int chunk, int* block,
                              void* stream) {
  return launch<__nv_bfloat16>(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                               c_tiles, n_items, tm, tk, tn, chunk, block,
                               stream);
}
