// The wide block of the tile kernels (sm_90a): one 128 x 128 piece of a C
// tile per block of 256 threads, 8 x 8 per thread (two 4 x 4 quadrants 64
// apart, so the shared-memory reads are conflict-free float4s), BK = 8
// k-slices staged through two shared-memory stages (the next slice is
// fetched into registers while the current one is multiplied), the
// accumulator in registers over the whole run, C written once.
//
// tile_probe.cu runs it with one component stripped per mode (the table is
// in tile_probe.cu); tile_spgemm.cu runs it as it is (mode kFull) for wide
// tiles whose tk the tensor-core block (tile_mma.cuh) does not take.

#pragma once

#include "tile_pipe.cuh"

namespace spada {
namespace wide {

constexpr int kP = 128;  // piece edge
constexpr int kBK = 8;

using namespace mode;  // kFull .. kFlat

// global loads of A and B tiles
template <int M>
constexpr bool kLoads = M == kFull || M == kStatSlot || M == kOneSlot ||
                        M == kNoAcc || M == kNoCopy || M == kFlat;
// worklist ids read in the FMA loop when nothing is loaded
template <int M>
constexpr bool kIdsOnly = M == kNoDma || M == kDots;
// the accumulator is kept but C is not written
template <int M>
constexpr bool kSink = M == kNoCopy || M == kDots || M == kStat;

__device__ __forceinline__ void store_piece(float* out, int tn, int row0,
                                            int col0,
                                            const float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// One 128 x 128 piece (row0, col0) of C tile c.  n_c, a_slots and b_slots
// are read only by the modes that need them.
template <typename T, int M>
__device__ __forceinline__ void piece(
    const T* __restrict__ a_tiles, const T* __restrict__ b_tiles,
    const int32_t* __restrict__ a_tid, const int32_t* __restrict__ b_tid,
    const int32_t* __restrict__ tile_ptr, float* __restrict__ c_tiles, int c,
    int row0, int col0, int n_c, int tm, int tk, int tn, int a_slots,
    int b_slots, float (&As)[2][kBK][kP], float (&Bs)[2][kBK][kP]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float* out = c_tiles + (size_t)c * tm * tn;
  float acc[8][8];
  zero_acc(acc);
  if constexpr (M == kEmpty0) {
    store_piece(out, tn, row0, col0, acc);
    return;
  }
  const int lo = tile_ptr[c];
  const int n_items = tile_ptr[c + 1] - lo;
  const int k_steps = tk / kBK;
  const int steps = n_items * k_steps;  // (item, k slice)
  if constexpr (M == kEmpty) {
    for (int s = 0; s < steps; ++s) asm volatile("");
    store_piece(out, tn, row0, col0, acc);
    return;
  }
  if constexpr (M == kLoop) {
    int x = 0;
    for (int w = lo; w < lo + n_items; ++w) x += a_tid[w] ^ b_tid[w];
    store_piece(out, tn, row0, col0, acc);
    if (blockIdx.x == (unsigned)n_c) out[0] = (float)x;  // never true
    return;
  }

  // each thread stages four A elements (row a_r, k a_k..+3) and four B
  // elements (k b_k, columns b_c..+3) of every slice
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_c = (tid & 31) * 4;
  int fix_a = 0, fix_b = 0;
  if constexpr (M == kStatSlot) {
    fix_a = c % a_slots;
    fix_b = c % b_slots;
  }

  float4 ra, rb;
  auto fetch = [&](int s) {
    const int w = lo + s / k_steps;
    const int k0 = (s % k_steps) * kBK;
    int ia, ib;
    if constexpr (M == kStatSlot || M == kOneSlot || M == kNoAcc) {
      ia = fix_a;
      ib = fix_b;
    } else {
      ia = a_tid[w];
      ib = b_tid[w];
    }
    ra = load4(a_tiles + (size_t)ia * tm * tk + (size_t)(row0 + a_r) * tk +
               k0 + a_k);
    rb = load4(b_tiles + (size_t)ib * tk * tn + (size_t)(k0 + b_k) * tn +
               col0 + b_c);
  };
  auto stash = [&](int buf) {
    As[buf][a_k + 0][a_r] = ra.x;
    As[buf][a_k + 1][a_r] = ra.y;
    As[buf][a_k + 2][a_r] = ra.z;
    As[buf][a_k + 3][a_r] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_c]) = rb;
  };

  if constexpr (kLoads<M>) {
    if (steps > 0) {
      fetch(0);
      stash(0);
    }
  } else {
    for (int i = tid; i < 2 * kBK * kP; i += 256) {
      (&As[0][0][0])[i] = 0.0f;
      (&Bs[0][0][0])[i] = 0.0f;
    }
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    int buf = s & 1;
    if constexpr (kLoads<M>) {
      if (s + 1 < steps) fetch(s + 1);
    } else if constexpr (kIdsOnly<M>) {
      const int w = lo + s / k_steps;
      buf = (s ^ a_tid[w] ^ b_tid[w]) & 1;
    }
    if constexpr (M == kNoAcc) {
      if (s % k_steps == 0) zero_acc(acc);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
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
    if constexpr (kLoads<M>) {
      if (s + 1 < steps) stash(buf ^ 1);
    }
    __syncthreads();
  }

  if constexpr (kSink<M>) {
    if (blockIdx.x == (unsigned)n_c) store_piece(out, tn, row0, col0, acc);
  } else {
    store_piece(out, tn, row0, col0, acc);
  }
}

}  // namespace wide
}  // namespace spada
