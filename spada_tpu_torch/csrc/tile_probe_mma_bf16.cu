// tile_probe_mma_bf16: the probe modes of the tensor-core block on bf16 tiles
// (bf16 mma, f32 sums); the kernels and their table are in
// tile_probe_mma.cuh.  onepass and bigonly are modes of f32 tiles only.
//
// Launch: plain C interface for ctypes; enqueues one kernel on the given
// stream and returns cudaGetLastError().

#include "tile_probe_mma.cuh"

extern "C" int tile_probe_mma_bf16(const void* a_tiles, const void* b_tiles,
                                   const void* a_tid, const void* b_tid,
                                   const void* tile_ptr, void* c_tiles,
                                   int n_c, int tm, int tk, int tn,
                                   int a_slots, int b_slots, int mode,
                                   int stages, int a_t, void* stream) {
  return spada::probe::launch<__nv_bfloat16>(
      a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, n_c, tm, tk, tn,
      a_slots, b_slots, mode, stages, a_t, stream);
}
