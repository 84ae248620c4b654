// tile_probe_mma_f32: the probe modes of the tensor-core block on f32 tiles
// (3xTF32); the kernels and their table are in tile_probe_mma.cuh.
//
// Launch: plain C interface for ctypes; enqueues one kernel on the given
// stream and returns cudaGetLastError().

#include "tile_probe_mma.cuh"

extern "C" int tile_probe_mma_f32(const void* a_tiles, const void* b_tiles,
                                  const void* a_tid, const void* b_tid,
                                  const void* tile_ptr, void* c_tiles, int n_c,
                                  int tm, int tk, int tn, int a_slots,
                                  int b_slots, int mode, int stages, int a_t,
                                  void* stream) {
  return spada::probe::launch<float>(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                                     c_tiles, n_c, tm, tk, tn, a_slots,
                                     b_slots, mode, stages, a_t, stream);
}
