// esc_stream_mul / esc_stream_red: the element (ESC) class kernels of
// spada_tpu_torch, written for Hopper (sm_90a).
//
// Replaces: spada_tpu/ops/element_stream.py : _mul_kernel (L = 1) and
// _red_kernel (L >= 2), the Pallas kernels built by _class_runner.
//
// What they compute.  The host ESC plan expands every scalar product of
// C = A @ B, sorts the products by output element and buckets the output
// chunks by product count L (a power of two).  Per class the device gets two
// operand arrays in the stream layout (ops/element_stream.py):
//   L = 1:  a, b are [rows, 1024]; out[i] = a[i] * b[i]          (mul)
//   L >= 2: a, b are [L, n_pad];   out[j] = sum_l a[l,j] * b[l,j] (red)
// Padding slots hold 0 * 0, so no masking is needed.
//
// What bounds them on an H100.  Pure streaming: two f32 reads and one
// (mul) or 1/L (red) f32 write per product slot, one FLOP or two; far below
// the ridge, so HBM bandwidth (3.35 TB/s) bounds the large classes.  The
// small classes of a plan (a few thousand chunks) are bound by the launch.
//
// Design.  Both kernels move 16 bytes per thread per access (float4), with
// neighbouring threads on neighbouring addresses: the layout already puts
// chunks on the fast axis, so the transposed [L, n_pad] red layout is
// coalesced across chunks as it stands.  mul gives each thread one float4
// (on the card this matched or beat grid-stride and unrolled variants).
// red gives each thread four chunk columns and a slice of the L rows:
// when a class has few chunks, a block splits its rows over up to 32
// slices (blockDim.y) so that enough loads are in flight, and combines the
// slices' partial sums in shared memory in a fixed order, writing each
// chunk once.  Products are rounded to f32 before they are added
// (__fmul_rn, no FMA contraction), as the plain version does, and every sum
// is compensated (Kahan): a plain sequential f32 sum over L = 512 rows
// drifted 2e-6 of max|out| from PyTorch's own reduction on the card; the
// compensated one stays within about one rounding of the exact sum.  The
// extra adds are free: the kernel waits on memory.
//
// Block size.  esc_stream_mul_blocked / esc_stream_red_blocked take the work
// of one CUDA block as an argument (elements for mul, chunk columns for red),
// so that spada_tpu_torch/tools/probe_pallas_stream.py can sweep the block
// sizes the TPU probe swept (tools/probe_pallas_stream.py: mul_kernel, and
// red_kernel at L = 2); their threads stride through their block's share.
// The main path's entry points launch the kernels above and take no block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMulThreads = 128;
constexpr int kRedThreads = 256;       // blockDim.x * blockDim.y
constexpr int kRedMaxSlices = 32;
constexpr long long kRedTargetThreads = 1 << 20;

__device__ __forceinline__ void mul4(const float4* __restrict__ a,
                                     const float4* __restrict__ b,
                                     float4* __restrict__ out, long long i) {
  const float4 x = __ldg(a + i);
  const float4 y = __ldg(b + i);
  out[i] = make_float4(x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w);
}

// The default launch: one float4 per thread.
__global__ void esc_stream_mul_kernel(const float4* __restrict__ a,
                                      const float4* __restrict__ b,
                                      float4* __restrict__ out, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) mul4(a, b, out, i);
}

// A block of per_block float4s, its threads striding through them.
__global__ void esc_stream_mul_blocked_kernel(const float4* __restrict__ a,
                                              const float4* __restrict__ b,
                                              float4* __restrict__ out,
                                              long long n4,
                                              long long per_block) {
  const long long base = (long long)blockIdx.x * per_block;
  const long long end = min(base + per_block, n4);
  for (long long i = base + threadIdx.x; i < end; i += blockDim.x)
    mul4(a, b, out, i);
}

// Kahan step: s + c carries the running sum, v is the next term.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// The chunk columns j (< end) of one pass of a block: blockDim.x columns
// (float4 each) x blockDim.y row slices.
__device__ __forceinline__ void red_pass(const float4* __restrict__ a,
                                         const float4* __restrict__ b,
                                         float4* __restrict__ out, int L,
                                         long long n4, long long j,
                                         long long end, float4* part) {
  const int bx = blockDim.x, by = blockDim.y;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 c = s;
  if (j < end) {
#pragma unroll 4
    for (int l = threadIdx.y; l < L; l += by) {
      const float4 x = __ldg(a + (long long)l * n4 + j);
      const float4 y = __ldg(b + (long long)l * n4 + j);
      kahan_add(s.x, c.x, __fmul_rn(x.x, y.x));
      kahan_add(s.y, c.y, __fmul_rn(x.y, y.y));
      kahan_add(s.z, c.z, __fmul_rn(x.z, y.z));
      kahan_add(s.w, c.w, __fmul_rn(x.w, y.w));
    }
  }
  part[threadIdx.y * bx + threadIdx.x] =
      make_float4(__fsub_rn(s.x, c.x), __fsub_rn(s.y, c.y),
                  __fsub_rn(s.z, c.z), __fsub_rn(s.w, c.w));
  __syncthreads();
  if (threadIdx.y == 0 && j < end) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 tc = t;
    for (int y = 0; y < by; ++y) {
      const float4 p = part[y * bx + threadIdx.x];
      kahan_add(t.x, tc.x, p.x);
      kahan_add(t.y, tc.y, p.y);
      kahan_add(t.z, tc.z, p.z);
      kahan_add(t.w, tc.w, p.w);
    }
    out[j] = t;
  }
}

// The default launch: one pass of blockDim.x chunk columns per block.
__global__ void esc_stream_red_kernel(const float4* __restrict__ a,
                                      const float4* __restrict__ b,
                                      float4* __restrict__ out, int L,
                                      long long n4) {
  __shared__ float4 part[kRedThreads];
  red_pass(a, b, out, L, n4, (long long)blockIdx.x * blockDim.x + threadIdx.x,
           n4, part);
}

// A block of per_block chunk columns, in passes of blockDim.x.
__global__ void esc_stream_red_blocked_kernel(const float4* __restrict__ a,
                                              const float4* __restrict__ b,
                                              float4* __restrict__ out, int L,
                                              long long n4,
                                              long long per_block) {
  __shared__ float4 part[kRedThreads];
  const long long base = (long long)blockIdx.x * per_block;
  const long long end = min(base + per_block, n4);
  for (long long j0 = base; j0 < end; j0 += blockDim.x) {
    red_pass(a, b, out, L, n4, j0 + threadIdx.x, end, part);
    __syncthreads();  // part is rewritten by the next pass
  }
}

}  // namespace

// n: element count, a multiple of 4; every pointer 16-byte aligned.
extern "C" int esc_stream_mul(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long blocks = (n4 + kMulThreads - 1) / kMulThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_mul_kernel<<<(unsigned)blocks, kMulThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), n4);
  return (int)cudaGetLastError();
}

// The threads of a red block: chunk columns x row slices.  The rows are
// split while the class has too few chunks to fill the card.
static dim3 red_threads(int L, long long n4) {
  int slices = 1;
  while (slices < kRedMaxSlices && 2 * slices <= L &&
         n4 * slices < kRedTargetThreads)
    slices *= 2;
  return dim3(kRedThreads / slices, slices);
}

// a, b: [L, n_pad] row-major; out: [n_pad]; n_pad a multiple of 4; every
// pointer 16-byte aligned.
extern "C" int esc_stream_red(const void* a, const void* b, void* out, int L,
                              long long n_pad, void* stream) {
  if (L <= 0 || n_pad <= 0 || n_pad % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n_pad / 4;
  const dim3 threads = red_threads(L, n4);
  const long long blocks = (n4 + threads.x - 1) / threads.x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_red_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), L, n4);
  return (int)cudaGetLastError();
}

// The probe's launches (spada_tpu_torch/tools/probe_pallas_stream.py): as
// above, with block elements (mul) or chunk columns (red) per CUDA block, a
// positive multiple of 4.
extern "C" int esc_stream_mul_blocked(const void* a, const void* b, void* out,
                                      long long n, long long block,
                                      void* stream) {
  if (n <= 0 || n % 4 != 0 || block <= 0 || block % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4, per_block = block / 4;
  const long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_mul_blocked_kernel<<<(unsigned)blocks, kMulThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), n4, per_block);
  return (int)cudaGetLastError();
}

extern "C" int esc_stream_red_blocked(const void* a, const void* b, void* out,
                                      int L, long long n_pad, long long block,
                                      void* stream) {
  if (L <= 0 || n_pad <= 0 || n_pad % 4 != 0 || block <= 0 || block % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n4 = n_pad / 4, per_block = block / 4;
  const long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_red_blocked_kernel<<<(unsigned)blocks, red_threads(L, n4), 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), L, n4, per_block);
  return (int)cudaGetLastError();
}
