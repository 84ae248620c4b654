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
// Design.  All kernels move 16 bytes per thread per access (float4), with
// neighbouring threads on neighbouring addresses: the layout already puts
// chunks on the fast axis, so the transposed [L, n_pad] red layout is
// coalesced across chunks as it stands.  mul gives each thread one float4
// (on the card this matched or beat grid-stride and unrolled variants).
//
// red.  A block of 256 threads is 256 / slices chunk columns (a float4
// each) by `slices` row slices; slice y owns rows y, y + slices, ...  The
// rows are split (up to 32 slices, chosen on the host from L and the class
// size, ops/element_stream.py : red_slices) while a class has too few
// chunks to put enough loads in flight.  A thread walks its R = L / slices
// rows in groups of G = min(R, 4): the 2G loads of a group are issued before
// its first add, and row i of the thread goes to compensated sum i % G, so
// a thread carries G independent Kahan chains instead of one serial chain
// over all its rows.  The chains, and then the slices' partial sums (through
// shared memory; skipped when slices = 1), are merged in a fixed order, so a
// column's bits depend on L, slices and G only: never on the block size, the
// grid, or the run.  A merge adds both parts of a partial sum (the sum and
// its compensation), so a column is rounded to one float once, at its store:
// with every partial sum rounded before the merge, the L = 512 class of the
// localized power-law pair came out 1.7e-7 of max|out| from the f64 sum, and
// PyTorch's own reduction is 8.5e-7 from it there (H100 80GB HBM3), which
// together missed the 1e-6 gate against the plain version.  Products are rounded to f32
// before they are added (__fmul_rn, no FMA contraction), as the plain
// version does, and every sum is compensated: a plain sequential f32 sum over
// L = 512 rows drifted 2e-6 of max|out| from PyTorch's own reduction on the
// card; the compensated one stays within about one rounding of the exact
// sum.  The extra adds are free: the kernel waits on memory.
//
// One launch per multiply.  A plan has one class per power of two up to its
// cap (10 at cap 512), most of them a few MB: launched one by one, each is a
// ramp and a tail with little between, and the host pays one enqueue per
// class.  esc_stream_group takes a table of up to kMaxClasses class
// descriptors by value in the kernel's parameters; each block finds its class
// from blockIdx.x (the classes' first blocks ascend) and runs the mul body or
// the red body on its share of it.  The host orders the classes in the grid
// (a plan's order, by ascending L: the big classes of short blocks lead and
// the small ones fill in as they drain) and passes each class's slices; the
// bodies are the per-class kernels', so every class's output is bitwise
// what its own launch gives.
//
// Block size.  esc_stream_mul_blocked / esc_stream_red_blocked take the work
// of one CUDA block as an argument (elements for mul, chunk columns for red),
// so that spada_tpu_torch/tools/probe_pallas_stream.py can sweep the block
// sizes the TPU probe swept (tools/probe_pallas_stream.py: mul_kernel, and
// red_kernel at L = 2); their threads stride through their block's share.
// esc_stream_red takes slices and G as arguments for the same tool's sweep;
// the wrapper of the main path passes the host's choice and G = 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMulThreads = 128;
constexpr int kThreads = 256;       // red and grouped blocks
constexpr int kRedMaxSlices = 32;
constexpr int kRedMaxGroup = 4;     // deepest row group compiled
constexpr int kGroupMul = 2;        // float4s per thread of a grouped mul block
constexpr int kBlocksPerSM = 3;     // register budget: 85 a thread
constexpr int kMaxClasses = 16;     // classes of one grouped launch

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

__device__ __forceinline__ void kahan_add4(float4& s, float4& c, float4 v) {
  kahan_add(s.x, c.x, v.x);
  kahan_add(s.y, c.y, v.y);
  kahan_add(s.z, c.z, v.z);
  kahan_add(s.w, c.w, v.w);
}

// A compensated sum of four columns: its value is s - c.
struct Sum4 {
  float4 s, c;
};

__device__ __forceinline__ Sum4 zero_sum() {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return {z, z};
}

// t += x, both parts of x, so that no partial sum is rounded to one float
// on the way
__device__ __forceinline__ void kahan_merge(Sum4& t, const Sum4& x) {
  kahan_add4(t.s, t.c, x.s);
  kahan_add4(t.s, t.c, make_float4(-x.c.x, -x.c.y, -x.c.z, -x.c.w));
}

// the one rounding of a sum
__device__ __forceinline__ float4 kahan_value(const Sum4& t) {
  return make_float4(__fsub_rn(t.s.x, t.c.x), __fsub_rn(t.s.y, t.c.y),
                     __fsub_rn(t.s.z, t.c.z), __fsub_rn(t.s.w, t.c.w));
}

// The sum over rows l0, l0 + stride, ... (R of them, a multiple of G) of
// a[l][j] * b[l][j]: G loads of each operand in flight, G independent
// compensated sums, combined in the order 0 .. G - 1.
template <int G>
__device__ __forceinline__ Sum4 red_rows(const float4* __restrict__ a,
                                           const float4* __restrict__ b,
                                           long long n4, long long j, int l0,
                                           int stride, int R) {
  Sum4 sum[G];
#pragma unroll
  for (int u = 0; u < G; ++u) sum[u] = zero_sum();
  const long long step = (long long)stride * n4;
  const float4* pa = a + (long long)l0 * n4 + j;
  const float4* pb = b + (long long)l0 * n4 + j;
  for (int i = 0; i < R; i += G) {
    float4 x[G], y[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      x[u] = __ldg(pa + u * step);
      y[u] = __ldg(pb + u * step);
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      kahan_add4(sum[u].s, sum[u].c,
                 make_float4(__fmul_rn(x[u].x, y[u].x),
                             __fmul_rn(x[u].y, y[u].y),
                             __fmul_rn(x[u].z, y[u].z),
                             __fmul_rn(x[u].w, y[u].w)));
    pa += G * step;
    pb += G * step;
  }
#pragma unroll
  for (int u = 1; u < G; ++u) kahan_merge(sum[0], sum[u]);
  return sum[0];
}

// One pass of a red block: chunk column j (< end, or the thread only joins
// the barrier) of kThreads / slices columns, by `slices` row slices.  part
// holds 2 * kThreads float4s (the two parts of every thread's sum) and is
// free again when the pass returns.
__device__ __forceinline__ void red_pass(const float4* __restrict__ a,
                                         const float4* __restrict__ b,
                                         float4* __restrict__ out, int L,
                                         long long n4, long long j,
                                         long long end, int slices, int group,
                                         float4* part) {
  const int ty = threadIdx.x / (kThreads / slices);
  const int R = L / slices;
  Sum4 v = zero_sum();
  if (j < end) {
    switch (min(group, R)) {
      case 1: v = red_rows<1>(a, b, n4, j, ty, slices, R); break;
      case 2: v = red_rows<2>(a, b, n4, j, ty, slices, R); break;
      default: v = red_rows<kRedMaxGroup>(a, b, n4, j, ty, slices, R); break;
    }
  }
  if (slices == 1) {  // the whole block: no combine, no barrier
    if (j < end) out[j] = kahan_value(v);
    return;
  }
  part[threadIdx.x] = v.s;
  part[kThreads + threadIdx.x] = v.c;
  __syncthreads();
  if (ty == 0 && j < end) {
    const int bx = kThreads / slices;
    for (int y = 1; y < slices; ++y) {
      const int i = y * bx + threadIdx.x;
      kahan_merge(v, {part[i], part[kThreads + i]});
    }
    out[j] = kahan_value(v);
  }
  __syncthreads();  // part is rewritten by the next pass
}

// The default launch: one pass per block.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    esc_stream_red_kernel(const float4* __restrict__ a,
                          const float4* __restrict__ b,
                          float4* __restrict__ out, int L, long long n4,
                          int slices, int group) {
  __shared__ float4 part[2 * kThreads];
  const int bx = kThreads / slices;
  red_pass(a, b, out, L, n4, (long long)blockIdx.x * bx + threadIdx.x % bx, n4,
           slices, group, part);
}

// A block of per_block chunk columns, in passes of kThreads / slices.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    esc_stream_red_blocked_kernel(const float4* __restrict__ a,
                                  const float4* __restrict__ b,
                                  float4* __restrict__ out, int L,
                                  long long n4, int slices, int group,
                                  long long per_block) {
  __shared__ float4 part[2 * kThreads];
  const int bx = kThreads / slices;
  const long long base = (long long)blockIdx.x * per_block;
  const long long end = min(base + per_block, n4);
  for (long long j0 = base; j0 < end; j0 += bx)
    red_pass(a, b, out, L, n4, j0 + threadIdx.x % bx, end, slices, group, part);
}

// One class of a grouped launch.  L = 1: a, b, out hold n4 float4s (mul).
// L >= 2: a, b are [L][n4], out [n4] (red).  The class's blocks are
// first_block .. the next class's first_block - 1.
struct GroupClass {
  const float4* a;
  const float4* b;
  float4* out;
  long long n4;
  int L;
  int slices;
  unsigned first_block;
  int group;
};

struct GroupTable {
  GroupClass c[kMaxClasses];
  int n;
};

// Every class of one multiply: a block runs the mul body on kGroupMul *
// kThreads float4s of an L = 1 class (a thread's loads all issued before its
// first store: the red body's registers leave three blocks an SM, so a
// thread keeps more in flight than esc_stream_mul_kernel's), or one red pass
// of an L >= 2 class.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    esc_stream_group_kernel(const __grid_constant__ GroupTable table) {
  __shared__ float4 part[2 * kThreads];
  int k = 0;
  while (k + 1 < table.n && blockIdx.x >= table.c[k + 1].first_block) ++k;
  const GroupClass& cl = table.c[k];
  const long long blk = blockIdx.x - cl.first_block;
  if (cl.L == 1) {
    const float4* __restrict__ a = cl.a;
    const float4* __restrict__ b = cl.b;
    float4* __restrict__ out = cl.out;
#pragma unroll
    for (int u = 0; u < kGroupMul; ++u) {
      const long long i = (blk * kGroupMul + u) * kThreads + threadIdx.x;
      if (i < cl.n4) mul4(a, b, out, i);
    }
    return;
  }
  const int bx = kThreads / cl.slices;
  red_pass(cl.a, cl.b, cl.out, cl.L, cl.n4, blk * bx + threadIdx.x % bx, cl.n4,
           cl.slices, cl.group, part);
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// What the red kernels take: rows that split evenly over the slices, and a
// row group (the smaller of `group` and a slice's rows) that is a power of
// two and divides a slice's rows.
bool red_shape_ok(int L, long long n_pad, int slices, int group) {
  if (L <= 0 || n_pad <= 0 || n_pad % 4 != 0 || !pow2(slices) ||
      slices > kRedMaxSlices || L % slices != 0 || group < 1 ||
      group > kRedMaxGroup)
    return false;
  const int R = L / slices, g = group < R ? group : R;
  return pow2(g) && R % g == 0;
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

// a, b: [L, n_pad] row-major; out: [n_pad]; n_pad a multiple of 4; every
// pointer 16-byte aligned.  slices: row slices of a block, a power of two
// that divides L, at most 32; group: rows a thread loads before it adds, a
// power of two up to 4 (a thread with fewer rows takes them all at once).
extern "C" int esc_stream_red(const void* a, const void* b, void* out, int L,
                              long long n_pad, int slices, int group,
                              void* stream) {
  if (!red_shape_ok(L, n_pad, slices, group))
    return (int)cudaErrorInvalidValue;
  const long long n4 = n_pad / 4;
  const int bx = kThreads / slices;
  const long long blocks = (n4 + bx - 1) / bx;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_red_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), L, n4, slices, group);
  return (int)cudaGetLastError();
}

// Every class of a multiply in one launch.  table: n rows of 8 int64s, in
// grid order: a, b, out (device addresses, 16-byte aligned), L, n4 (float4s
// per row: elements / 4 for L = 1, n_pad / 4 otherwise), slices, group,
// first_block (row 0's is 0, ascending).  n_blocks: the grid.
extern "C" int esc_stream_group(const long long* table, int n,
                                long long n_blocks, void* stream) {
  if (n <= 0 || n > kMaxClasses || n_blocks <= 0 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  GroupTable t;
  t.n = n;
  long long next = 0;  // the first block of the class in hand
  for (int k = 0; k < n; ++k) {
    const long long* r = table + 8 * k;
    GroupClass& c = t.c[k];
    c.a = reinterpret_cast<const float4*>(r[0]);
    c.b = reinterpret_cast<const float4*>(r[1]);
    c.out = reinterpret_cast<float4*>(r[2]);
    c.L = (int)r[3];
    c.n4 = r[4];
    c.slices = (int)r[5];
    c.group = (int)r[6];
    c.first_block = (unsigned)r[7];
    if (r[7] != next || c.n4 <= 0 || !c.a || !c.b || !c.out)
      return (int)cudaErrorInvalidValue;
    if (c.L != 1 && !red_shape_ok(c.L, 4 * c.n4, c.slices, c.group))
      return (int)cudaErrorInvalidValue;
    const int per = c.L == 1 ? kGroupMul * kThreads : kThreads / c.slices;
    next += (c.n4 + per - 1) / per;
  }
  if (next != n_blocks) return (int)cudaErrorInvalidValue;
  esc_stream_group_kernel<<<(unsigned)n_blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t);
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
                                      int L, long long n_pad, int slices,
                                      int group, long long block,
                                      void* stream) {
  if (!red_shape_ok(L, n_pad, slices, group) || block <= 0 || block % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n4 = n_pad / 4, per_block = block / 4;
  const long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  esc_stream_red_blocked_kernel<<<(unsigned)blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), L, n4, slices, group, per_block);
  return (int)cudaGetLastError();
}
