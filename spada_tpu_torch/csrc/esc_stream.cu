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
// The probe's launches, esc_stream_mul_blocked and esc_stream_red_blocked
// (spada_tpu_torch/tools/probe_pallas_stream.py; replace the Pallas kernels
// of tools/probe_pallas_stream.py: mul_kernel, and red_kernel at L = 2).
// The TPU probe asked whether an explicitly pipelined stream, Pallas's
// double-buffered block copies, beats the compiler's fused elementwise
// pass.  The card's counterpart of that pipeline is a ring of `stages`
// stages in shared memory filled by bulk asynchronous copies
// (cp.async.bulk, completing on an mbarrier), on a persistent grid:
// grid_factor blocks per SM (capped at the blocks that fit), the SM count
// read from the device.  Block x walks the stages x, x + gridDim.x, ...
// One producer thread (the block's last warp) fills a stage with one bulk
// copy per operand row piece: mul, `block` elements of a and of b; red,
// `block` chunk columns of each of the L rows of a and of b, n_pad floats
// apart in device memory and `block` apart in the stage.  The stage's
// "full" mbarrier expects exactly the stage's bytes; its "empty" mbarrier
// counts the 256 consumer threads out of it before the producer refills
// it.  The consumers read float4s from the stage and store 16 bytes a
// thread to device memory.  The arithmetic is the per-class kernels':
// mul4's product, and red_pass itself reading the stage (RingBody) instead
// of device memory (GlobalBody), at the main path's slices and G, so the
// results are bitwise esc_stream_mul's and esc_stream_red's.  `block` is
// the work of one stage, never of a block: the TPU's blocks (4-11.7 MB an
// operand) do not fit in the 227 KB of shared memory a block has, and the
// launch refuses a ring that does not fit.  A wait that lasts over about
// a second traps, so a stage whose copies never complete fails the launch
// instead of hanging the card.  Both are bound by HBM bytes, as the
// per-class kernels are.
//
// esc_stream_red takes slices and G as arguments for the same tool's sweep
// of block shapes; the wrapper of the main path passes the host's choice
// and G = 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMulThreads = 128;
constexpr int kThreads = 256;       // red and grouped blocks
constexpr int kRedMaxSlices = 32;
constexpr int kRedMaxGroup = 4;     // deepest row group compiled
constexpr int kGroupMul = 2;        // float4s per thread of a grouped mul block
constexpr int kBlocksPerSM = 3;     // register budget: 85 a thread
constexpr int kMaxClasses = 16;     // classes of one grouped launch
// the probe's pipeline: a producer warp beside kThreads consumers, the
// deepest ring, the most blocks per SM asked, the shared memory a block
// may have (sm_90), and the ring's header (its mbarriers) before the red
// combine's scratch and the stages
constexpr int kPipeThreads = kThreads + 32;
constexpr int kPipeMaxStages = 8;
constexpr int kPipeMaxGridFactor = 4;
constexpr long long kPipeSmemLimit = 232448;
constexpr int kPipeHeader = 2 * kPipeMaxStages * 8;
constexpr int kRedPartBytes = 2 * kThreads * 16;
constexpr long long kPipeHangCycles = 2000000000LL;

// Where a body reads its operands, and how its threads meet: device memory
// through the read-only path, the whole block at a barrier (the per-class
// and grouped kernels); or a stage of the probe's shared-memory ring, the
// consumer threads alone at named barrier 1 (the producer warp never joins).
struct GlobalBody {
  static __device__ __forceinline__ float4 load(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

struct RingBody {
  static __device__ __forceinline__ float4 load(const float4* p) {
    return *p;
  }
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  }
};

template <class Body = GlobalBody>
__device__ __forceinline__ void mul4(const float4* __restrict__ a,
                                     const float4* __restrict__ b,
                                     float4* __restrict__ out, long long i) {
  const float4 x = Body::load(a + i);
  const float4 y = Body::load(b + i);
  out[i] = make_float4(x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w);
}

// The default launch: one float4 per thread.
__global__ void esc_stream_mul_kernel(const float4* __restrict__ a,
                                      const float4* __restrict__ b,
                                      float4* __restrict__ out, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) mul4(a, b, out, i);
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
template <int G, class Body>
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
      x[u] = Body::load(pa + u * step);
      y[u] = Body::load(pb + u * step);
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
// the barrier) of kThreads / slices columns, by `slices` row slices; row l
// of a and b starts at l * n4.  part holds 2 * kThreads float4s (the two
// parts of every thread's sum) and is free again when the pass returns.
template <class Body = GlobalBody>
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
      case 1: v = red_rows<1, Body>(a, b, n4, j, ty, slices, R); break;
      case 2: v = red_rows<2, Body>(a, b, n4, j, ty, slices, R); break;
      default:
        v = red_rows<kRedMaxGroup, Body>(a, b, n4, j, ty, slices, R);
        break;
    }
  }
  if (slices == 1) {  // the whole block: no combine, no barrier
    if (j < end) out[j] = kahan_value(v);
    return;
  }
  part[threadIdx.x] = v.s;
  part[kThreads + threadIdx.x] = v.c;
  Body::sync();
  if (ty == 0 && j < end) {
    const int bx = kThreads / slices;
    for (int y = 1; y < slices; ++y) {
      const int i = y * bx + threadIdx.x;
      kahan_merge(v, {part[i], part[kThreads + i]});
    }
    out[j] = kahan_value(v);
  }
  Body::sync();  // part is rewritten by the next pass
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

// ---- the probe's pipeline: mbarriers and bulk copies (sm_90) ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the producer's arrival, with the bytes the stage's copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed; traps after about a
// second, which no stage of this kernel can legitimately take.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > kPipeHangCycles) __trap();
}

// bytes (a multiple of 16) from device memory to shared memory, both
// 16-byte aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The mul stages: stage s is elements [s * block, s * block + width) of a
// and of b, at 0 and block floats into its slot.
struct MulStages {
  const float* a;
  const float* b;
  float* out;
  long long n;      // elements, a multiple of 4
  long long block;  // elements of a stage, a multiple of 4

  __device__ __forceinline__ long long width(long long s) const {
    return min(block, n - s * block);
  }
  __device__ __forceinline__ unsigned bytes(long long s) const {
    return (unsigned)(8 * width(s));
  }
  __device__ __forceinline__ void load(float* slot, long long s,
                                       uint64_t* full) const {
    const unsigned w = (unsigned)(4 * width(s));
    bulk_load(slot, a + s * block, w, full);
    bulk_load(slot + block, b + s * block, w, full);
  }
  __device__ __forceinline__ void consume(const float* slot, long long s,
                                          float4*) const {
    const float4* x = reinterpret_cast<const float4*>(slot);
    const float4* y = reinterpret_cast<const float4*>(slot + block);
    float4* o = reinterpret_cast<float4*>(out + s * block);
    const long long w4 = width(s) / 4;
    for (long long i = threadIdx.x; i < w4; i += kThreads)
      mul4<RingBody>(x, y, o, i);
  }
};

// The red stages: stage s is chunk columns [s * block, s * block + width)
// of the L rows of a and of b; row l of a at l * block floats into the
// slot, row l of b at (L + l) * block.
struct RedStages {
  const float* a;
  const float* b;
  float* out;
  long long n_pad;  // chunk columns, a multiple of 4
  long long block;  // chunk columns of a stage, a multiple of 4
  int L, slices, group;

  __device__ __forceinline__ long long width(long long s) const {
    return min(block, n_pad - s * block);
  }
  __device__ __forceinline__ unsigned bytes(long long s) const {
    return (unsigned)(8 * L * width(s));
  }
  __device__ __forceinline__ void load(float* slot, long long s,
                                       uint64_t* full) const {
    const unsigned w = (unsigned)(4 * width(s));
    for (int l = 0; l < L; ++l) {
      bulk_load(slot + l * block, a + l * n_pad + s * block, w, full);
      bulk_load(slot + (L + l) * block, b + l * n_pad + s * block, w, full);
    }
  }
  __device__ __forceinline__ void consume(const float* slot, long long s,
                                          float4* part) const {
    const float4* x = reinterpret_cast<const float4*>(slot);
    const float4* y = reinterpret_cast<const float4*>(slot + L * block);
    float4* o = reinterpret_cast<float4*>(out + s * block);
    const long long w4 = width(s) / 4, b4 = block / 4;
    const int bx = kThreads / slices;
    for (long long j0 = 0; j0 < w4; j0 += bx)
      red_pass<RingBody>(x, y, o, L, b4, j0 + threadIdx.x % bx, w4, slices,
                         group, part);
  }
};

// Dynamic shared memory: [full mbarriers][empty mbarriers] in kPipeHeader
// bytes, then part_bytes of the red combine's scratch, then `stages` slots
// of slot_bytes.  Threads 0 .. kThreads - 1 consume, thread kThreads
// produces, the rest of its warp idles.
template <class Stages>
__global__ void __launch_bounds__(kPipeThreads, 2)
    esc_stream_pipe_kernel(const Stages st, long long n_stages, int stages,
                           int part_bytes, long long slot_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kPipeMaxStages;
  float4* part = reinterpret_cast<float4*>(smem + kPipeHeader);
  unsigned char* ring = smem + kPipeHeader + part_bytes;
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int k = 0;           // the slot of the block's stage in hand
  unsigned phase = 0;  // the parity of the slot's current use
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x != kThreads) return;
    for (long long s = blockIdx.x; s < n_stages; s += gridDim.x) {
      // the first use of a slot waits on parity 1, which counts as done
      mbar_wait(empty + k, phase ^ 1);
      mbar_expect_tx(full + k, st.bytes(s));
      st.load(reinterpret_cast<float*>(ring + k * slot_bytes), s, full + k);
      if (++k == stages) {
        k = 0;
        phase ^= 1;
      }
    }
    return;
  }
  for (long long s = blockIdx.x; s < n_stages; s += gridDim.x) {
    mbar_wait(full + k, phase);
    st.consume(reinterpret_cast<const float*>(ring + k * slot_bytes), s,
               part);
    mbar_arrive(empty + k);
    if (++k == stages) {
      k = 0;
      phase ^= 1;
    }
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The shared memory of one pipeline block (the wrapper's stage_smem).
long long pipe_smem(long long slot_bytes, int stages, int part_bytes) {
  return kPipeHeader + part_bytes + stages * slot_bytes;
}

// grid_factor blocks per SM, at most as many as fit on one, and at most one
// per stage.
template <class Stages>
int launch_pipe(const Stages& st, long long n_stages, int stages,
                int grid_factor, int part_bytes, long long slot_bytes,
                cudaStream_t stream) {
  const long long smem = pipe_smem(slot_bytes, stages, part_bytes);
  if (stages < 1 || stages > kPipeMaxStages || grid_factor < 1 ||
      grid_factor > kPipeMaxGridFactor || smem > kPipeSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto kernel = esc_stream_pipe_kernel<Stages>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, fit = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &fit, kernel, kPipeThreads, (size_t)smem)) != cudaSuccess)
    return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid =
      std::min<long long>((long long)std::min(grid_factor, fit) * sms,
                          n_stages);
  esc_stream_pipe_kernel<Stages>
      <<<(unsigned)grid, kPipeThreads, (size_t)smem, stream>>>(
      st, n_stages, stages, part_bytes, slot_bytes);
  return (int)cudaGetLastError();
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

// The probe's launches (spada_tpu_torch/tools/probe_pallas_stream.py): the
// pipeline above with `block` elements (mul) or chunk columns (red) a
// stage, a positive multiple of 4, a ring of `stages` slots (1 to 8) and
// grid_factor blocks per SM (1 to 4); every pointer 16-byte aligned.  A
// ring over 227 KB of shared memory is refused.
extern "C" int esc_stream_mul_blocked(const void* a, const void* b, void* out,
                                      long long n, long long block,
                                      int stages, int grid_factor,
                                      void* stream) {
  if (n <= 0 || n % 4 != 0 || block <= 0 || block % 4 != 0 ||
      block > kPipeSmemLimit || !aligned16(a) || !aligned16(b) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const MulStages st{static_cast<const float*>(a),
                     static_cast<const float*>(b), static_cast<float*>(out),
                     n, block};
  return launch_pipe(st, (n + block - 1) / block, stages, grid_factor, 0,
                     8 * block, static_cast<cudaStream_t>(stream));
}

extern "C" int esc_stream_red_blocked(const void* a, const void* b, void* out,
                                      int L, long long n_pad, int slices,
                                      int group, long long block, int stages,
                                      int grid_factor, void* stream) {
  if (!red_shape_ok(L, n_pad, slices, group) || block <= 0 ||
      block % 4 != 0 || block > kPipeSmemLimit || !aligned16(a) ||
      !aligned16(b) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const RedStages st{static_cast<const float*>(a),
                     static_cast<const float*>(b), static_cast<float*>(out),
                     n_pad, block, L, slices, group};
  return launch_pipe(st, (n_pad + block - 1) / block, stages, grid_factor,
                     slices > 1 ? kRedPartBytes : 0, 8LL * L * block,
                     static_cast<cudaStream_t>(stream));
}
