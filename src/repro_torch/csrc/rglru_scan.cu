// RG-LRU linear recurrence for Hopper (sm_90a): a streaming recurrence.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan.py  rglru_scan_pallas (_rglru_kernel)
//                                      -> rglru_scan
//
// rglru_scan.  a, bx [B,T,W] (each f32 or bf16) -> out [B,T,W] in a's dtype:
// h_t = a_t * h_{t-1} + bx_t with an f32 state that starts at zero, every
// state written out.  Each (row, column) is its own sequential chain over
// T, so no layout changes a value.
//
// What bounds it.  Bytes: B*T*W * (a, bx and out's item sizes) (two inputs
// read once, one output written once) over 3.35 TB/s; 2 flops an element
// are nothing beside that, and one chain's 2 dependent flops a step over
// T = 2048 are about 10 us.  At recurrentgemma-9b's width (B = 8, T = 2048,
// W = 4096, f32) that is 805 MB, 0.240 ms: the traffic of hadamard at
// (16384, 4096).  What the card needs is those bytes in flight from every
// SM.  The first form gave one thread one column and a block a [bb, bw]
// tile: 32 blocks of 1024 threads at B = 8, so 32 of the 132 SMs worked,
// and at R > 1 one block walked every width tile (one SM).
//
// The design: B*W chains of T steps, each a column of a [T, W] slab that is
// contiguous along W, streamed by one of two routes chosen at launch.
//
//  - The ring (rglru_scan_kernel_ring), wherever a TMA tensor map can
//    describe a and bx (16-byte-aligned bases, a row stride W * itemsize
//    that is a multiple of 16).  A block owns `cols` adjacent channels of
//    one batch row.  One producer thread keeps a ring of `stages` chunks of
//    [tc, cols] of a and of bx in shared memory, each a 3D TMA copy over the
//    [B, T, W] view (steps past T and channels past W arrive as zeros and
//    are not used) against the stage's "full" mbarrier; `cols` consumer
//    threads, one a channel, run the chain out of shared memory, store each
//    state (__stcs: 4 or 2 bytes a thread, whole lines a warp) and release
//    the stage on its "empty" mbarrier.  A block keeps up to 96 KiB in
//    flight whatever its thread count: 3 stages of at most 32 KiB (tc the
//    largest power of two up to 256 that fits); cols is 128 where that
//    still gives every SM a block (B * ceil(W / 128) >= the SM count), else
//    64 or 32.  At (8, 2048, 4096) f32: 256 blocks of 128 + 32 threads,
//    tc = 32, two blocks an SM (192 KiB in flight an SM); at B = 1: 128
//    blocks of 32 channels, tc = 128.
//  - The register window (rglru_scan_kernel), for every other operand: a
//    pointer, or a row stride, off the 16-byte grid runs this narrower
//    granule of the stream.  A thread owns V adjacent channels of one row
//    (the largest vector, at most 16 bytes of each input, that W and every
//    pointer allow, down to one element) and carries their states in
//    registers down T, with a window of U steps of both inputs in flight
//    (about 128 registers of loads), issued in two groups: one group's
//    loads run while the other group is computed.  The block is the
//    largest of 256 .. 32 threads that still gives every SM two blocks.
//
// kernels/rglru_scan.py rglru_layout is the Python model of plan() below;
// chip_smoke.py holds it to rglru_scan_layout on the card.  PERF.md has the
// design runs (each route alone, and their parameters).  The launcher
// refuses a layout past 227 KiB of shared memory.
//
// The reuse factor.  The TPU kernel's R walks the width tiles in order so
// that one tile of lanes is reused (the FPGA's DSP schedule).  On the card
// a width tile that waits for another saves no resource: it only idles the
// other SMs.  So bb, bw and serial name the schedule and choose nothing
// here: every R runs the same instance and layout, and R = 2, 4 give
// R = 1's bits by construction.
//
// Rounding.  Each step is __fadd_rn(__fmul_rn(a, h), bx): the product and
// the sum are rounded separately, as in the reference and the plain
// version, because nvcc would otherwise contract a * h + bx into one FMA and
// give other bits.  There is no split of T into chunks with a carry pass:
// that would change the association and lose the plain version's bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

constexpr int kMaxCols = 128;
constexpr int kStageBytes = 32 * 1024;     // a and bx of one stage, at most
constexpr int kStages = 3;
constexpr int kProducer = 32;              // one warp: its lane 0 copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival; the phase completes once `bytes` more have landed
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
// wait for the phase of parity `parity` to complete; a trap instead of a
// hang should the bytes never come (a fault, not a path of the design)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}
// the [tc, cols] box at (channel c, step t, row b) of `map` into dst
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c, int t, int b, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __uint_as_float((unsigned)__bfloat16_as_ushort(v) << 16);
}
__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Block k: batch row k / ceil(W / cols), channels from (k % ceil(W / cols))
// * cols.  Shared memory: `stages` x {a [tc][cols], bx [tc][cols]}, then
// the full and the empty mbarriers.  Threads [0, cols) consume, the warp
// after them produces.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kMaxCols + kProducer)
rglru_scan_kernel_ring(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       TA* __restrict__ out, int T, int W, int cols, int tc,
                       int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_bytes = tc * cols * (int)sizeof(TA);
  const int stage_bytes = a_bytes + tc * cols * (int)sizeof(TB);
  const unsigned full = smem_addr(smem + stages * stage_bytes);
  const unsigned empty = full + 8 * stages;
  const int col_blocks = (W + cols - 1) / cols;
  const int b = blockIdx.x / col_blocks;
  const int c0 = (blockIdx.x - b * col_blocks) * cols;
  const int chunks = (T + tc - 1) / tc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, cols);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= cols) {  // the producer warp
    if (threadIdx.x == cols) {
      for (int k = 0; k < chunks; ++k) {
        const int s = k % stages;
        // the stage's previous chunk (k - stages) has been consumed
        if (k >= stages) mbar_wait(empty + 8 * s, (k / stages - 1) & 1);
        mbar_expect(full + 8 * s, stage_bytes);
        const unsigned dst = smem_addr(smem + s * stage_bytes);
        tma_load(dst, &map_a, c0, k * tc, b, full + 8 * s);
        tma_load(dst + a_bytes, &map_b, c0, k * tc, b, full + 8 * s);
      }
    }
    return;
  }
  const int col = threadIdx.x;
  const bool live = c0 + col < W;
  TA* o = out + (size_t)b * T * W + c0 + col;
  float h = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % stages;
    mbar_wait(full + 8 * s, (k / stages) & 1);
    const TA* as = reinterpret_cast<const TA*>(smem + s * stage_bytes) + col;
    const TB* bs =
        reinterpret_cast<const TB*>(smem + s * stage_bytes + a_bytes) + col;
    const int n = T - k * tc < tc ? T - k * tc : tc;
    if (live) {
      for (int i = 0; i < n; ++i) {
        // no FMA: see the header
        h = __fadd_rn(__fmul_rn(widen(as[i * cols]), h), widen(bs[i * cols]));
        put(o + (size_t)(k * tc + i) * W, h);
      }
    }
    mbar_arrive(empty + 8 * s);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (the library does not link
// libcuda); null if the driver has none.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The [B, T, W] tensor at p as a map of [tc, cols] boxes.
template <typename E>
bool make_map(CUtensorMap* m, const void* p, int B, int T, int W, int cols,
              int tc) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(E),
                                 (cuuint64_t)W * T * sizeof(E)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)tc, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const EncodeTiled enc = encoder();
  return enc &&
         enc(m,
             sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// The register window
// ---------------------------------------------------------------------------

constexpr int kBufWords = 128;     // registers of a thread's window of steps
constexpr int kMaxUnroll = 64;
constexpr int kGroups = 2;         // load groups in a thread's window
constexpr int kBlocksPerSm = 2;
constexpr int kMaxThreads = 256;

// Raw bits of a vector of `Bytes` bytes (one load or store).
template <int Bytes> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// Registers a vector of V elements of T takes.
template <typename T, int V>
__host__ __device__ constexpr int words() {
  return V * (int)sizeof(T) < 4 ? 1 : V * (int)sizeof(T) / 4;
}

// Steps in a thread's window: the register budget over one step's words,
// down to a power of two (at most kMaxUnroll, at least kGroups).
template <typename TA, typename TB, int V>
__host__ __device__ constexpr int unroll() {
  const int fit = kBufWords / (words<TA, V>() + words<TB, V>());
  int u = kMaxUnroll;
  while (u > kGroups && u > fit) u /= 2;
  return u;
}

// V elements of T as raw bits; bf16 widens to f32 by a shift (exact).  The
// bits move through memcpy, which compiles to register moves.
template <typename T, int V>
struct Vec {
  using Raw = typename RawOf<V * sizeof(T)>::type;

  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
    if constexpr (sizeof(T) == 4) {
      memcpy(f, &r, sizeof(Raw));
    } else {
      unsigned short h[V];
      memcpy(h, &r, sizeof(Raw));
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = __uint_as_float((unsigned)h[i] << 16);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    Raw r;
    if constexpr (sizeof(T) == 4) {
      memcpy(&r, f, sizeof(Raw));
    } else {
      unsigned short h[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f[i]));
      memcpy(&r, h, sizeof(Raw));
    }
    __stcs(reinterpret_cast<Raw*>(p), r);
  }
};

// One step of V chains: h = a * h + bx, rounded twice; the state goes out.
template <typename TA, typename TB, int V>
__device__ __forceinline__ void step(const typename Vec<TA, V>::Raw& ra,
                                     const typename Vec<TB, V>::Raw& rb,
                                     float* h, TA* o) {
  float fa[V], fb[V];
  Vec<TA, V>::widen(ra, fa);
  Vec<TB, V>::widen(rb, fb);
#pragma unroll
  for (int i = 0; i < V; ++i)
    h[i] = __fadd_rn(__fmul_rn(fa[i], h[i]), fb[i]);  // no FMA: the header
  Vec<TA, V>::store(o, h);
}

// Thread i owns channels [c, c + V) of row b, i = b * (W / V) + c / V.  Its
// window holds U steps in kGroups groups; each group's loads are issued as
// soon as its steps have been computed, so they run while the other groups
// are computed.
template <typename TA, typename TB, int V>
__global__ void __launch_bounds__(kMaxThreads)
rglru_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ bx,
                  TA* __restrict__ out, int B, int T, int W) {
  constexpr int U = unroll<TA, TB, V>();
  constexpr int G = U / kGroups;  // steps a group
  using VA = Vec<TA, V>;
  using VB = Vec<TB, V>;
  const long long nv = W / V;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)B * nv) return;
  const long long row = id / nv;
  const size_t base = (size_t)row * T * W + (size_t)(id - row * nv) * V;
  const size_t w = (size_t)W;
  const TA* la = a + base;        // the load cursor, U steps ahead
  const TB* lb = bx + base;
  TA* so = out + base;            // the store cursor
  typename VA::Raw ra[U];
  typename VB::Raw rb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < T) {
      ra[u] = VA::load(la);
      rb[u] = VB::load(lb);
    }
    la += w;
    lb += w;
  }
  float h[V];
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = 0.0f;
  int t0 = 0;
  for (; t0 + 2 * U <= T; t0 += U) {  // every reload in range: no guard
#pragma unroll
    for (int g = 0; g < U; g += G) {
#pragma unroll
      for (int u = g; u < g + G; ++u) {
        step<TA, TB, V>(ra[u], rb[u], h, so);
        so += w;
      }
#pragma unroll
      for (int u = g; u < g + G; ++u) {
        ra[u] = VA::load(la);
        rb[u] = VB::load(lb);
        la += w;
        lb += w;
      }
    }
  }
  for (; t0 < T; t0 += U) {
#pragma unroll
    for (int g = 0; g < U; g += G) {
#pragma unroll
      for (int u = g; u < g + G; ++u) {
        if (t0 + u < T) step<TA, TB, V>(ra[u], rb[u], h, so);
        so += w;
      }
#pragma unroll
      for (int u = g; u < g + G; ++u) {
        if (t0 + U + u < T) {
          ra[u] = VA::load(la);
          rb[u] = VB::load(lb);
        }
        la += w;
        lb += w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The launch layout; kernels/rglru_scan.py rglru_layout is its model
// ---------------------------------------------------------------------------

struct Plan {
  int ring;              // 1: the ring, 0: the register window
  int vec, unroll;       // the window's vector and steps (the ring: 1, 0)
  int cols, tc, stages;  // the ring's channels a block, steps a stage, stages
  int threads;
  long long blocks;
  size_t smem;
};

template <typename TA, typename TB>
int unroll_of(int v) {
  switch (v) {
    case 8:
      if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2)
        return unroll<TA, TB, 8>();
      return 0;
    case 4: return unroll<TA, TB, 4>();
    case 2: return unroll<TA, TB, 2>();
    default: return unroll<TA, TB, 1>();
  }
}

bool on_grid(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TA, typename TB>
Plan plan(const void* a, const void* bx, const void* out, int B, int W,
          int sms) {
  constexpr int sa = sizeof(TA), sb = sizeof(TB);
  Plan p{};
  if (on_grid(a, 16) && on_grid(bx, 16) && (long long)W * sa % 16 == 0 &&
      (long long)W * sb % 16 == 0) {
    p.ring = 1;
    p.vec = 1;
    p.cols = kMaxCols;
    while (p.cols > 32 &&
           (long long)B * ((W + p.cols - 1) / p.cols) < (long long)sms)
      p.cols /= 2;
    p.tc = 256;
    while (p.tc > 1 && p.tc * p.cols * (sa + sb) > kStageBytes) p.tc /= 2;
    p.blocks = (long long)B * ((W + p.cols - 1) / p.cols);
    p.stages = kStages;
    p.threads = p.cols + kProducer;
    // the stages, each with its two mbarriers
    p.smem = (size_t)kStages * (p.tc * p.cols * (sa + sb) + 16);
    return p;
  }
  int v = 16 / (sa > sb ? sa : sb);
  for (; v > 1; v /= 2)  // the largest vector W and every pointer allow
    if (W % v == 0 && on_grid(a, v * sa) && on_grid(bx, v * sb) &&
        on_grid(out, v * sa))
      break;
  const long long n = (long long)B * (W / v);
  int threads = kMaxThreads;
  while (threads > 32 &&
         (n + threads - 1) / threads < (long long)sms * kBlocksPerSm)
    threads /= 2;
  p.vec = v;
  p.unroll = unroll_of<TA, TB>(v);
  p.threads = threads;
  p.blocks = (n + threads - 1) / threads;
  return p;
}

template <typename TA, typename TB>
int launch_ring(const void* a, const void* bx, void* out, int B, int T,
                int W, const Plan& p, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!make_map<TA>(&map_a, a, B, T, W, p.cols, p.tc) ||
      !make_map<TB>(&map_b, bx, B, T, W, p.cols, p.tc))
    return (int)cudaErrorInvalidValue;
  const auto kernel = rglru_scan_kernel_ring<TA, TB>;
  static bool sized = false;  // the attribute, once an instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<(unsigned)p.blocks, p.threads, p.smem, s>>>(
      map_a, map_b, static_cast<TA*>(out), T, W, p.cols, p.tc, p.stages);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_window(const void* a, const void* bx, void* out, int B, int T,
                  int W, const Plan& p, cudaStream_t s) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(bx);
  TA* po = static_cast<TA*>(out);
  const dim3 grid((unsigned)p.blocks), block(p.threads);
  switch (p.vec) {
    case 8:
      if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2) {
        rglru_scan_kernel<TA, TB, 8><<<grid, block, 0, s>>>(pa, pb, po, B, T,
                                                            W);
        break;
      }
      return (int)cudaErrorInvalidValue;
    case 4:
      rglru_scan_kernel<TA, TB, 4><<<grid, block, 0, s>>>(pa, pb, po, B, T, W);
      break;
    case 2:
      rglru_scan_kernel<TA, TB, 2><<<grid, block, 0, s>>>(pa, pb, po, B, T, W);
      break;
    case 1:
      rglru_scan_kernel<TA, TB, 1><<<grid, block, 0, s>>>(pa, pb, po, B, T, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

template <typename TA, typename TB>
int run(const void* a, const void* bx, void* out, int B, int T, int W,
        cudaStream_t s) {
  const Plan p = plan<TA, TB>(a, bx, out, B, W, card_sms());
  if (p.blocks > 0x7fffffffLL || p.smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return p.ring ? launch_ring<TA, TB>(a, bx, out, B, T, W, p, s)
                : launch_window<TA, TB>(a, bx, out, B, T, W, p, s);
}

template <typename TA, typename TB>
void plan_into(const void* a, const void* bx, const void* out, int B, int W,
               int sms, long long* lay) {
  const Plan p = plan<TA, TB>(a, bx, out, B, W, sms);
  const long long v[9] = {p.ring,    p.vec,    p.unroll,
                          p.cols,    p.tc,     p.stages,
                          p.threads, p.blocks, (long long)p.smem};
  memcpy(lay, v, sizeof v);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// a_bf16 / bx_bf16: 1 if that input is bfloat16, 0 if float32; out has a's
// dtype.  bb, bw, serial: the schedule's batch tile, width tile and serial
// width (R > 1); checked, and they choose no layout (see the header).
int rglru_scan(const void* a, int a_bf16, const void* bx, int bx_bf16,
               void* out, int B, int T, int W, int bb, int bw, int serial,
               void* stream) {
  (void)serial;
  if (B < 1 || T < 1 || W < 1 || bb < 1 || bw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16 && bx_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(a, bx, out, B, T, W, s);
  if (a_bf16) return run<__nv_bfloat16, float>(a, bx, out, B, T, W, s);
  if (bx_bf16) return run<float, __nv_bfloat16>(a, bx, out, B, T, W, s);
  return run<float, float>(a, bx, out, B, T, W, s);
}

// The layout rglru_scan takes for these pointers on `sms` SMs: lay[0..8] =
// ring, vec, unroll, cols, tc, stages, threads, blocks, shared-memory
// bytes.  0, or cudaErrorInvalidValue for a bad shape.
int rglru_scan_layout(const void* a, int a_bf16, const void* bx, int bx_bf16,
                      const void* out, int B, int W, int sms, long long* lay) {
  if (B < 1 || W < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  if (a_bf16 && bx_bf16)
    plan_into<__nv_bfloat16, __nv_bfloat16>(a, bx, out, B, W, sms, lay);
  else if (a_bf16)
    plan_into<__nv_bfloat16, float>(a, bx, out, B, W, sms, lay);
  else if (bx_bf16)
    plan_into<float, __nv_bfloat16>(a, bx, out, B, W, sms, lay);
  else
    plan_into<float, float>(a, bx, out, B, W, sms, lay);
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
