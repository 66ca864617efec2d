// Single-step decode matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_step.py:
//   decode_matmul_pallas  (_decode_mm_kernel)  -> decode_matmul
//
// What it computes.  out [M,N] = x [M,K] @ w [K,N], f32 accumulation, the
// output rounded once (RNE) to their dtype; x and w are both f32 or both
// bf16 (the TPU kernel takes no mixed pair either).
// The N output columns are split into R tiles of ns = N/R columns that run
// one after another (the paper's reuse factor); the K reduction is never
// split by R.  On the decode path it carries every per-token projection of
// the dense decoder (fused q|k|v, o, fused gate|up, down; bf16, M = the
// engine's max_batch) and the gate products of rnn_decode_step (f32, M up
// to 256, K <= 128, N <= 512).
//
// Translation of the TPU grid.  The TPU kernel's grid runs over M tiles
// only, the whole [K,N] weight resident in VMEM and the R column passes
// unrolled in-block.  Carried over block by block, one block would stream
// a 134 MB weight (gemma-2b gate|up, 2048 x 32768 bf16) through one SM.
// Here the grid is (M tiles) x (column blocks): a block owns ROWS rows of x
// and `cols` columns of every tile, and walks r = 0..R-1 over its share of
// tile r, so only N/R columns are in flight at a time, as on the TPU.
//
// Inside a block.  256 threads form ks K-groups of ct = 256/ks column
// threads; ks is a power of two chosen from M, K and N (enough blocks for
// two waves, at most min(128, K/8)), so it is the same for every R.
// Column thread t of group g reads V consecutive columns (one 16-byte
// load: 8 bf16 or 4 f32; scalar loads where N/R or the base address
// breaks that alignment) of the rows k = g, g+ks, ... of w: neighbouring
// threads read neighbouring columns, neighbouring groups neighbouring
// rows.  x is staged in shared memory in f32, in 32 KiB K-chunks (8 rows
// x 16384 x 4 B would not fit a block's 227 KiB), 8 loads in flight per
// thread, while the chunk's first rows of w load.  Each thread keeps
// ROWS x V f32 sums in registers; the ks partial sums of a column then
// meet in a fixed tree: shuffles within a warp, then the warps' sums in
// warp order through shared memory.
//
// Determinism.  Every output column is one full-K f32 reduction in one
// fixed order: each group sums its rows in increasing k, and the tree over
// groups depends only on ks.  Neither R nor V nor the number of column
// blocks changes it, so R = 1 and R = 4 give the same bits on the card.
//
// What bounds it.  At gemma-2b's decode (M = 4, bf16) the work is 2 flop
// per weight element and row: 8 flop per 2-byte weight, far below the
// card's ~20 flop/byte f32 CUDA-core ridge, so it is bound by
// the bytes of w (3.35 TB/s: 40 us for gate|up, 1.2 ms for a whole tick).
// The design streams w once per tick with 16-byte loads, eight rows in
// flight per thread, and spreads the columns over enough blocks to keep
// every SM loading (gate|up: 512 column blocks; o, down: 128).  On an
// NVIDIA H100 80GB HBM3 at a 700 W limit it reaches 28-54 % of the HBM
// rate at gate|up and down and 15-21 % at q|k|v and o, below cuBLAS at
// all four (PERF.md, measured by chip_smoke.py).  At the
// taggers' f32 shapes (M = 256) a product is a few microseconds of L2
// traffic and a call is bound by the host's launch path.
//
// Numerics: f32 FMA on CUDA cores, no tensor cores and no TF32; bf16
// inputs widen exactly to f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;     // rows of w in flight per thread
constexpr int kStage = 8;      // elements of x in flight per thread
constexpr int kMaxKGroups = 128;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// V consecutive elements of w at p as f32: one 16-byte load, or V = 1.
template <typename T, int V>
__device__ __forceinline__ void load_w(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      out[0] = __ldg(reinterpret_cast<const float*>(p));
    } else {
      out[0] = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
    }
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(words[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[2 * i] = bf16_bits(words[i] & 0xffffu);
        out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    }
  }
}

// x [M,K], w [K,N], out [M,N], all T; ks K-groups (power of two).
template <typename T, int ROWS, int V>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int K, int N, int reuse,
                     int ks) {
  constexpr int kChunk = 8192 / ROWS;  // x rows staged per pass: 32 KiB
  // rows of w in flight per thread: half as many where ROWS x V sums
  // already take 64 registers (the unroll never changes the sum order)
  constexpr int kU = ROWS * V > 32 ? kUnroll / 2 : kUnroll;
  __shared__ float x_s[ROWS * kChunk];
  __shared__ float part[kThreads * V];

  const int ct = kThreads / ks;        // column threads per K-group
  const int g = threadIdx.x / ct;
  const int t = threadIdx.x - g * ct;
  const int cols = ct * V;             // columns of each tile in this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = N / reuse;
  const int row0 = blockIdx.x * ROWS;
  const int cb = blockIdx.y * cols;    // first column of this block in a tile
  const bool live = cb + t * V < ns;

  for (int r = 0; r < reuse; ++r) {    // R sequential column tiles
    const int col = r * ns + cb + t * V;
    float acc[ROWS][V];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      const T* wp = w + (size_t)k0 * N + col;
      // the chunk's first kU rows of w load while x is staged
      float wv[kU][V];
      if (live && g + (kU - 1) * ks < kc) {
#pragma unroll
        for (int u = 0; u < kU; ++u)
          load_w<T, V>(wp + (size_t)(g + u * ks) * N, wv[u]);
      }
      __syncthreads();                 // the last chunk's readers are done
      // kStage independent loads in flight per thread (x is L2-resident)
      const int n = ROWS * kc;
      for (int i0 = threadIdx.x; i0 < n; i0 += kStage * kThreads) {
        float v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads, rr = i / kc, row = row0 + rr;
          v[u] = (i < n && row < M)
                     ? load_x(x + (size_t)row * K + k0 + (i - rr * kc))
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads, rr = i / kc;
          if (i < n) x_s[rr * kChunk + (i - rr * kc)] = v[u];
        }
      }
      __syncthreads();
      if (!live) continue;
      int k = g;
      for (; k + (kU - 1) * ks < kc; k += kU * ks) {
        if (k != g) {
#pragma unroll
          for (int u = 0; u < kU; ++u)
            load_w<T, V>(wp + (size_t)(k + u * ks) * N, wv[u]);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float xv = x_s[i * kChunk + k + u * ks];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[i][v] = fmaf(xv, wv[u][v], acc[i][v]);
          }
      }
      for (; k < kc; k += ks) {
        float w1[V];
        load_w<T, V>(wp + (size_t)k * N, w1);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float xv = x_s[i * kChunk + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][v] = fmaf(xv, w1[v], acc[i][v]);
        }
      }
    }

    // The ks partial sums of each column, in a fixed tree.  ct < 32: the
    // 32/ct groups of a warp meet by shuffles, then the 8 warps' sums in
    // warp order.  ct >= 32: a group spans whole warps; the ks groups'
    // sums meet in group order.
    const int n_part = ct < 32 ? kThreads / 32 : ks;
    const int p = ct < 32 ? warp : g;
    const bool writer = ct < 32 ? lane < ct : true;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float val = acc[i][v];
        for (int off = 16; off >= ct; off >>= 1)
          val += __shfl_down_sync(0xffffffffu, val, off);
        if (writer) part[p * cols + t * V + v] = val;
      }
      __syncthreads();
      const int row = row0 + i;
      if (row < M) {
        for (int c = threadIdx.x; c < cols && cb + c < ns; c += kThreads) {
          float s = part[c];
          for (int q = 1; q < n_part; ++q) s += part[q * cols + c];
          store(&out[(size_t)row * N + r * ns + cb + c], s);
        }
      }
      __syncthreads();
    }
  }
}

// K-groups per block: the smallest power of two that gives two waves of
// blocks over the card's SMs, at most 128 and at most K/8.  It depends on
// M, K, N and w's type, never on R or on the vector width in use.
int k_groups(int M, int rows, int K, int N, int vmax) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long m_tiles = (M + rows - 1) / rows;
  int ks = 1;
  while (ks * 2 <= kMaxKGroups && ks * 2 * 8 <= K) {
    const long long cols = (long long)(kThreads / ks) * vmax;
    if (m_tiles * ((N + cols - 1) / cols) >= 2LL * sms) break;
    ks *= 2;
  }
  return ks;
}

template <typename T, int ROWS, int V>
int run(const void* x, const void* w, void* out, int M, int K, int N,
        int reuse, cudaStream_t s) {
  const int ks = k_groups(M, ROWS, K, N, 16 / sizeof(T));
  const int cols = (kThreads / ks) * V;
  const int ns = N / reuse;
  const dim3 grid((M + ROWS - 1) / ROWS, (ns + cols - 1) / cols);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  decode_matmul_kernel<T, ROWS, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N, reuse, ks);
  return (int)cudaGetLastError();
}

template <typename T, int ROWS>
int pick_vector(const void* x, const void* w, void* out, int M, int K,
                int N, int reuse, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (N / reuse) % kVec == 0 &&
                       reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  if (aligned) return run<T, ROWS, kVec>(x, w, out, M, K, N, reuse, s);
  return run<T, ROWS, 1>(x, w, out, M, K, N, reuse, s);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           int reuse, void* stream) {
  if (M < 1 || K < 1 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return pick_vector<T, 1>(x, w, out, M, K, N, reuse, s);
  if (M <= 2) return pick_vector<T, 2>(x, w, out, M, K, N, reuse, s);
  if (M <= 4) return pick_vector<T, 4>(x, w, out, M, K, N, reuse, s);
  return pick_vector<T, 8>(x, w, out, M, K, N, reuse, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

int decode_matmul(const void* x, const void* w, int bf16, void* out, int M,
                  int K, int N, int reuse, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(x, w, out, M, K, N, reuse, stream);
  return launch<float>(x, w, out, M, K, N, reuse, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
