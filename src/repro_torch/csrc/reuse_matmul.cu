// Reuse-tiled matrix products for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/reuse_matmul.py:
//   col_matmul_pallas    (_col_mm_kernel)    -> col_matmul
//   reuse_matmul_pallas  (_reuse_mm_kernel)  -> reuse_matmul
//
// What they compute.  out [M,N] = x [M,K] @ w [K,N], f32 accumulation,
// output in x's dtype.
//   col_matmul: the N output columns are split into R tiles of N/R columns,
//     and tile r = 0..R-1 runs after tile r-1 inside a block (the TPU grid
//     (M/bm, R) with R "arbitrary").  x is f32 or bf16, w is f32.  The port
//     builds the non-static schedule's per-timestep blocks from it (the
//     x-side and h-side gate products of every step) and the hoisted input
//     projection at hoist_reuse > 1.
//   reuse_matmul: the K reduction is split into R sequential passes of K/R
//     rows, each accumulated into the f32 sum (the TPU kernel's VMEM
//     accumulator becomes registers).  x and w are both f32 or both bf16.
//
// col_matmul: the tiled design.  The kernel's first form ran one thread per
// output column, at most 8 rows a block: each thread walked K dependent
// __ldg of its own w column from L2, and each of the 128 blocks at M = 256
// re-read all of w (256 KiB at QuickDraw's h side): bound by L2 latency,
// 7.7 us on an H100 SXM (700 W) against a 0.50 us operations bound.  Now a
// CTA of 128 threads (16 x 8) owns a tile of (16 TM) x (8 TN) outputs, TM x
// TN per thread in registers: 2 x 4, 1 x 4, 1 x 2 or 1 x 1, the first whose
// grid covers 90 % of the SMs (M = 256 and N = 512: 2 x 4, 128 CTAs; the
// hoist stage's M = 25 600: 2 x 4, 6 400 CTAs; R = 4 or M = 8: smaller
// tiles, more CTAs).  The CTA walks its (tile, K chunk) steps in order:
// tile r = 0..R-1 of the N/R column tiles, each over K in chunks of 64.
// Only the tiles a step needs are staged: x once (where K <= 256), and each
// step's w chunk [64][8 TN] in a ring of 4 slots, with 16-byte cp.async
// where rows are 16-byte aligned (4-byte cp.async where 4-byte aligned,
// masked loads at other layouts); rows and columns past the edges are
// zero.  Where every step fits the ring with one chunk (K <= 64, R <= 4),
// all tiles are staged in one pass and waited for once; past that, step
// s + 1's copy runs under step s's FMAs.  Per 4 k a thread makes TM 16-byte
// x loads (a row broadcast across a quarter warp) and four w loads of TN
// floats (a quarter warp reads contiguous bytes) for 4 TM TN FMAs.
// __launch_bounds__(128, 1): with a bare thread count ptxas trades spills
// for occupancy.
//
// Numerics.  f32 FMA on CUDA cores: no TF32 and no 3xTF32 (TF32 breaks the
// 3e-5 parity, and the work is 0.5 us at the f32 peak).  K is never split:
// every output is one thread's k-ascending fmaf chain (the padding adds
// exact zeros), with no atomics, so results are the same bits from run to
// run, and those of the first form, which summed in the same order.  bf16
// x widens exactly to f32.
//
// reuse_matmul: one thread block owns ROWS rows of x (the TPU's parallel M
// axis), staged in shared memory as f32, and one thread per output column
// (a second grid axis covers N past 512 columns); the block walks the R
// K-passes in order, staging pass r's K/R columns of x and reading the
// matching K/R rows of w, each thread streaming its own w column from L2.
//
// What bounds them.  At the shapes the port runs (M = 256 rows per step, K
// and N at most a few hundred) one product is well under a microsecond of
// work at the 67 TFLOP/s f32 peak (QuickDraw h-side: 2*256*128*512 FLOP,
// 0.5 us).  On the device col_matmul is now bound by latency (the launch,
// one L2 round trip of the staged tiles) and the FMA and shared-load issue
// of one warp a scheduler (5.0 us at QuickDraw's h-side on an H100 SXM at
// 700 W); called from Python, the host's launch path costs more than the
// device.  The pipeline kernels in rnn_scan.cu fuse a scan's products
// into one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_stage.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kCThreads = 128;         // 16 x 8 threads
constexpr int kCChunk = 64;            // K a step
constexpr int kCStages = 4;            // steps in flight: a ring of w slots
constexpr int kCXResident = 256;       // K up to which x is staged once

// Four consecutive x values of a shared row as f32 (16 or 8 bytes).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// TN consecutive w values of a shared row.
template <int TN>
__device__ __forceinline__ void load_w(const float* p, float (&v)[TN]) {
  if constexpr (TN == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (TN == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = *p;
  }
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The thread tiles of col_matmul: TM x TN outputs a thread, CTA tile
// (16 TM) x (8 TN) for 16 x 8 threads; the launcher takes the first (most
// outputs a thread: fewest shared loads an FMA) whose grid fills the SMs,
// else the last (most CTAs).
constexpr int kColTiles[4][2] = {{2, 4}, {1, 4}, {1, 2}, {1, 1}};

// Shared memory of a launch: x (staged once, [BM][K] padded, where K <=
// kCXResident; else a [BM][kCChunk] slot a ring slot; rows of 16 bytes
// more than their data) | a ring of w slots [chunk_k][BN] f32.
struct ColSmem {
  int chunk_k;      // k a w slot: min(K, kCChunk), rounded up to 4
  int x_row;        // bytes a shared x row
  bool x_resident;  // x staged once, in the first tile's steps
  int slots;        // ring slots: min(steps, kCStages)
  int x_bytes, bytes;
};

__host__ __device__ inline ColSmem col_smem(int K, int steps, int es,
                                           int bm, int bn) {
  ColSmem c;
  c.chunk_k = round_up(K < kCChunk ? K : kCChunk, 4);
  c.x_resident = K <= kCXResident;
  c.x_row = round_up((c.x_resident ? round_up(K, 4) : kCChunk) * es, 16) + 16;
  c.slots = steps < kCStages ? steps : kCStages;
  c.x_bytes = (c.x_resident ? 1 : c.slots) * bm * c.x_row;
  c.bytes = c.x_bytes + c.slots * c.chunk_k * bn * (int)sizeof(float);
  return c;
}

// Stage step s = (tile, chunk kc) into ring slot s % kCStages: w rows
// [k0, k0 + 64) of the tile's columns [col0, col0 + BN), and, with x, the
// chunk's x rows (where K <= kCXResident: into the one x buffer, in the
// first tile's steps only).  k past K is zero, up to a multiple of 4.  It
// takes the kernel's own arguments, so that they stay in constant memory.
template <typename XT, int BM, int BN>
__device__ __forceinline__ void col_stage(
    const XT* __restrict__ x, const float* __restrict__ w, int M, int K,
    int N, int reuse, int x_align, int w_align, unsigned smem, int s,
    int tile, int kc, bool w_part, bool x_part) {
  constexpr int ES = sizeof(XT), SEGS = BN / 4;  // 16-byte w segments a row
  constexpr int XSEGS = kCChunk * ES / 16;       // at most, a chunk's x row
  const int tid = threadIdx.x, slot = s & (kCStages - 1);
  const int tw = N / reuse, col0 = blockIdx.y * BN, row0 = blockIdx.x * BM;
  const int chunks = K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1;
  const ColSmem L = col_smem(K, reuse * chunks, ES, BM, BN);
  const int k0 = kc * kCChunk;
  const int kk = (min(K - k0, kCChunk) + 3) & ~3;
  if (w_part) {
    const unsigned wd = smem + L.x_bytes + slot * L.chunk_k * BN * 4;
    const char* wb = reinterpret_cast<const char*>(
        w + (size_t)k0 * N + (size_t)tile * tw + col0);
    const int cols = tw - col0;
    for (int i = tid; i < kk * SEGS; i += kCThreads) {
      const int k = i / SEGS, q = i % SEGS;
      stage16(wd + (k * BN + 4 * q) * 4, wb + (size_t)k * N * 4 + 16 * q,
              k0 + k < K ? (cols - 4 * q) * 4 : 0, w_align);
    }
  }
  if (!x_part || (L.x_resident && tile != 0)) return;
  const unsigned xd =
      L.x_resident ? smem + k0 * ES : smem + slot * BM * L.x_row;
  const char* xb = reinterpret_cast<const char*>(x + (size_t)row0 * K + k0);
  const int segs = (kk * ES + 15) / 16;
  for (int i = tid; i < BM * XSEGS; i += kCThreads) {
    const int r = i / XSEGS, q = i % XSEGS;
    if (q < segs)
      stage16(xd + r * L.x_row + 16 * q, xb + (size_t)r * K * ES + 16 * q,
              row0 + r < M ? (K - k0) * ES - 16 * q : 0, x_align);
  }
}

// x [M,K] (XT), w [K,N] f32, out [M,N] (XT); tile width tw = N / reuse.
// Grid: (ceil(M / 16 TM), ceil(tw / 8 TN)); x_align / w_align: stage16
// granules; out_vec: every thread's 4 output columns (TN = 4) may be
// stored as one vector; dynamic shared memory: col_smem(...).bytes.
template <typename XT, int TM, int TN>
__global__ void __launch_bounds__(kCThreads, 1)
col_matmul_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                  XT* __restrict__ out, int M, int K, int N, int reuse,
                  int x_align, int w_align, int out_vec) {
  constexpr int ES = sizeof(XT), BM = 16 * TM, BN = 8 * TN;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int tw = N / reuse;
  const int chunks = K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1;
  const int steps = reuse * chunks;         // (tile, chunk), tiles in order
  // this thread's first output row and first column of a tile
  const int row = blockIdx.x * BM + TM * ty, col = blockIdx.y * BN + TN * tx;
  const bool vec = TN == 4 && out_vec && col + 4 <= tw;
  // every step's tiles staged up front (one chunk, R <= kCStages): one
  // group, one wait, one barrier
  const bool resident = chunks == 1 && steps <= kCStages;
  const unsigned smem_u = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const ColSmem L = col_smem(K, steps, ES, BM, BN);
  const int fill = min(steps, kCStages);
  if (resident) {
    // all R tiles' w in one pass: this thread's 16-byte segment (i / SEGS,
    // i % SEGS) of every tile, i = tid, tid + 128, ...
    constexpr int SEGS = BN / 4;
    const int col0 = blockIdx.y * BN;
    for (int i = tid; i < L.chunk_k * SEGS; i += kCThreads) {
      const int k = i / SEGS, q = i % SEGS;
      const unsigned wd = smem_u + L.x_bytes + (k * BN + 4 * q) * 4;
      const char* src =
          reinterpret_cast<const char*>(w + (size_t)k * N + col0) + 16 * q;
      const int n = k < K ? (tw - col0 - 4 * q) * 4 : 0;
      for (int tile = 0; tile < steps; ++tile)
        stage16(wd + tile * L.chunk_k * BN * 4, src + (size_t)tile * tw * 4,
                n, w_align);
    }
    if (x_align > 1)
      col_stage<XT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align, smem_u,
                            0, 0, 0, false, true);
    cp_async_commit();
  } else {
    // fill the ring, a group a step: every w copy is issued before x's
    // masked loads (synchronous) wait for theirs
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      col_stage<XT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align, smem_u,
                            p, pt, pk, true, x_align > 1);
      cp_async_commit();
      if (++pk == chunks) pk = 0, ++pt;
    }
  }
  if (x_align == 1)
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      col_stage<XT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align, smem_u,
                            p, pt, pk, false, true);
      if (++pk == chunks) pk = 0, ++pt;
    }

  float acc[TM][TN];
  int tile = 0, kc = 0;                     // step s
  int rt = fill / chunks, rk = fill % chunks;  // step s + kCStages
  for (int s = 0; s < steps; ++s) {
    const int slot = s & (kCStages - 1), k0 = kc * kCChunk;
    if (!resident || s == 0) {
      cp_async_wait_upto(resident ? 0 : min(kCStages - 1, steps - 1 - s));
      __syncthreads();                   // step s's tiles are in place
    }

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    const unsigned char* xr =
        (L.x_resident ? smem + k0 * ES : smem + slot * BM * L.x_row) +
        TM * ty * L.x_row;
    const float* wt = reinterpret_cast<const float*>(smem + L.x_bytes) +
                      slot * L.chunk_k * BN + TN * tx;
    const int kk = (min(K - k0, kCChunk) + 3) & ~3;
    for (int k = 0; k < kk; k += 4) {
      float xv[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a =
            load4(reinterpret_cast<const XT*>(xr + i * L.x_row) + k);
        xv[i][0] = a.x, xv[i][1] = a.y, xv[i][2] = a.z, xv[i][3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wv[TN];
        load_w<TN>(wt + (k + q) * BN, wv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(xv[i][q], wv[j], acc[i][j]);
      }
    }

    if (++kc == chunks) {               // the tile's sums are complete
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        XT* o = out + (size_t)(row + i) * N + (size_t)tile * tw + col;
        if (row + i >= M) {
        } else if (vec) {
          if constexpr (TN == 4)
            store4(o, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (col + j < tw) store(&o[j], acc[i][j]);
        }
      }
      kc = 0, ++tile;
    }
    if (s + kCStages < steps) {          // restage this slot: step s + 4
      __syncthreads();
      col_stage<XT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align, smem_u,
                            s + kCStages, rt, rk, true, true);
      cp_async_commit();
      if (++rk == chunks) rk = 0, ++rt;
    }
  }
}

// x [M,K], w [K,N], out [M,N], all T; K split into reuse passes of ks rows.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
reuse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int M, int K, int N, int reuse) {
  extern __shared__ float x_s[];  // [ROWS, K / reuse]
  const int row0 = blockIdx.x * ROWS;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const int ks = K / reuse;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  for (int pass = 0; pass < reuse; ++pass) {  // R sequential K passes
    const int k0 = pass * ks;
    for (int i = threadIdx.x; i < ROWS * ks; i += blockDim.x) {
      const int r = i / ks, k = i - r * ks, row = row0 + r;
      x_s[i] = row < M ? to_f32(x[(size_t)row * K + k0 + k]) : 0.0f;
    }
    __syncthreads();
    if (n < N) {
#pragma unroll 4
      for (int k = 0; k < ks; ++k) {
        const float wv = to_f32(w[(size_t)(k0 + k) * N + n]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(x_s[r * ks + k], wv, acc[r]);
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (row0 + r < M) store(&out[(size_t)(row0 + r) * N + n], acc[r]);
  }
}

// The SMs of the current device (132 on an H100 SXM).
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Rows per block: the smallest of 1, 2, 4, 8 that keeps the row tiles within
// one wave of SMs, else 8 (more rows share each w load).
int rows_for(int M) {
  const int sms = sm_count();
  int rows = 1;
  while (rows < 8 && (M + rows - 1) / rows > sms) rows *= 2;
  return rows;
}

int threads_for(int cols) {
  const int t = ((cols + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : (t < 32 ? 32 : t);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename T, int ROWS>
int run_reuse(const void* x, const void* w, void* out, int M, int K, int N,
              int reuse, cudaStream_t s) {
  auto kernel = reuse_matmul_kernel<T, ROWS>;
  const size_t smem = (size_t)ROWS * (K / reuse) * sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const int threads = threads_for(N);
  const dim3 grid((M + ROWS - 1) / ROWS, (N + threads - 1) / threads);
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(w),
                                     static_cast<T*>(out), M, K, N, reuse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reuse(const void* x, const void* w, void* out, int M, int K, int N,
                 int reuse, void* stream) {
  if (M < 1 || K < 0 || N < 1 || reuse < 1 || K % reuse != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_for(M)) {
    case 1: return run_reuse<T, 1>(x, w, out, M, K, N, reuse, s);
    case 2: return run_reuse<T, 2>(x, w, out, M, K, N, reuse, s);
    case 4: return run_reuse<T, 4>(x, w, out, M, K, N, reuse, s);
    default: return run_reuse<T, 8>(x, w, out, M, K, N, reuse, s);
  }
}

// The thread tile of a col_matmul launch (index into kColTiles): the first,
// most outputs a thread, whose grid fills 90 % of the SMs, else the last.
int col_config(int M, int tw) {
  const long long sms = sm_count() * 9 / 10;
  for (int c = 0; c < 3; ++c) {
    const int bm = 16 * kColTiles[c][0], bn = 8 * kColTiles[c][1];
    const long long ctas =
        (long long)((M + bm - 1) / bm) * ((tw + bn - 1) / bn);
    if (ctas >= sms) return c;
  }
  return 3;
}

int col_steps(int K, int reuse) {
  return reuse * (K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1);
}

template <typename XT, int TM, int TN>
int run_col(const void* x, const float* w, void* out, int M, int K, int N,
            int reuse, int xa, int wa, int ov, cudaStream_t s) {
  auto kernel = col_matmul_kernel<XT, TM, TN>;
  const int tw = N / reuse;
  const size_t smem =
      col_smem(K, col_steps(K, reuse), sizeof(XT), 16 * TM, 8 * TN).bytes;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((M + 16 * TM - 1) / (16 * TM), (tw + 8 * TN - 1) / (8 * TN));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kCThreads, smem, s>>>(static_cast<const XT*>(x), w,
                                       static_cast<XT*>(out), M, K, N, reuse,
                                       xa, wa, ov);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_col(int config, const void* x, const float* w, void* out, int M,
               int K, int N, int reuse, int xa, int wa, int ov,
               cudaStream_t s) {
  switch (config) {
    case 0: return run_col<XT, 2, 4>(x, w, out, M, K, N, reuse, xa, wa, ov, s);
    case 1: return run_col<XT, 1, 4>(x, w, out, M, K, N, reuse, xa, wa, ov, s);
    case 2: return run_col<XT, 1, 2>(x, w, out, M, K, N, reuse, xa, wa, ov, s);
    default:
      return run_col<XT, 1, 1>(x, w, out, M, K, N, reuse, xa, wa, ov, s);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// The launch of col_matmul at (M, K, N, reuse) for f32 x: rows and columns
// a CTA, grid x and y, threads a CTA, ring slots and dynamic shared bytes,
// into layout[0..6].  0, or cudaErrorInvalidValue where col_matmul refuses
// the shape.
int col_matmul_layout(int M, int K, int N, int reuse, int* layout) {
  if (M < 1 || K < 0 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = N / reuse, c = col_config(M, tw);
  const int bm = 16 * kColTiles[c][0], bn = 8 * kColTiles[c][1];
  const ColSmem L = col_smem(K, col_steps(K, reuse), 4, bm, bn);
  const int v[7] = {bm, bn, (M + bm - 1) / bm, (tw + bn - 1) / bn,
                    kCThreads, L.slots, L.bytes};
  for (int i = 0; i < 7; ++i) layout[i] = v[i];
  return v[3] > 65535 ? (int)cudaErrorInvalidValue : 0;
}

int col_matmul(const void* x, int x_bf16, const float* w, void* out, int M,
               int K, int N, int reuse, void* stream) {
  if (M < 1 || K < 0 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = N / reuse, es = x_bf16 ? 2 : 4;
  const int xa = align_of(x, (long long)K * es, 0);
  const int wa = align_of(w, 4LL * N, 4LL * tw);
  // each thread's 4 columns start at a multiple of 4 of a row and a tile
  const int ov = N % 4 == 0 && tw % 4 == 0 &&
                 reinterpret_cast<unsigned long long>(out) % (4 * es) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = col_config(M, tw);
  return x_bf16 ? launch_col<__nv_bfloat16>(c, x, w, out, M, K, N, reuse, xa,
                                            wa, ov, s)
                : launch_col<float>(c, x, w, out, M, K, N, reuse, xa, wa, ov,
                                    s);
}

int reuse_matmul(const void* x, const void* w, int bf16, void* out, int M,
                 int K, int N, int reuse, void* stream) {
  if (bf16)
    return launch_reuse<__nv_bfloat16>(x, w, out, M, K, N, reuse, stream);
  return launch_reuse<float>(x, w, out, M, K, N, reuse, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
