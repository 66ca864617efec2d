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
// The tiled design, both kernels.  A CTA of 128 threads (16 x 8) owns a
// tile of (16 TM) x (8 TN) outputs, TM x TN per thread in registers: 2 x 4,
// 1 x 4, 1 x 2 or 1 x 1, the first whose grid covers 90 % of the SMs
// (M = 256 and N = 512: 2 x 4, 128 CTAs; the hoist stage's M = 25 600:
// 2 x 4, 6 400 CTAs; R = 4 or M = 8: smaller tiles, more CTAs).  The CTA
// walks its (tile, K chunk) steps in order: tile r = 0..R-1 of the N/R
// column tiles, each over K in chunks of 64.  Only the tiles a step needs
// are staged: x once (where K <= 256), and each step's w chunk [64][8 TN]
// (in w's type: bf16 w is staged as bf16, half the bytes, and widened as
// it is loaded) in a ring of 4 slots, with 16-byte cp.async where rows are
// 16-byte aligned (4-byte cp.async where 4-byte aligned, masked loads at
// other layouts: bf16 rows of odd N); rows and columns past the edges are
// zero.  Where every step fits the ring with one chunk (K <= 64, R <= 4),
// all tiles are staged in one pass and waited for once; past that, step
// s + 1's copy runs under step s's FMAs.  Per 4 k a thread makes TM
// 16-byte (bf16: 8-byte) x loads (a row broadcast across a quarter warp)
// and four w loads of TN values (a quarter warp reads contiguous bytes)
// for 4 TM TN FMAs.  __launch_bounds__(128, 1): with a bare thread count
// ptxas trades spills for occupancy.
//
// reuse_matmul runs the same body as one tile of all N columns over all of
// K, whatever R: its R passes, summed in order, are the k-ascending chain
// of R = 1, so R names them only (as it names the column tiles of the
// pipeline scans in rnn_scan.cu).  On the TPU a pass bounds the K/R x N
// slice of w held in VMEM; here the ring bounds what is in flight to four
// chunks of 64 rows at any R, so walking the passes would buy nothing: a
// walk that did (chunks cut at pass boundaries) gave the same bits and was
// 8-40 % slower at R = 4 on an H100 SXM at 700 W.
//
// The first forms ran one thread per output column and at most 8 rows a
// block: each thread walked its own w column from L2 in dependent loads,
// and each of the 128 blocks at M = 256 re-read all of w (256 KiB at
// QuickDraw's h side): bound by L2 latency (col_matmul 7.7 us,
// reuse_matmul 8.5 us on an H100 SXM at 700 W, against a 0.50 us
// operations bound).
//
// Numerics.  f32 FMA on CUDA cores: no TF32 and no 3xTF32 (TF32 breaks the
// 3e-5 parity, and the work is 0.5 us at the f32 peak).  K is never split:
// every output is one thread's k-ascending fmaf chain (the padding adds
// exact zeros after the last product), with no atomics, so results are
// the same bits from run to run, reuse_matmul's at every R the same as at
// R = 1, and col_matmul's those of its first form, which summed in the
// same order.  bf16 x and w widen exactly to f32.
//
// What bounds them.  At the shapes the port runs (M = 256 rows per step, K
// and N at most a few hundred) one product is well under a microsecond of
// work at the 67 TFLOP/s f32 peak (QuickDraw h-side: 2*256*128*512 FLOP,
// 0.5 us).  On the device the tiled kernel is bound by latency (the launch,
// one L2 round trip of the staged tiles) and the FMA and shared-load issue
// of one warp a scheduler (col_matmul 5.0 us at QuickDraw's h-side on an
// H100 SXM at 700 W); called from Python, the host's launch path costs
// more than the device.  The pipeline kernels in rnn_scan.cu fuse a scan's
// products into one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_stage.cuh"

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kCThreads = 128;         // 16 x 8 threads
constexpr int kCChunk = 64;            // K a step, at most
constexpr int kCStages = 4;            // steps in flight: a ring of w slots
constexpr int kCXResident = 256;       // K up to which x is staged once

// bf16 bits to f32: exact.
__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Four consecutive x values of a shared row as f32 (16 or 8 bytes).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
}
// TN consecutive w values of a shared row, as f32.
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
template <int TN>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p,
                                       float (&v)[TN]) {
  if constexpr (TN == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = lo_bf16(u.x), v[1] = hi_bf16(u.x);
    v[2] = lo_bf16(u.y), v[3] = hi_bf16(u.y);
  } else if constexpr (TN == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    v[0] = lo_bf16(u), v[1] = hi_bf16(u);
  } else {
    v[0] = __bfloat162float(*p);
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

// The thread tiles: TM x TN outputs a thread, CTA tile (16 TM) x (8 TN) for
// 16 x 8 threads; the launcher takes the first (most outputs a thread:
// fewest shared loads an FMA) whose grid fills the SMs, else the last (most
// CTAs).
constexpr int kColTiles[4][2] = {{2, 4}, {1, 4}, {1, 2}, {1, 1}};

// Shared memory of a launch: x (staged once, [BM][K] padded, where K <=
// kCXResident; else a [BM][kCChunk] slot a ring slot; rows of 16 bytes
// more than their data) | a ring of w slots [chunk_k][BN] in w's type.
struct ColSmem {
  int chunk_k;      // k a w slot: min(K, kCChunk), rounded up to 4
  int x_row;        // bytes a shared x row
  bool x_resident;  // x staged once, in the first tile's steps
  int slots;        // ring slots: min(steps, kCStages)
  int x_bytes, bytes;
};

__host__ __device__ inline ColSmem col_smem(int K, int steps, int es,
                                           int wes, int bm, int bn) {
  ColSmem c;
  c.chunk_k = round_up(K < kCChunk ? K : kCChunk, 4);
  c.x_resident = K <= kCXResident;
  c.x_row = round_up((c.x_resident ? round_up(K, 4) : kCChunk) * es, 16) + 16;
  c.slots = steps < kCStages ? steps : kCStages;
  c.x_bytes = (c.x_resident ? 1 : c.slots) * bm * c.x_row;
  c.bytes = c.x_bytes + c.slots * c.chunk_k * bn * wes;
  return c;
}

// Stage step s = (tile, chunk kc) into ring slot s % kCStages: w rows
// [k0, k0 + 64) of the tile's columns [col0, col0 + BN), and, with x, the
// chunk's x rows (where K <= kCXResident: into the one x buffer, in the
// first tile's steps only).  k past K is zero, up to a multiple of 4.  It
// takes the kernel's own arguments, so that they stay in constant memory.
template <typename XT, typename WT, int BM, int BN>
__device__ __forceinline__ void col_stage(
    const XT* __restrict__ x, const WT* __restrict__ w, int M, int K, int N,
    int reuse, int x_align, int w_align, unsigned smem, int s, int tile,
    int kc, bool w_part, bool x_part) {
  constexpr int ES = sizeof(XT), WES = sizeof(WT);
  constexpr int SEGS = BN * WES / 16;            // 16-byte w segments a row
  constexpr int XSEGS = kCChunk * ES / 16;       // at most, a chunk's x row
  const int tid = threadIdx.x, slot = s & (kCStages - 1);
  const int tw = N / reuse, col0 = blockIdx.y * BN, row0 = blockIdx.x * BM;
  const int chunks = K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1;
  const ColSmem L = col_smem(K, reuse * chunks, ES, WES, BM, BN);
  const int k0 = kc * kCChunk;
  const int kk = (min(K - k0, kCChunk) + 3) & ~3;
  if (w_part) {
    const unsigned wd = smem + L.x_bytes + slot * L.chunk_k * BN * WES;
    const char* wb = reinterpret_cast<const char*>(
        w + (size_t)k0 * N + (size_t)tile * tw + col0);
    const int bytes = (tw - col0) * WES;         // of a row, from col0
    for (int i = tid; i < kk * SEGS; i += kCThreads) {
      const int k = i / SEGS, q = i % SEGS;
      stage16(wd + k * BN * WES + 16 * q, wb + (size_t)k * N * WES + 16 * q,
              k0 + k < K ? bytes - 16 * q : 0, w_align);
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

// The body of both kernels: x [M,K] (XT), w [K,N] (WT), out [M,N] (XT);
// tile width tw = N / reuse.  Grid: (ceil(M / 16 TM), ceil(tw / 8 TN));
// x_align / w_align: stage16 granules; out_vec: every thread's 4 output
// columns (TN = 4) may be stored as one vector; dynamic shared memory:
// col_smem(...).bytes.
template <typename XT, typename WT, int TM, int TN>
__device__ __forceinline__ void tiled_matmul(
    const XT* __restrict__ x, const WT* __restrict__ w, XT* __restrict__ out,
    int M, int K, int N, int reuse, int x_align, int w_align, int out_vec) {
  constexpr int ES = sizeof(XT), WES = sizeof(WT), BM = 16 * TM,
                BN = 8 * TN;
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

  const ColSmem L = col_smem(K, steps, ES, WES, BM, BN);
  const int fill = min(steps, kCStages);
  if (resident) {
    // all R tiles' w in one pass: this thread's 16-byte segment (i / SEGS,
    // i % SEGS) of every tile, i = tid, tid + 128, ...
    constexpr int SEGS = BN * WES / 16;
    const int col0 = blockIdx.y * BN;
    for (int i = tid; i < L.chunk_k * SEGS; i += kCThreads) {
      const int k = i / SEGS, q = i % SEGS;
      const unsigned wd = smem_u + L.x_bytes + k * BN * WES + 16 * q;
      const char* src =
          reinterpret_cast<const char*>(w + (size_t)k * N + col0) + 16 * q;
      const int n = k < K ? (tw - col0) * WES - 16 * q : 0;
      for (int tile = 0; tile < steps; ++tile)
        stage16(wd + tile * L.chunk_k * BN * WES,
                src + (size_t)tile * tw * WES, n, w_align);
    }
    if (x_align > 1)
      col_stage<XT, WT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align,
                                smem_u, 0, 0, 0, false, true);
    cp_async_commit();
  } else {
    // fill the ring, a group a step: every w copy is issued before x's
    // masked loads (synchronous) wait for theirs
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      col_stage<XT, WT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align,
                                smem_u, p, pt, pk, true, x_align > 1);
      cp_async_commit();
      if (++pk == chunks) pk = 0, ++pt;
    }
  }
  if (x_align == 1)
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      col_stage<XT, WT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align,
                                smem_u, p, pt, pk, false, true);
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
    const WT* wt = reinterpret_cast<const WT*>(smem + L.x_bytes) +
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
      col_stage<XT, WT, BM, BN>(x, w, M, K, N, reuse, x_align, w_align,
                                smem_u, s + kCStages, rt, rk, true, true);
      cp_async_commit();
      if (++rk == chunks) rk = 0, ++rt;
    }
  }
}

// col_matmul: x f32 or bf16, w f32, the N columns in R tiles of tw = N / R.
template <typename XT, int TM, int TN>
__global__ void __launch_bounds__(kCThreads, 1)
col_matmul_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                  XT* __restrict__ out, int M, int K, int N, int reuse,
                  int x_align, int w_align, int out_vec) {
  tiled_matmul<XT, float, TM, TN>(x, w, out, M, K, N, reuse, x_align,
                                  w_align, out_vec);
}

// reuse_matmul: x and w both T (f32 or bf16), launched with reuse = 1 (one
// tile of all N columns over all of K): its R passes add in k order.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kCThreads, 1)
reuse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int M, int K, int N, int reuse,
                    int x_align, int w_align, int out_vec) {
  tiled_matmul<T, T, TM, TN>(x, w, out, M, K, N, reuse, x_align, w_align,
                             out_vec);
}

// The SMs of the current device (132 on an H100 SXM).
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

// The thread tile of a launch at tw output columns a group (index into
// kColTiles): the first, most outputs a thread, whose grid fills 90 % of
// the SMs, else the last.
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

// Does the kernel take the shape?  R divides N (col_matmul) or K
// (reuse_matmul).
bool shape_ok(bool reuse_k, int M, int K, int N, int reuse) {
  return M >= 1 && K >= 0 && N >= 1 && reuse >= 1 &&
         (reuse_k ? K : N) % reuse == 0;
}

// The column tiles a launch walks: col_matmul's R; reuse_matmul's one (R
// names its K passes only).
int tiles_of(bool reuse_k, int reuse) { return reuse_k ? 1 : reuse; }

// The launch at (M, K, N, reuse), x of es bytes and w of wes: rows and
// columns a CTA, grid x and y, threads a CTA, ring slots and dynamic shared
// bytes, into layout[0..6].  0, or cudaErrorInvalidValue where the kernel
// refuses the shape.
int tiled_layout(bool reuse_k, int M, int K, int N, int reuse, int es,
                 int wes, int* layout) {
  if (!shape_ok(reuse_k, M, K, N, reuse)) return (int)cudaErrorInvalidValue;
  const int tiles = tiles_of(reuse_k, reuse), tw = N / tiles;
  const int c = col_config(M, tw);
  const int bm = 16 * kColTiles[c][0], bn = 8 * kColTiles[c][1];
  const int chunks = K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1;
  const ColSmem L = col_smem(K, tiles * chunks, es, wes, bm, bn);
  const int v[7] = {bm, bn, (M + bm - 1) / bm, (tw + bn - 1) / bn,
                    kCThreads, L.slots, L.bytes};
  for (int i = 0; i < 7; ++i) layout[i] = v[i];
  return v[3] > 65535 ? (int)cudaErrorInvalidValue : 0;
}

template <bool REUSE_K, typename XT, typename WT, int TM, int TN>
int run_tiled(const void* x, const void* w, void* out, int M, int K, int N,
              int tiles, int xa, int wa, int ov, cudaStream_t s) {
  constexpr int BM = 16 * TM, BN = 8 * TN;
  const int chunks = K > kCChunk ? (K + kCChunk - 1) / kCChunk : 1;
  const size_t smem =
      col_smem(K, tiles * chunks, sizeof(XT), sizeof(WT), BM, BN).bytes;
  const dim3 grid((M + BM - 1) / BM, (N / tiles + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const XT* xp = static_cast<const XT*>(x);
  XT* op = static_cast<XT*>(out);
  if constexpr (REUSE_K) {
    auto kernel = reuse_matmul_kernel<XT, TM, TN>;
    const int e = set_smem(kernel, smem);
    if (e) return e;
    kernel<<<grid, kCThreads, smem, s>>>(xp, static_cast<const XT*>(w), op,
                                         M, K, N, tiles, xa, wa, ov);
  } else {
    auto kernel = col_matmul_kernel<XT, TM, TN>;
    const int e = set_smem(kernel, smem);
    if (e) return e;
    kernel<<<grid, kCThreads, smem, s>>>(xp, static_cast<const float*>(w),
                                         op, M, K, N, tiles, xa, wa, ov);
  }
  return (int)cudaGetLastError();
}

// Launch col_matmul (REUSE_K false) or reuse_matmul (true) on the thread
// tile that col_config picks at the tile's width.
template <bool REUSE_K, typename XT, typename WT>
int launch_tiled(const void* x, const void* w, void* out, int M, int K,
                 int N, int reuse, void* stream) {
  if (!shape_ok(REUSE_K, M, K, N, reuse)) return (int)cudaErrorInvalidValue;
  constexpr int es = sizeof(XT), wes = sizeof(WT);
  const int tiles = tiles_of(REUSE_K, reuse), tw = N / tiles;
  const int xa = align_of(x, (long long)K * es, 0);
  const int wa = align_of(w, (long long)N * wes, (long long)tw * wes);
  // each thread's 4 columns start at a multiple of 4 of a row and a tile
  const int ov = N % 4 == 0 && tw % 4 == 0 &&
                 reinterpret_cast<unsigned long long>(out) % (4 * es) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (col_config(M, tw)) {
    case 0:
      return run_tiled<REUSE_K, XT, WT, 2, 4>(x, w, out, M, K, N, tiles, xa,
                                              wa, ov, s);
    case 1:
      return run_tiled<REUSE_K, XT, WT, 1, 4>(x, w, out, M, K, N, tiles, xa,
                                              wa, ov, s);
    case 2:
      return run_tiled<REUSE_K, XT, WT, 1, 2>(x, w, out, M, K, N, tiles, xa,
                                              wa, ov, s);
    default:
      return run_tiled<REUSE_K, XT, WT, 1, 1>(x, w, out, M, K, N, tiles, xa,
                                              wa, ov, s);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// The launch of col_matmul / reuse_matmul at (M, K, N, reuse) for f32
// operands: rows and columns a CTA, grid x and y, threads a CTA, ring slots
// and dynamic shared bytes, into layout[0..6].  0, or cudaErrorInvalidValue
// where the kernel refuses the shape.
int col_matmul_layout(int M, int K, int N, int reuse, int* layout) {
  return tiled_layout(false, M, K, N, reuse, 4, 4, layout);
}

int reuse_matmul_layout(int M, int K, int N, int reuse, int* layout) {
  return tiled_layout(true, M, K, N, reuse, 4, 4, layout);
}

int col_matmul(const void* x, int x_bf16, const float* w, void* out, int M,
               int K, int N, int reuse, void* stream) {
  if (x_bf16)
    return launch_tiled<false, __nv_bfloat16, float>(x, w, out, M, K, N,
                                                     reuse, stream);
  return launch_tiled<false, float, float>(x, w, out, M, K, N, reuse,
                                           stream);
}

int reuse_matmul(const void* x, const void* w, int bf16, void* out, int M,
                 int K, int N, int reuse, void* stream) {
  if (bf16)
    return launch_tiled<true, __nv_bfloat16, __nv_bfloat16>(
        x, w, out, M, K, N, reuse, stream);
  return launch_tiled<true, float, float>(x, w, out, M, K, N, reuse, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
