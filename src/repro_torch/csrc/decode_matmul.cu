// Single-step decode matmul for Hopper (sm_90a): split-K weight streaming.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_step.py:
//   decode_matmul_pallas  (_decode_mm_kernel)  -> decode_matmul
//
// What it computes.  out [M,N] = x [M,K] @ w [K,N], f32 accumulation, the
// output rounded once (RNE) to their dtype; x and w are both f32 or both
// bf16 (the TPU kernel takes no mixed pair either).  The N output columns
// are split into R tiles of ns = N/R columns that a block walks in order
// (the paper's reuse factor, unrolled in-block as on the TPU); the K
// reduction is never split by R.  On the decode path it carries every
// per-token projection of the dense decoder (fused q|k|v, o, fused
// gate|up, down; bf16, M = the engine's max_batch) and the gate products of
// rnn_decode_step (f32, M up to 256, K <= 128, N <= 512).
//
// What bounds it.  At gemma-2b's decode (M = 4, bf16) a weight element
// costs 8 f32 flop: about 13 TFLOP/s at the HBM rate, 20 % of the CUDA
// cores' FMA rate, so the bytes of w bound it (3.35 TB/s: 40 us for
// gate|up).  CUDA-core FMA is enough at M <= 8 and no tensor core is used:
// wgmma pads M to 64 (15/16 of its work wasted), and mma.sync m16n8k16
// would only pay where instruction issue is the limit.  What the card
// needs instead is enough bytes in flight from enough SMs at every shape
// and R, with a short tail.  The taggers' f32 shapes (M = 256, K <= 128)
// are a few microseconds of L2 traffic, bound by issue and latency.
//
// The design.
//  - A fixed K chunk, summed in chunk order.  K is cut into chunks of C
//    rows (kernels/decode_step.py chunk_rows: C depends on K, N and the
//    dtype, never on R, M or the grid).  Each output's chunk partial is one
//    f32 FMA chain in increasing k, and the partials are combined in
//    increasing chunk order (a left fold).  Neither order depends on R, on
//    the split count or on how many blocks or warps share K, so R = 1 and
//    R = 4 give the same bits by construction, and repeated calls give the
//    same bits.  No atomics.
//  - The grid (1D) is m tiles x column blocks x K splits.  A block carries
//    `rows` rows of x, `warps` warps that each own a segment of 32 * V
//    columns (V = 8 bf16 / 4 f32: one 16-byte piece a lane, so a warp reads
//    512 contiguous bytes of one row; V = 1 at ragged N / R), and a run of
//    `cps` chunks of K; it walks the R tiles in order over that run, chunk
//    by chunk.  The split count, the rows and the warps come from the
//    Python layout (decode_layout), chosen per call from M, K, N and R so
//    that the grid fills the card at every R.  This launcher refuses a
//    layout it cannot run.
//  - Short chains, many threads.  At decode shapes a warp often has an SM
//    (or a scheduler) to itself, and then every dependent instruction
//    costs its full latency: a first form that walked K one row at a time
//    spent far longer a row than its instructions or its bytes, so a
//    thread's serial work, R x C rows, is what C keeps short: 32 rows where w is small (<= 16 MiB: q|k|v, o, every tagger),
//    128 where the workspace would cost bytes (gate|up, down: 6 % of w);
//    K warps of a block take alternate chunks of its run.  A chunk runs in
//    groups of 8 rows (its last group may be short; no group spans two
//    chunks): per group one commit and one wait, the 8 pieces loaded ahead
//    of their FMAs.
//  - w streams through a ring of kDepth = 32 slots a thread in shared
//    memory (16 KiB a warp, four groups in flight): each lane copies its
//    own 16-byte piece of a row with cp.async and reads it back itself, so
//    the ring needs no barrier: cp.async.wait_group orders it.  The flat
//    sequence (tile, chunk, group) streams on across chunk and tile ends;
//    no __syncthreads() drains it.  (TMA bulk copies of a warp's 512-byte
//    row segments against an mbarrier, a second form, were slower: lane 0
//    issues every copy of the warp.)  At ragged N / R (V = 1) a lane
//    copies 4 bytes (f32) or loads 2 (bf16).
//  - x of the block's whole K run is staged once, in f32, [k][rows], before
//    the loop (at most 32 KiB), while the ring's first groups load.
//  - Combination in chunk order: with one chunk (K <= 32) each thread
//    rounds its sums into out directly.  Where one split covers K, the
//    block's K warps leave their chunk partials in shared memory and the
//    block folds them in chunk order and rounds once.  Both are one launch
//    a call.  Otherwise each chunk partial goes to an f32 workspace
//    [chunks, M, N] that the wrapper allocates, and a second small kernel
//    (decode_matmul_fold_kernel, a programmatic dependent launch) folds it
//    in chunk order over the whole card and rounds once: two launches a
//    call.  The layout says which (DecodeLayout.launches).
//  - Numerics: f32 FMA on CUDA cores, no tensor cores and no TF32; bf16
//    inputs widen exactly to f32.
//
// Measured times against cuBLAS and the bytes bound: PERF.md, from
// chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "tile_stage.cuh"

namespace {

constexpr int kDepth = 32;                  // ring slots a thread (power of 2)
constexpr int kGroup = 8;                   // rows a group: a commit, a wait
constexpr int kGroups = kDepth / kGroup;    // groups in flight
constexpr int kMaxThreads = 256;            // column warps x K warps
constexpr int kFoldThreads = 256;
constexpr int kMaxXBytes = 32 * 1024;       // staged x of a block's run
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One lane's piece of a w row (V elements of T) into its ring slot: one
// 16-byte or 4-byte cp.async, or (a bf16 column at V = 1) a plain 2-byte
// load and shared store, which the same lane reads back.
template <typename T, int V>
__device__ __forceinline__ void stage_piece(uint4* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) * V == 16) {
    cp_async16(d, src, 16);
  } else if constexpr (sizeof(T) * V == 4) {
    cp_async4(d, src, 4);
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

// A lane's staged 16-byte slot as V f32 values (V = 1: its first 4 or 2
// bytes).
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4 u, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = sizeof(T) == 4 ? __uint_as_float(u.x) : bf16_bits(u.x & 0xffffu);
  } else {
    static_assert(sizeof(T) * V == 16, "a piece is 16 bytes");
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

// x of one k for the block's MT rows, from the staged [k][MT] f32 block.
template <int MT>
__device__ __forceinline__ void load_x(const float* p, float (&out)[MT]) {
  if constexpr (MT == 1) {
    out[0] = p[0];
  } else if constexpr (MT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < MT; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
    }
  }
}

// V f32 values at p (16-byte aligned where V > 1).
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// V values rounded once to T at p (16 bytes, aligned, where V > 1).
template <int V>
__device__ __forceinline__ void store_out(float* p, const float (&v)[V]) {
  store_f32<V>(p, v);
}
template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    static_assert(V == 8, "a bf16 vector is 8 columns");
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// x [M,K], w [K,N], out [M,N] (T); ws [chunks, M, N] f32 (unused where
// one split covers K).  Block b: m tile b % m_tiles, then column block,
// then K split.  Warp w is column warp w % cw (a segment of 32 * V columns
// of every tile) and K warp w / cw (chunks kwi, kwi + kw, ... of the
// block's run); lane l owns columns colt .. colt+V-1.  Shared memory: the
// ring, kDepth slots of 16 bytes a thread ([slot][thread]) | x [run][MT]
// f32 | (one split) the chunk partials [R][chunks][MT][cw * 32 * V] f32.
template <typename T, int MT, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, float* __restrict__ ws, int M,
                     int K, int N, int reuse, int chunk, int cps, int cw,
                     int m_tiles, int col_blocks) {
  extern __shared__ uint4 smem[];
  const int nt = blockDim.x;
  const int kw = nt / (32 * cw);           // K warps
  const int warp = threadIdx.x >> 5;
  const int cwi = warp % cw, kwi = warp / cw;
  int b = blockIdx.x;
  const int mt = b % m_tiles;
  b /= m_tiles;
  const int cb = b % col_blocks;
  const int split = b / col_blocks;
  const int ns = N / reuse;
  const int bcols = cw * 32 * V;           // columns of a tile in the block
  const int lcol = (cwi * 32 + (threadIdx.x & 31)) * V;
  const int colt = cb * bcols + lcol;
  const bool live = colt < ns;
  const int m0 = mt * MT;
  const int k0 = split * cps * chunk;      // a multiple of chunk
  const int run = min(K - k0, cps * chunk);
  const int nch = (run + chunk - 1) / chunk;   // chunks of the run
  const int mine = nch > kwi ? (nch - kwi + kw - 1) / kw : 0;
  const bool single = chunk >= K;              // one chunk: out directly
  const bool local = !single && cps * chunk >= K;  // one split: fold here

  uint4* ring = smem + threadIdx.x;        // slot i at ring[i * nt]
  float* x_s = reinterpret_cast<float*>(smem + (size_t)kDepth * nt);
  float* part = x_s + ((MT * run + 3) & ~3);   // [reuse][nch][MT][bcols]

  // rows of chunk j (local index) of the run
  auto chunk_len = [&](int j) { return min(chunk, run - j * chunk); };
  // the chunk's partial of rows m0.. into out, the block's partials or ws
  auto flush = [&](float (&acc)[MT][V], int r, int c) {
    const size_t col = (size_t)r * ns + colt;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (single) {
        if (live && m0 + m < M)
          store_out<V>(out + (size_t)(m0 + m) * N + col, acc[m]);
      } else if (local) {
        store_f32<V>(part + (((size_t)r * nch + c) * MT + m) * bcols + lcol,
                     acc[m]);
      } else if (live && m0 + m < M) {
        store_f32<V>(ws + ((size_t)(k0 / chunk + c) * M + m0 + m) * N + col,
                     acc[m]);
      }
    }
  };
  // the sequence a thread walks: tile ir, its ij-th chunk, row ik; the
  // issue side runs ahead of the use through the ring
  int ir = 0, ij = 0, ik = 0;
  const T* ip = w + (size_t)(k0 + kwi * chunk) * N + colt;
  auto next_chunk = [&]() {
    ik = 0;
    if (++ij == mine) {
      ij = 0;
      ++ir;
    }
    ip = w + (size_t)(k0 + (kwi + ij * kw) * chunk) * N + (size_t)ir * ns +
         colt;
  };
  // a chunk in groups of kGroup rows (its last group may be short; no
  // group spans two chunks): a commit and a wait a group, its loads ahead
  // of its FMAs
  auto issue_group = [&](int g) {          // group g into slots of g % kGroups
    if (ir < reuse && ij < mine) {
      const int n_rows = min(kGroup, chunk_len(kwi + ij * kw) - ik);
      uint4* dst = ring + (g & (kGroups - 1)) * kGroup * nt;
      if (live && n_rows == kGroup) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          stage_piece<T, V>(dst + q * nt, ip + (size_t)q * N);
      } else if (live) {                   // a chunk's short last group
        for (int q = 0; q < n_rows; ++q)
          stage_piece<T, V>(dst + q * nt, ip + (size_t)q * N);
      }
      ip += (size_t)n_rows * N;
      ik += n_rows;
      if (ik == chunk_len(kwi + ij * kw)) next_chunk();
    }
    cp_async_commit();
  };
  for (int g = 0; g < kGroups - 1; ++g) issue_group(g);

  // x rows [k0, k0 + run) of the block's rows, while the ring loads
  for (int i = threadIdx.x; i < MT * run; i += nt) {
    const int m = i / run, kk = i - m * run, row = m0 + m;
    x_s[kk * MT + m] =
        row < M ? to_f32(x[(size_t)row * K + k0 + kk]) : 0.0f;
  }
  __syncthreads();

  int used = 0;                            // groups consumed
  for (int r = 0; r < reuse; ++r) {
    for (int j = 0; j < mine; ++j) {
      const int c = kwi + j * kw;          // chunk of the run
      const int rows = chunk_len(c);
      const float* xp = x_s + c * chunk * MT;
      float acc[MT][V];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = 0.0f;
      // the chunk's partial: one FMA chain an output, k increasing
      for (int k = 0; k < rows; k += kGroup) {
        issue_group(used + kGroups - 1);
        cp_async_wait<kGroups - 1>();      // group `used` has landed
        const uint4* src = ring + (used & (kGroups - 1)) * kGroup * nt;
        ++used;
        if (rows - k >= kGroup) {
          uint4 raw[kGroup];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) raw[q] = src[q * nt];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            float wv[V], xv[MT];
            unpack<T, V>(raw[q], wv);
            load_x<MT>(xp + (k + q) * MT, xv);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[m][v] = fmaf(xv[m], wv[v], acc[m][v]);
          }
        } else {                           // a chunk's short last group
          for (int q = k; q < rows; ++q) {
            float wv[V], xv[MT];
            unpack<T, V>(src[(q - k) * nt], wv);
            load_x<MT>(xp + q * MT, xv);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[m][v] = fmaf(xv[m], wv[v], acc[m][v]);
          }
        }
      }
      flush(acc, r, c);
    }
  }
  cp_async_wait<0>();
  if (!local) return;
  // one split: fold the chunk partials in chunk order and round once
  __syncthreads();
  const int outs = reuse * MT * bcols;
  for (int i = threadIdx.x; i < outs; i += nt) {
    const int r = i / (MT * bcols), rem = i - r * MT * bcols;
    const int m = rem / bcols, lc = rem - m * bcols;
    const int ct = cb * bcols + lc;
    if (m0 + m >= M || ct >= ns) continue;
    const float* p = part + ((size_t)r * nch * MT + m) * bcols + lc;
    float s = p[0];
    for (int c = 1; c < nch; ++c) s += p[(size_t)c * MT * bcols];
    float v[1] = {s};
    store_out<1>(out + (size_t)(m0 + m) * N + (size_t)r * ns + ct, v);
  }
}

// out = the chunk partials of ws [chunks, total] folded in chunk order,
// rounded once; an output a thread (neighbours read neighbouring floats),
// its partials loaded kBatch at a time (independent loads in flight), then
// added in order.  Launched as a programmatic dependent of the product: it
// may start while the product's last blocks run, and waits for them
// (griddepcontrol.wait) before it reads ws.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
decode_matmul_fold_kernel(const float* __restrict__ ws, T* __restrict__ out,
                          long long total, int chunks) {
  constexpr int kBatch = 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int c0 = 0; c0 < chunks; c0 += kBatch) {
    float p[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < chunks) p[j] = __ldcg(ws + (size_t)(c0 + j) * total + i);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < chunks) s = c0 + j == 0 ? p[j] : s + p[j];
  }
  float v[1] = {s};
  store_out<1>(out + i, v);
}

// The launch's derived shape, or false where the layout is one the kernel
// cannot run (kernels/decode_step.py decode_layout builds layouts that it
// can; chip_smoke.py checks that bad ones are refused).
struct Grid {
  int m_tiles, col_blocks, splits, chunks, threads;
  size_t smem;
  bool fold;                       // partials to ws and the fold kernel
};

bool derive(int M, int K, int N, int reuse, int elt, const void* w,
            const void* out, const void* ws, int vec, int rows, int chunk,
            int cps, int warps, int k_warps, Grid* g) {
  if (M < 1 || K < 1 || N < 1 || reuse < 1 || N % reuse) return false;
  const int ns = N / reuse;
  if (vec != 1 && vec != 16 / elt) return false;
  if (vec > 1 && (ns % vec || reinterpret_cast<std::uintptr_t>(w) % 16 ||
                  reinterpret_cast<std::uintptr_t>(out) % 16 ||
                  reinterpret_cast<std::uintptr_t>(ws) % 16))
    return false;
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8) return false;
  if (warps != 1 && warps != 2 && warps != 4) return false;
  if (k_warps != 1 && k_warps != 2 && k_warps != 4 && k_warps != 8)
    return false;
  if (warps * k_warps * 32 > kMaxThreads) return false;
  if (chunk < 1 || cps < 1) return false;
  const long long chunks = ((long long)K + chunk - 1) / chunk;
  // a split that does not cover K writes its partials to ws
  if (chunks > 1 && (long long)cps * chunk < K && ws == nullptr) return false;
  const long long run = (long long)cps * chunk < K ? (long long)cps * chunk
                                                  : K;
  const long long x_bytes = run * rows * 4;
  if (x_bytes > kMaxXBytes) return false;
  g->m_tiles = (M + rows - 1) / rows;
  const long long segs = ((long long)ns + 32LL * vec - 1) / (32LL * vec);
  g->col_blocks = (int)((segs + warps - 1) / warps);
  g->splits = (int)((chunks + cps - 1) / cps);
  g->chunks = (int)chunks;
  g->threads = 32 * warps * k_warps;
  // the ring (16 bytes a slot and thread), x, and (one split) the partials
  const long long nch = (run + chunk - 1) / chunk;
  const long long part = chunks > 1 && (long long)cps * chunk >= K
                             ? (long long)reuse * nch * rows * warps * 32 *
                                   vec * 4
                             : 0;
  g->smem = (size_t)kDepth * g->threads * 16 +
            (size_t)(x_bytes + 15) / 16 * 16 + part;
  g->fold = chunks > 1 && part == 0;
  const long long blocks =
      (long long)g->m_tiles * g->col_blocks * g->splits;
  return blocks <= INT_MAX && g->smem <= kMaxSmem;
}

template <typename T, int MT, int V>
int run(const void* x, const void* w, void* out, float* ws, int M, int K,
        int N, int reuse, int chunk, int cps, int warps, const Grid& g,
        cudaStream_t s) {
  auto kernel = decode_matmul_kernel<T, MT, V>;
  if (g.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = g.m_tiles * g.col_blocks * g.splits;
  kernel<<<blocks, g.threads, g.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), ws, M, K, N, reuse, chunk, cps, warps, g.m_tiles,
      g.col_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !g.fold) return (int)e;
  const long long total = (long long)M * N;
  const long long fold_blocks = (total + kFoldThreads - 1) / kFoldThreads;
  if (fold_blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)fold_blocks);
  cfg.blockDim = dim3(kFoldThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_matmul_fold_kernel<T>,
                         static_cast<const float*>(ws), static_cast<T*>(out),
                         total, g.chunks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int pick_rows(const void* x, const void* w, void* out, float* ws, int M,
              int K, int N, int reuse, int rows, int chunk, int cps,
              int warps, const Grid& g, cudaStream_t s) {
  switch (rows) {
    case 1: return run<T, 1, V>(x, w, out, ws, M, K, N, reuse, chunk, cps,
                                warps, g, s);
    case 2: return run<T, 2, V>(x, w, out, ws, M, K, N, reuse, chunk, cps,
                                warps, g, s);
    case 4: return run<T, 4, V>(x, w, out, ws, M, K, N, reuse, chunk, cps,
                                warps, g, s);
    default: return run<T, 8, V>(x, w, out, ws, M, K, N, reuse, chunk, cps,
                                 warps, g, s);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, float* ws, int M, int K,
           int N, int reuse, int vec, int rows, int chunk, int cps,
           int warps, int k_warps, void* stream) {
  Grid g;
  if (!derive(M, K, N, reuse, sizeof(T), w, out, ws, vec, rows, chunk, cps,
              warps, k_warps, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return pick_rows<T, kVec>(x, w, out, ws, M, K, N, reuse, rows, chunk,
                              cps, warps, g, s);
  return pick_rows<T, 1>(x, w, out, ws, M, K, N, reuse, rows, chunk, cps,
                         warps, g, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue, and no
// launch, for a layout it cannot run).
// ---------------------------------------------------------------------------

extern "C" {

// The layout (vec, rows, chunk, chunks a split, column warps, K warps)
// comes from kernels/decode_step.py decode_layout; ws is the [chunks, M,
// N] f32 workspace (null where one split covers K).
int decode_matmul(const void* x, const void* w, int bf16, void* out,
                  float* ws, int M, int K, int N, int reuse, int vec,
                  int rows, int chunk, int cps, int warps, int k_warps,
                  void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(x, w, out, ws, M, K, N, reuse, vec, rows,
                                 chunk, cps, warps, k_warps, stream);
  return launch<float>(x, w, out, ws, M, K, N, reuse, vec, rows, chunk, cps,
                       warps, k_warps, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
