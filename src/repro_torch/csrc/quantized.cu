// Fixed-point kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels:
//   src/repro/kernels/quantized.py    quant_matmul_pallas (_quant_mm_kernel)
//                                       -> quant_matmul
//   src/repro/kernels/fixed_point.py  fixed_point_pallas (_quant_kernel)
//                                       -> fixed_point
//
// quant_matmul.  out [M,N] int32 = x [M,K] int8 @ w [K,N] int8, exact.  The
// native int8/int4 datapath runs every gate product of a quantized scan on
// it (2 launches per timestep) and the quantized ops.reuse_matmul.  The N
// output columns are split into R tiles of N/R columns that a CTA walks in
// order, as the TPU kernel walks them in its block; a tile never splits the
// K reduction, so every output is the full-K integer dot product.
//
// What bounded the kernel's first form.  Every block staged the WHOLE K x N
// weight into shared memory with four byte loads a word at stride N, so at
// M = 256 each of 128 blocks re-read the 64 KiB weight from L2 (8 MiB of
// L2 reads for a 64 KiB operand), a weight over 227 KiB could not run at
// all, and one thread per column ran K/4 dependent __dp4a on CUDA cores.
//
// The tiled design.  A CTA of four warps owns 32 rows of x and 32 columns
// of every tile (grid: ceil(M/32) x ceil((N/R)/32), so M = 256 and N = 512
// give 128 CTAs, one wave), and walks its (tile, K chunk) steps in order:
// tile r = 0..R-1, each over K in chunks of 128.  Only the tiles a step
// needs are staged: x once (where K <= 512; [32][K] rows, or, at K <= 32
// with rows not 4-byte aligned, the tile's 32 K contiguous bytes), and each
// step's w chunk [128][32] in a ring of 4 slots, copied with 16-byte
// cp.async where rows are 16-byte aligned and 4-byte cp.async where they
// are 4-byte aligned (from the word boundary below a ragged tile's first
// column, read at its offset); masked byte loads only at other layouts.
// Rows and columns past the edges are zero (exact for integers).  Where
// every step fits the ring (K <= 128, R <= 4: all the taggers), every
// tile is staged in one pass, waited for once, and the tiles' products run
// two at a time with no barrier between them (at K <= 32 from one A
// fragment, loaded once); past that, a slot is
// restaged after its step, four steps in flight.  int8 mma.sync takes both
// operands K-contiguous: A words come straight from the x rows (16 bytes
// past a multiple of 32, so a warp's loads hit 32 banks), B words are
// gathered from 4 bytes of one w column (rows of 48 bytes: 2 words a
// bank).  Each warp multiplies a 16 x 16 block with
// mma.sync.m16n8k32.s32.s8.s8.s32 on the tensor cores, K zero-padded to 32
// in shared memory, the int32 sums in registers until the tile is stored.
// The A operand of flat x is gathered byte by byte too; its bytes past K
// belong to the next row and meet zero w rows, so they add nothing.
//
// What bounds it.  At the shapes of the port (M = 256, K <= 128, N <= 512)
// one product is 2*256*128*512 = 33.6 MOP, 0.017 us at the 1979 TOP/s int8
// tensor-core peak, and 0.13 MB, 0.04 us at 3.35 TB/s: bound by bytes, and
// on the device by latency: the launch, one L2 round trip for the staged
// tiles, and per tile a chain of shared loads, two mma and the stores
// (2.6 us at QuickDraw's h-side on an H100 SXM at 700 W, against 13.9 us
// for the first form).  Called from Python, the host's launch path costs
// more than the device.  int4 weights arrive unpacked to int8 (the wrapper
// runs unpack_ints once per scan call, outside the time loop).
//
// fixed_point.  out = quantize(x, fp) elementwise over f32 or bf16 (output
// in the input's dtype): y = x * 2^F; rnd: round-half-even (rintf), trn:
// floor; sat: clip to the integer rails [lo, hi], wrap: floored modulo
// (y - lo) mod 2^W + lo; then y * 2^-F.  Bitwise equal to the reference
// quantizers: every step is an explicit IEEE round-to-nearest intrinsic, so
// nvcc cannot contract a multiply and an add into an FMA.  After the clip
// or the wrap y is an integer no larger than 2^W in magnitude, so y * 2^-F
// is exact and gives the bits of the reference's y / 2^F; the floored
// modulo t - 2^W * floor(t * 2^-W) (t = y - lo) is exact at every step, and
// its exact result is an integer below 2^W, so it equals jnp.mod's /
// torch.remainder's.  NaN passes the clip (y < lo ? lo : y > hi ? hi : y),
// as through jnp.clip / torch.clamp, and +-inf saturate to the rails.  No
// flush of subnormals (no -ftz), as IEEE and torch on the CPU: a negative
// subnormal x truncates to -2^-F.  Bound by bytes (one read and one write
// per element): it runs on the streaming body of stream_elementwise.cuh
// (16-byte vectors, two of them in flight a thread, one block a pass,
// streaming stores); the first form read one element per thread an
// iteration and divided.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "stream_elementwise.cuh"
#include "tile_stage.cuh"

namespace {

// ---------------------------------------------------------------------------
// quant_matmul
// ---------------------------------------------------------------------------

constexpr int kQThreads = 128;         // four warps
constexpr int kQRows = 32;             // x rows a CTA: two m16 blocks
constexpr int kQCols = 32;             // columns of each tile a CTA
constexpr int kQChunk = 128;           // K bytes a step: four k32 mma steps
constexpr int kQStages = 4;            // steps in flight: a ring of w slots
constexpr int kQWRow = 48;             // bytes a shared w row (32 + 16 pad)
constexpr int kQXResident = 512;       // K up to which x is staged once

// Shared memory of a launch: x | a ring of w slots [chunk_rows][kQWRow].
// x is staged once, as rows [32][round_up(K, 32) + 16], where K <=
// kQXResident; else a [32][kQChunk + 16] slot a ring slot; or, flat, as
// the tile's contiguous 32 K bytes (and 32 bytes of slack), where K <= 32
// and its rows are not 4-byte aligned.  x rows 16 bytes past a multiple of
// 32 put a warp's A-fragment loads on 32 banks; w rows of 48 bytes put its
// B-fragment byte loads on 2 words a bank.
struct QuantSmem {
  int chunk_rows;   // rows of a w slot: min(K, kQChunk), rounded up to 32
  int x_row;        // bytes a shared x row (rows, not flat)
  bool x_resident;  // x staged once, in the first tile's steps
  int slots;        // ring slots: min(steps, kQStages)
  int x_bytes, bytes;
};

__host__ __device__ inline QuantSmem quant_smem(int K, int steps,
                                               bool x_flat) {
  QuantSmem q;
  q.chunk_rows = round_up(K < kQChunk ? K : kQChunk, 32);
  q.x_resident = K <= kQXResident;
  q.x_row = (q.x_resident ? round_up(K, 32) : kQChunk) + 16;
  q.slots = steps < kQStages ? steps : kQStages;
  q.x_bytes = x_flat ? round_up(kQRows * K, 16) + 32
                     : (q.x_resident ? 1 : q.slots) * kQRows * q.x_row;
  q.bytes = q.x_bytes + q.slots * q.chunk_rows * kQWRow;
  return q;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four bytes at stride `stride` as one word, the first in the low byte:
// K-consecutive bytes of a w column (stride kQWRow) or of a flat x row (1)
// as the K-contiguous word mma.sync's operands take.
__device__ __forceinline__ unsigned gather4(const unsigned char* p,
                                            int stride) {
  return (unsigned)p[0] | ((unsigned)p[stride] << 8) |
         ((unsigned)p[2 * stride] << 16) | ((unsigned)p[3 * stride] << 24);
}

// Stage step s = (tile, chunk kc) into ring slot s % kQStages: w rows
// [k0, k0 + 128) of the tile's columns [col0, col0 + 32) (each thread: the
// 16-byte segment (tid / 2, tid % 2) of every 64 rows; w_align 0: the
// 4-byte words from the columns' start rounded down, read at its offset
// c0 % 4 in the slot), and, with x, the
// chunk's x (resident: in the first tile's steps only; rows: each thread
// the segment (tid / 8, tid % 8) of every 16 rows).  Rows past K are zero,
// up to the mma's k32.
__device__ __forceinline__ void quant_stage(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
    int K, int N, int tw, const QuantSmem& L, int x_align, int w_align,
    unsigned smem, int s, int tile, int kc, bool w_part, bool x_part) {
  const int tid = threadIdx.x, slot = s & (kQStages - 1);
  const int row0 = blockIdx.x * kQRows, col0 = blockIdx.y * kQCols;
  const bool x_flat = x_align == 0;
  const int k0 = kc * kQChunk;
  const int rows = (min(K - k0, kQChunk) + 31) & ~31;
  if (w_part) {
    const unsigned wd = smem + L.x_bytes + slot * L.chunk_rows * kQWRow;
    const int c0 = tile * tw + col0;
    if (w_align == 0) {                // 4-byte words from c0 rounded down
      const int shift = c0 & 3;
      const char* wb = reinterpret_cast<const char*>(w + (size_t)k0 * N) +
                       c0 - shift;
      const int cols = tw - col0 + shift;
      for (int i = tid; i < rows * 3; i += kQThreads) {
        const int k = i / 3, q = i - 3 * k;
        stage16(wd + k * kQWRow + 16 * q, wb + (size_t)k * N + 16 * q,
                k0 + k < K ? cols - 16 * q : 0, 4);
      }
    } else {
      const char* wb = reinterpret_cast<const char*>(w + (size_t)k0 * N) + c0;
      const int cols = tw - col0;
      for (int k = tid >> 1, q = tid & 1; k < rows; k += kQThreads / 2)
        stage16(wd + k * kQWRow + 16 * q, wb + (size_t)k * N + 16 * q,
                k0 + k < K ? cols - 16 * q : 0, w_align);
    }
  }
  if (!x_part || (L.x_resident && tile != 0)) return;
  if (x_flat) {                        // the tile's 32 K contiguous bytes
    const char* xb = reinterpret_cast<const char*>(x + (size_t)row0 * K);
    const int span = min(M - row0, kQRows) * K;  // of x, from xb
    for (int i = tid; 16 * i < L.x_bytes; i += kQThreads)
      stage16(smem + 16 * i, xb + 16 * i, span - 16 * i, 16);
    return;
  }
  const int q = tid & 7;
  if (16 * q >= rows) return;
  const unsigned xd =
      smem + (L.x_resident ? k0 : slot * kQRows * L.x_row) + 16 * q;
  const char* xb = reinterpret_cast<const char*>(x + (size_t)row0 * K + k0);
  for (int r = tid >> 3; r < kQRows; r += kQThreads / 8)
    stage16(xd + r * L.x_row, xb + (size_t)r * K + 16 * q,
            row0 + r < M ? K - k0 - 16 * q : 0, x_align);
}

// x [M,K] int8, w [K,N] int8, out [M,N] int32; tile width tw = N / reuse.
// Grid: (ceil(M / 32), ceil(tw / 32)); x_align / w_align: stage16 granules
// (x_align 0: x flat; w_align 0: 4-byte words shifted, quant_stage);
// dynamic shared memory: quant_smem(...).bytes.
__global__ void __launch_bounds__(kQThreads, 1)
quant_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w, int32_t* __restrict__ out,
                    int M, int K, int N, int reuse, int x_align,
                    int w_align) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int mb = warp & 1, nh = warp >> 1;  // the warp's 16 rows, 16 columns
  const int tw = N / reuse;
  const int chunks = (K + kQChunk - 1) / kQChunk;
  const int steps = reuse * chunks;         // (tile, chunk), tiles in order
  const bool x_flat = x_align == 0;
  const QuantSmem L = quant_smem(K, steps, x_flat);
  const unsigned smem_u = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // every step's tiles staged up front (one chunk, R <= kQStages): one
  // group, one wait, one barrier
  const bool resident = chunks == 1 && steps <= kQStages;
  const int fill = min(steps, kQStages);
  if (resident) {
    // all R tiles' w in one pass: this thread's 16-byte segment (i / segs,
    // i % segs) of every tile, i = tid, tid + 128, ... (w_align 0: three
    // segments a row from each tile's columns rounded down to a word)
    const int segs = w_align == 0 ? 3 : 2, col0 = blockIdx.y * kQCols;
    for (int i = tid; i < L.chunk_rows * segs; i += kQThreads) {
      const int k = w_align == 0 ? i / 3 : i >> 1, q = i - segs * k;
      const unsigned wd = smem_u + L.x_bytes + k * kQWRow + 16 * q;
      const char* src = reinterpret_cast<const char*>(w) + (size_t)k * N +
                        col0 + 16 * q;
      for (int tile = 0, c0 = col0; tile < steps; ++tile, c0 += tw) {
        const int shift = w_align == 0 ? c0 & 3 : 0;
        stage16(wd + tile * L.chunk_rows * kQWRow,
                src + (size_t)tile * tw - shift,
                k < K ? tw - col0 + shift - 16 * q : 0,
                w_align == 0 ? 4 : w_align);
      }
    }
    if (x_align != 1)
      quant_stage(x, w, M, K, N, tw, L, x_align, w_align, smem_u, 0, 0, 0,
                  false, true);
    cp_async_commit();
  } else {
    // fill the ring, a group a step: every w copy is issued before x's
    // masked byte loads (synchronous) wait for theirs
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      quant_stage(x, w, M, K, N, tw, L, x_align, w_align, smem_u, p, pt, pk,
                  true, x_align != 1);
      cp_async_commit();
      if (++pk == chunks) pk = 0, ++pt;
    }
  }
  if (x_align == 1)
    for (int p = 0, pt = 0, pk = 0; p < fill; ++p) {
      quant_stage(x, w, M, K, N, tw, L, x_align, w_align, smem_u, p, pt, pk,
                  false, true);
      if (++pk == chunks) pk = 0, ++pt;
    }

  // this thread's output rows (g and g + 8 of its warp's 16) and which of
  // its columns of a tile lie inside it: the same in every tile
  const int row = blockIdx.x * kQRows + mb * 16 + g;
  const int col = blockIdx.y * kQCols + nh * 16 + 2 * t;  // of acc[0][0]
  bool inside[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) inside[j][e] = col + 8 * j + e < tw;

  // one chunk of the products of step s (ring slot `slot`, tile `tile`)
  // into acc: A from x (rows, or flat at K <= 32), B from the w slot
  // this thread's B column (g of its warp's first n8 block) in the w slot
  // of step s (a ragged tile's columns start `shift` bytes into the slot)
  const auto w_col = [&](int slot, int tile) {
    const int shift = w_align == 0 ? (tile * tw + blockIdx.y * kQCols) & 3 : 0;
    return smem + L.x_bytes + slot * L.chunk_rows * kQWRow + 4 * t * kQWRow +
           nh * 16 + g + shift;
  };
  // the products of one k32 step: A fragment a, B from w column wk
  const auto mma_k32 = [&](int (&acc)[2][4], const unsigned (&a)[4],
                           const unsigned char* wk) {
    mma_s8(acc[0], a[0], a[1], a[2], a[3], gather4(wk, kQWRow),
           gather4(wk + 16 * kQWRow, kQWRow));
    mma_s8(acc[1], a[0], a[1], a[2], a[3], gather4(wk + 8, kQWRow),
           gather4(wk + 8 + 16 * kQWRow, kQWRow));
  };
  // the A fragment of flat x (K <= 32: one k32 step, the same every tile)
  const auto flat_a = [&](unsigned (&a)[4]) {
    const unsigned char* xr = smem + (mb * 16 + g) * K + 4 * t;
    const unsigned char* xr8 = xr + 8 * K;                 // row g + 8
    a[0] = gather4(xr, 1), a[1] = gather4(xr8, 1);
    a[2] = gather4(xr + 16, 1), a[3] = gather4(xr8 + 16, 1);
  };
  const auto chunk_mma = [&](int (&acc)[2][4], int slot, int tile, int k0) {
    const unsigned char* wc = w_col(slot, tile);
    if (x_flat) {
      unsigned a[4];
      flat_a(a);
      mma_k32(acc, a, wc);
      return;
    }
    const unsigned* xa = reinterpret_cast<const unsigned*>(
        smem + (L.x_resident ? k0 : slot * kQRows * L.x_row) +
        (mb * 16 + g) * L.x_row);
    const unsigned* xa8 = xa + 2 * L.x_row;                // row g + 8
    const int ksteps = (min(K - k0, kQChunk) + 31) >> 5;
#pragma unroll
    for (int ks = 0; ks < kQChunk / 32; ++ks) {
      if (ks == ksteps) break;
      const int kw = ks * 8 + t;
      const unsigned a[4] = {xa[kw], xa8[kw], xa[kw + 4], xa8[kw + 4]};
      mma_k32(acc, a, wc + 32 * ks * kQWRow);
    }
  };
  // a tile's complete sums into out
  const auto store_tile = [&](const int (&acc)[2][4], int tile) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int32_t* o = out + (size_t)(row + 8 * h) * N + (size_t)tile * tw + col;
      if (row + 8 * h < M) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (inside[j][e]) o[8 * j + e] = acc[j][2 * h + e];
      }
    }
  };

  if (resident) {
    cp_async_wait<0>();
    __syncthreads();                     // every tile is in place
    // the tiles in order, two at a time: the second's products are issued
    // while the first's are in flight, then both are stored, in order; at
    // K <= 32 every tile takes the same A fragment, loaded once
    unsigned a[4] = {};
    if (K <= 32) {
      if (x_flat) {
        flat_a(a);
      } else {
        const unsigned* xa = reinterpret_cast<const unsigned*>(
            smem + (mb * 16 + g) * L.x_row) + t;
        a[0] = xa[0], a[1] = xa[2 * L.x_row];
        a[2] = xa[4], a[3] = xa[2 * L.x_row + 4];
      }
    }
    for (int s = 0; s < steps; s += 2) {
      int acc0[2][4] = {}, acc1[2][4] = {};
      if (K <= 32) {
        mma_k32(acc0, a, w_col(s, s));
        if (s + 1 < steps) mma_k32(acc1, a, w_col(s + 1, s + 1));
      } else {
        chunk_mma(acc0, s, s, 0);
        if (s + 1 < steps) chunk_mma(acc1, s + 1, s + 1, 0);
      }
      store_tile(acc0, s);
      if (s + 1 < steps) store_tile(acc1, s + 1);
    }
    return;
  }

  int acc[2][4];
  int tile = 0, kc = 0;                     // step s
  int rt = fill / chunks, rk = fill % chunks;  // step s + kQStages
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_upto(min(kQStages - 1, steps - 1 - s));
    __syncthreads();                     // step s's tiles are in place
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    }
    chunk_mma(acc, s & (kQStages - 1), tile, kc * kQChunk);
    if (++kc == chunks) {               // the tile's sums are complete
      store_tile(acc, tile);
      kc = 0, ++tile;
    }
    if (s + kQStages < steps) {          // restage this slot: step s + 4
      __syncthreads();
      quant_stage(x, w, M, K, N, tw, L, x_align, w_align, smem_u,
                  s + kQStages, rt, rk, true, true);
      cp_async_commit();
      if (++rk == chunks) rk = 0, ++rt;
    }
  }
}

// The quantizer over one element: every constant a power of two (scale =
// 2^F, span = 2^W; the C entry point refuses anything else).
struct FixedPoint {
  static constexpr int kInputs = 1;
  float scale, inv_scale, lo, hi, span, inv_span;
  int rnd, sat;

  __device__ __forceinline__ float operator()(float x) const {
    float y = __fmul_rn(x, scale);
    y = rnd ? rintf(y) : floorf(y);
    if (sat) {
      y = y < lo ? lo : (y > hi ? hi : y);
    } else {
      const float t = __fsub_rn(y, lo);
      y = __fadd_rn(
          __fsub_rn(t, __fmul_rn(span, floorf(__fmul_rn(t, inv_span)))), lo);
    }
    return __fmul_rn(y, inv_scale);
  }
  __device__ __forceinline__ __nv_bfloat16
  operator()(__nv_bfloat16 x) const {
    return __float2bfloat16_rn((*this)(__bfloat162float(x)));
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(stream::kThreads)
fixed_point_kernel(const T* __restrict__ x, T* __restrict__ out,
                   stream::Span sp, FixedPoint op) {
  stream::body<T, G>(x, static_cast<const T*>(nullptr), out, sp, op);
}

template <typename T>
struct FixedPointLaunch {
  const T* x;
  T* out;
  stream::Span sp;
  FixedPoint op;
  cudaStream_t s;

  template <int G>
  int run() const {
    return stream::launch(fixed_point_kernel<T, G>, sp, s, x, out, sp, op);
  }
};

template <typename T>
int run_fixed_point(const void* x, void* out, long long n,
                    const FixedPoint& op, cudaStream_t s) {
  const stream::Span sp = stream::span_of<T>(out, n);
  const FixedPointLaunch<T> l{static_cast<const T*>(x), static_cast<T*>(out),
                              sp, op, s};
  return stream::dispatch<T>(l, stream::granule(l.x + sp.head));
}

bool power_of_two(float v) {
  int e = 0;
  return v > 0.0f && std::frexp(v, &e) == 0.5f;
}

// x's staging granule (stage16), or 0 for the flat span: K <= 32, rows not
// 4-byte aligned, and x 16-byte aligned (a tile's span starts at 32 K
// bytes a row block).
int quant_x_align(const void* x, int K) {
  const int a = align_of(x, K, 0);
  return a == 1 && K <= 32 && align_of(x, 0, 0) == 16 ? 0 : a;
}

// w's staging granule (stage16), or 0 where only the tile offsets break
// 4-byte alignment (a ragged N / R): then every row of a tile's columns
// starts at the same offset in its 4-byte word, and 4-byte copies from the
// word boundary, read at that offset, replace masked byte loads.
int quant_w_align(const void* w, int N, int tw) {
  const int a = align_of(w, N, tw);
  return a == 1 && align_of(w, N, 0) >= 4 ? 0 : a;
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// The launch of quant_matmul at (M, K, N, reuse) for a 16-byte-aligned x:
// rows and columns a CTA, grid x and y, threads a CTA, ring slots and
// dynamic shared bytes, into layout[0..6].  0, or cudaErrorInvalidValue
// where quant_matmul refuses the shape.
int quant_matmul_layout(int M, int K, int N, int reuse, int* layout) {
  if (M < 1 || K < 1 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = N / reuse;
  const QuantSmem L = quant_smem(K, reuse * ((K + kQChunk - 1) / kQChunk),
                                 K <= 32 && K % 4 != 0);
  const int v[7] = {kQRows, kQCols, (M + kQRows - 1) / kQRows,
                    (tw + kQCols - 1) / kQCols, kQThreads, L.slots, L.bytes};
  for (int i = 0; i < 7; ++i) layout[i] = v[i];
  return v[3] > 65535 ? (int)cudaErrorInvalidValue : 0;
}

int quant_matmul(const void* x, const void* w, void* out, int M, int K,
                 int N, int reuse, void* stream) {
  if (M < 1 || K < 1 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = N / reuse;
  const int xa = quant_x_align(x, K);
  const QuantSmem L =
      quant_smem(K, reuse * ((K + kQChunk - 1) / kQChunk), xa == 0);
  const dim3 grid((M + kQRows - 1) / kQRows, (tw + kQCols - 1) / kQCols);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  quant_matmul_kernel<<<grid, kQThreads, L.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, K, N, reuse, xa, quant_w_align(w, N, tw));
  return (int)cudaGetLastError();
}

// scale = 2^F and span = 2^W (powers of two: the quantizer multiplies by
// their exact inverses), lo / hi the integer rails.
int fixed_point(const void* x, int bf16, void* out, long long n, float scale,
                float lo, float hi, int rnd, int sat, float span,
                void* stream) {
  if (n < 1 || !power_of_two(scale) || !power_of_two(span))
    return (int)cudaErrorInvalidValue;
  const FixedPoint op{scale, 1.0f / scale, lo, hi, span, 1.0f / span,
                      rnd, sat};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return run_fixed_point<__nv_bfloat16>(x, out, n, op, s);
  return run_fixed_point<float>(x, out, n, op, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
