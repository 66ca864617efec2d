// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan.py  rglru_scan_pallas (_rglru_kernel)
//                                      -> rglru_scan
//
// rglru_scan.  a, bx [B,T,W] (each f32 or bf16) -> out [B,T,W] in a's dtype:
// h_t = a_t * h_{t-1} + bx_t with an f32 state that starts at zero, every
// state written out.  Each (row, column) is an independent recurrence, so
// no tiling changes a value.
//
// Translation of the TPU grid.  The TPU grid is (B/bb, W/bw, T) with T
// innermost and sequential and the state in an f32 [bb, bw] VMEM scratch.
// Here one thread owns one (row, column) and carries its state in a
// register through a loop over T; the T axis is not a grid axis.  One thread
// block owns one (batch tile, width tile) of bb x bw: threadIdx.x walks the
// columns (loads and stores coalesced along W), threadIdx.y the rows, and a
// block of more than 1024 cells loops over its rows and columns.  The reuse
// factor keeps its TPU meaning: at R > 1 (serial = 1) one block per batch
// tile walks its width tiles one after another, as the TPU's "arbitrary"
// width axis does, so only bw columns of each row are in flight.  Ragged B
// and W are masked here; the wrapper pads nothing.
//
// Rounding.  Each step is __fadd_rn(__fmul_rn(a, h), bx): the product and
// the sum are rounded separately, as in the reference and the plain
// version, because nvcc would otherwise contract a * h + bx into one FMA and
// give other bits.
//
// What bounds it.  Elementwise: 3 * B*T*W * itemsize bytes (two inputs read
// once, one output written once) over 3.35 TB/s; 2 flops per element are
// nothing beside that.  At recurrentgemma-9b's width (B = 8, T = 2048,
// W = 4096, f32) that is 805 MB, 0.240 ms.  The design reaches for it by
// unrolling T by kUnroll with all loads of the group issued before the
// dependent chain, so each thread keeps 2 * kUnroll loads in flight.  Known
// weakness: occupancy.  At B = 8 and R = 1 the grid is 32 blocks of 1024
// threads (bb = 8, bw = 128), so 32 of the 132 SMs work; at R > 1 one block
// per batch tile walks all W / bw tiles, a single SM at B = 8.  Splitting T
// into chunks (a second pass carrying the chunk products) or spreading rows
// over more blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 8;

// Loads and stores.  bf16 moves as its raw 16 bits (widened to f32 by a
// shift, which is exact): with __nv_bfloat16 values in the unrolled arrays
// ptxas kept a stack frame and spilled.
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned int bits = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One (row, column) recurrence over T steps; base = row * T * W + col.
template <typename TA, typename TB>
__device__ __forceinline__ void recur(const TA* __restrict__ a,
                                      const TB* __restrict__ bx,
                                      TA* __restrict__ out, size_t base,
                                      int T, size_t W) {
  float h = 0.0f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)(t + u) * W;
      av[u] = load(a + i);
      bv[u] = load(bx + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);  // no FMA: see the header
      store(&out[base + (size_t)(t + u) * W], h);
    }
  }
  for (; t < T; ++t) {
    const size_t i = base + (size_t)t * W;
    h = __fadd_rn(__fmul_rn(load(a + i), h), load(bx + i));
    store(&out[i], h);
  }
}

// grid (width tiles, or 1 when serial; batch tiles); block (<= bw, <= bb).
template <typename TA, typename TB>
__global__ void __launch_bounds__(kMaxThreads)
rglru_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ bx,
                  TA* __restrict__ out, int B, int T, int W, int bb, int bw,
                  int serial) {
  const int row0 = blockIdx.y * bb;
  const int row_end = row0 + bb < B ? row0 + bb : B;
  const int n_tiles = (W + bw - 1) / bw;
  const int tile0 = serial ? 0 : blockIdx.x;
  const int tile_end = serial ? n_tiles : tile0 + 1;
  for (int tile = tile0; tile < tile_end; ++tile) {  // in order when serial
    const int col0 = tile * bw;
    const int col_end = col0 + bw < W ? col0 + bw : W;
    for (int row = row0 + threadIdx.y; row < row_end; row += blockDim.y)
      for (int col = col0 + threadIdx.x; col < col_end; col += blockDim.x)
        recur(a, bx, out, (size_t)row * T * W + col, T, (size_t)W);
  }
}

template <typename TA, typename TB>
int run(const void* a, const void* bx, void* out, int B, int T, int W,
        int bb, int bw, int serial, cudaStream_t s) {
  const int tx = bw < kMaxThreads ? bw : kMaxThreads;
  const int ry = kMaxThreads / tx;
  const dim3 block(tx, bb < ry ? bb : ry);
  const dim3 grid(serial ? 1 : (W + bw - 1) / bw, (B + bb - 1) / bb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<TA, TB><<<grid, block, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(bx),
      static_cast<TA*>(out), B, T, W, bb, bw, serial);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// a_bf16 / bx_bf16: 1 if that input is bfloat16, 0 if float32; out has a's
// dtype.  bb, bw: the batch and width tile; serial: walk the width tiles in
// order (R > 1).
int rglru_scan(const void* a, int a_bf16, const void* bx, int bx_bf16,
               void* out, int B, int T, int W, int bb, int bw, int serial,
               void* stream) {
  if (B < 1 || T < 1 || W < 1 || bb < 1 || bw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16 && bx_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(a, bx, out, B, T, W, bb, bw,
                                             serial, s);
  if (a_bf16)
    return run<__nv_bfloat16, float>(a, bx, out, B, T, W, bb, bw, serial, s);
  if (bx_bf16)
    return run<float, __nv_bfloat16>(a, bx, out, B, T, W, bb, bw, serial, s);
  return run<float, float>(a, bx, out, B, T, W, bb, bw, serial, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
