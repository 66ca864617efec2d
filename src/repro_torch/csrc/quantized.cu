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
// output columns are split into R tiles of N/R columns that run one after
// another inside a block, as in the TPU kernel; a tile never splits the K
// reduction, so every output is the full-K integer dot product.
//
// Translation of the TPU grid.  The TPU grid walks M in row blocks with the
// whole [K,N] weight resident in VMEM.  Here one thread block owns ROWS rows
// (1-8, from the SM count) and stages the WHOLE weight in shared memory:
// int8 weights are a quarter of the f32 bytes, so every tagger's weight
// fits a block (QuickDraw LSTM's U, 128 x 512, is 64 KiB of the 227 KiB).
// The weight is staged K-interleaved: word (q, n) holds w[4q..4q+3, n], so
// one __dp4a multiplies four K-adjacent pairs and adds them to an int32
// accumulator; K is zero-padded to a multiple of 4 (exact).  The block's x
// rows are staged the same way, then one thread per column of the current
// tile walks K/4 words.  int4 weights arrive unpacked to int8 (the wrapper
// runs unpack_ints); unpacking nibbles here, and tensor cores (mma.sync /
// wgmma s8), are later work.
//
// What bounds it.  At the shapes of the port (M = 256 rows, K <= 128,
// N <= 512) one product is 2*256*128*512 = 33.6 MOP, 0.017 us at the 1979
// TOP/s int8 tensor-core peak, and 0.13 MB, 0.04 us at 3.35 TB/s: bound by
// bytes.  On the device the kernel is bound by staging the weight into
// every block (each block reads all K*N bytes from L2) and by the K/4
// dependent dp4a chain of each thread; called from Python, the host's
// launch path costs more than either.
//
// fixed_point.  out = quantize(x, fp) elementwise over f32 or bf16 (output
// in the input's dtype): y = x * scale; rnd: round-half-even (rintf), trn:
// floor; sat: clip to the integer rails [lo, hi], wrap: floored modulo
// (y - lo) mod 2^W + lo; then y / scale.  Bitwise equal to the reference
// quantizers: every step is an explicit IEEE round-to-nearest intrinsic, so
// nvcc cannot contract a multiply and an add into an FMA, and NaN passes
// the clip as it does through jnp.clip / torch.clamp.  Bound by bytes (one
// read and one write per element); one thread per element, grid-stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Four int8 values (k0..k3 in the low to high byte) as one dp4a word.
__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c,
                                     int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

// x [M,K] int8, w [K,N] int8, out [M,N] int32; k4 = ceil(K / 4).
template <int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
quant_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w, int32_t* __restrict__ out,
                    int M, int K, int N, int reuse) {
  extern __shared__ int smem[];
  const int k4 = (K + 3) / 4;
  int* w_s = smem;               // [k4, N]: w[4q..4q+3, n] in word (q, n)
  int* x_s = smem + k4 * N;      // [ROWS, k4]
  const int row0 = blockIdx.x * ROWS;

  for (int i = threadIdx.x; i < k4 * N; i += blockDim.x) {
    const int q = i / N, n = i - q * N, k = 4 * q;
    int8_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = k + j < K ? w[(size_t)(k + j) * N + n] : (int8_t)0;
    w_s[i] = pack4(v[0], v[1], v[2], v[3]);
  }
  for (int i = threadIdx.x; i < ROWS * k4; i += blockDim.x) {
    const int r = i / k4, k = 4 * (i - r * k4), row = row0 + r;
    int8_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = row < M && k + j < K ? x[(size_t)row * K + k + j] : (int8_t)0;
    x_s[i] = pack4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int tw = N / reuse;
  for (int tile = 0; tile < reuse; ++tile) {  // R sequential column tiles
    const int n_end = (tile + 1) * tw;
    for (int n = tile * tw + threadIdx.x; n < n_end; n += blockDim.x) {
      int acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0;
#pragma unroll 4
      for (int q = 0; q < k4; ++q) {
        const int wv = w_s[q * N + n];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = __dp4a(x_s[r * k4 + q], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (row0 + r < M) out[(size_t)(row0 + r) * N + n] = acc[r];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fixed_point_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, long long n,
                                   float scale, float lo, float hi, int rnd,
                                   int sat, float span) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float y = __fmul_rn(to_f32(x[i]), scale);
    y = rnd ? rintf(y) : floorf(y);
    if (sat) {
      y = y < lo ? lo : (y > hi ? hi : y);
    } else {
      float m = fmodf(__fsub_rn(y, lo), span);  // exact; sign of dividend
      if (m < 0.0f) m = __fadd_rn(m, span);  // floored, as jnp.mod
      y = __fadd_rn(m, lo);
    }
    store(&out[i], __fdiv_rn(y, scale));
  }
}

// Rows per block: the smallest of 1, 2, 4, 8 that keeps the row tiles within
// one wave of SMs, else 8 (more rows share each staged weight).
int rows_for(int M) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = 1;
  while (rows < 8 && (M + rows - 1) / rows > sms) rows *= 2;
  return rows;
}

int threads_for(int cols) {
  const int t = ((cols + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : (t < 32 ? 32 : t);
}

template <int ROWS>
int run_quant(const int8_t* x, const int8_t* w, int32_t* out, int M, int K,
              int N, int reuse, cudaStream_t s) {
  auto kernel = quant_matmul_kernel<ROWS>;
  const size_t k4 = (size_t)(K + 3) / 4;
  const size_t smem = (k4 * N + ROWS * k4) * sizeof(int);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // at least 256 threads stage the weight; only N/R compute at a time
  const int threads = threads_for(N / reuse < 256 ? 256 : N / reuse);
  kernel<<<(M + ROWS - 1) / ROWS, threads, smem, s>>>(
      x, w, out, M, K, N, reuse);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

int quant_matmul(const void* x, const void* w, void* out, int M, int K,
                 int N, int reuse, void* stream) {
  if (M < 1 || K < 1 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  auto xi = static_cast<const int8_t*>(x);
  auto wi = static_cast<const int8_t*>(w);
  auto o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_for(M)) {
    case 1: return run_quant<1>(xi, wi, o, M, K, N, reuse, s);
    case 2: return run_quant<2>(xi, wi, o, M, K, N, reuse, s);
    case 4: return run_quant<4>(xi, wi, o, M, K, N, reuse, s);
    default: return run_quant<8>(xi, wi, o, M, K, N, reuse, s);
  }
}

int fixed_point(const void* x, int bf16, void* out, long long n, float scale,
                float lo, float hi, int rnd, int sat, float span,
                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 waves
  if (bf16)
    fixed_point_kernel<__nv_bfloat16><<<(int)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n, scale, lo, hi, rnd, sat, span);
  else
    fixed_point_kernel<float><<<(int)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, scale, lo,
        hi, rnd, sat, span);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
