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
// Translation of the TPU grid.  One thread block owns ROWS rows of x (the
// TPU's parallel M axis), staged in shared memory as f32.  col_matmul: one
// thread per column of a tile; the block walks the R tiles in order, so
// only N/R columns are in flight at a time.  reuse_matmul: one thread per
// output column (a second grid axis covers N past 512 columns); the block
// walks the R K-passes in order, staging pass r's K/R columns of x and
// reading the matching K/R rows of w.
//
// Weights.  No K x N/R weight tile is staged in shared memory: the h-side
// product of QuickDraw LSTM at R = 1 is 128 x 512 x 4 B = 256 KiB, over the
// 227 KiB a block may use.  Each thread streams its own w column from device
// memory (coalesced across the warp); across the 2T products of a scan the
// weights stay in the 50 MB L2.
//
// What bounds it.  At the shapes the port runs (M = 256 rows per step, K
// and N at most a few hundred) one product is well under a microsecond of
// work at the 67 TFLOP/s f32 peak (QuickDraw h-side: 2*256*128*512 FLOP,
// 0.5 us).  On the device a call is bound by the L2 latency of the K
// dependent loads of each w column (that product: 7.7 us on an H100 SXM
// at 700 W, PERF.md); called from Python, the host's launch path (25-45 us
// a call) costs more.  The design keeps one launch per product and all of
// x on chip; the pipeline kernels in rnn_scan.cu fuse a scan's products
// into one launch.
//
// Numerics: f32 FMA on CUDA cores, no tensor cores (TF32 would break the
// 3e-5 parity); bf16 inputs widen exactly to f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

// x [M,K] (XT), w [K,N] f32, out [M,N] (XT); tile width tw = N / reuse.
template <typename XT, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
col_matmul_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                  XT* __restrict__ out, int M, int K, int N, int reuse) {
  extern __shared__ float x_s[];  // [ROWS, K]
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K, row = row0 + r;
    x_s[i] = row < M ? to_f32(x[(size_t)row * K + k]) : 0.0f;
  }
  __syncthreads();

  const int tw = N / reuse;
  for (int tile = 0; tile < reuse; ++tile) {  // R sequential column tiles
    const int n_end = (tile + 1) * tw;
    for (int n = tile * tw + threadIdx.x; n < n_end; n += blockDim.x) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(&w[(size_t)k * N + n]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(x_s[r * K + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (row0 + r < M) store(&out[(size_t)(row0 + r) * N + n], acc[r]);
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

// Rows per block: the smallest of 1, 2, 4, 8 that keeps the row tiles within
// one wave of SMs, else 8 (more rows share each w load).
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

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename XT, int ROWS>
int run_col(const void* x, const float* w, void* out, int M, int K, int N,
            int reuse, cudaStream_t s) {
  auto kernel = col_matmul_kernel<XT, ROWS>;
  const size_t smem = (size_t)ROWS * K * sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<(M + ROWS - 1) / ROWS, threads_for(N / reuse), smem, s>>>(
      static_cast<const XT*>(x), w, static_cast<XT*>(out), M, K, N, reuse);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_col(const void* x, const float* w, void* out, int M, int K, int N,
               int reuse, void* stream) {
  if (M < 1 || K < 0 || N < 1 || reuse < 1 || N % reuse != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_for(M)) {
    case 1: return run_col<XT, 1>(x, w, out, M, K, N, reuse, s);
    case 2: return run_col<XT, 2>(x, w, out, M, K, N, reuse, s);
    case 4: return run_col<XT, 4>(x, w, out, M, K, N, reuse, s);
    default: return run_col<XT, 8>(x, w, out, M, K, N, reuse, s);
  }
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

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

int col_matmul(const void* x, int x_bf16, const float* w, void* out, int M,
               int K, int N, int reuse, void* stream) {
  if (x_bf16)
    return launch_col<__nv_bfloat16>(x, w, out, M, K, N, reuse, stream);
  return launch_col<float>(x, w, out, M, K, N, reuse, stream);
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
