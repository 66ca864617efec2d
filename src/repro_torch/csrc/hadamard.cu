// Hadamard product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hadamard.py  hadamard_pallas (_hadamard_kernel)
//                                    -> hadamard
//
// hadamard.  out = a * b elementwise, a, b and out all f32 or all bf16 (the
// op the paper added to hls4ml, Sec. 3).  Each output is the f32 product
// rounded once to the dtype: for bf16 the product of two bf16 values is
// exact in f32, so this is the correctly rounded bf16 product, the same
// bits as torch.mul and as the TPU kernel.
//
// Translation of the TPU grid.  The TPU kernel walks [N, M] in row blocks
// of up to 1024 rows held in VMEM, and its wrapper pads N to the block.
// Here the contiguous [N, M] is one flat array of n elements, walked by a
// grid-stride loop in 16-byte vectors (4 f32 or 8 bf16 per load) when all
// three pointers are 16-byte aligned, then a scalar tail; with any pointer
// off that alignment the whole array goes scalar.  Nothing is padded.
//
// What bounds it.  Bytes: 3 * n * itemsize (two inputs read once, one
// output written once) over 3.35 TB/s; one multiply per element is nothing
// beside that.  At (16384, 4096) f32 that is 805 MB, 0.240 ms.  Vector loads
// keep the number of memory instructions at a quarter (f32) or an eighth
// (bf16) of a scalar loop; the grid is capped at 32 blocks per SM and each
// thread strides over the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 x,
                                             __nv_bfloat16 y) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(x), __bfloat162float(y)));
}

// One 16-byte vector of products: 4 f32, or 8 bf16 (two per 32-bit word).
__device__ __forceinline__ float4 mul16(float4 x, float4 y) {
  return make_float4(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y),
                     __fmul_rn(x.z, y.z), __fmul_rn(x.w, y.w));
}
__device__ __forceinline__ unsigned int mul_pair(unsigned int x,
                                                 unsigned int y) {
  const unsigned short lo = __bfloat16_as_ushort(
      mul(__ushort_as_bfloat16((unsigned short)(x & 0xffffu)),
          __ushort_as_bfloat16((unsigned short)(y & 0xffffu))));
  const unsigned short hi = __bfloat16_as_ushort(
      mul(__ushort_as_bfloat16((unsigned short)(x >> 16)),
          __ushort_as_bfloat16((unsigned short)(y >> 16))));
  return (unsigned int)lo | ((unsigned int)hi << 16);
}
__device__ __forceinline__ uint4 mul16(uint4 x, uint4 y) {
  return make_uint4(mul_pair(x.x, y.x), mul_pair(x.y, y.y),
                    mul_pair(x.z, y.z), mul_pair(x.w, y.w));
}

// V16: the 16-byte vector type that carries T (float4 for f32, uint4 for
// bf16).
template <typename T, typename V16>
__global__ void __launch_bounds__(kThreads)
hadamard_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, long long n, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    const V16* a16 = reinterpret_cast<const V16*>(a);
    const V16* b16 = reinterpret_cast<const V16*>(b);
    V16* o16 = reinterpret_cast<V16*>(out);
    for (long long i = first; i < nv; i += stride)
      o16[i] = mul16(a16[i], b16[i]);
    done = nv * V;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = mul(a[i], b[i]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename V16>
int run(const void* a, const void* b, void* out, long long n,
        cudaStream_t s) {
  const int vec = aligned16(a) && aligned16(b) && aligned16(out);
  const long long work = vec ? n / (16 / sizeof(T)) + 1 : n;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 32LL * sms) blocks = 32LL * sms;  // grid-stride past that
  hadamard_kernel<T, V16><<<(int)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// bf16: 1 if a, b and out are bfloat16, 0 if float32; n elements each.
int hadamard(const void* a, const void* b, int bf16, void* out, long long n,
             void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16, uint4>(a, b, out, n, s);
  return run<float, float4>(a, b, out, n, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
