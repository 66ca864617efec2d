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
// Here the contiguous [N, M] is one flat array of n elements, streamed by
// the body of stream_elementwise.cuh: 16-byte vectors cut on out's 16-byte
// grid with a scalar head and tail, so any n and any offset of a, b or out
// works (with an operand off out's grid both are read in vectors assembled
// from 8-, 4- or 2-byte loads); nothing is padded.
//
// What bounds it.  Bytes: 3 * n * itemsize (two inputs read once, one
// output written once) over 3.35 TB/s; one multiply per element is nothing
// beside that.  At (16384, 4096) f32 that is 805 MB, 0.240 ms.  The first
// form kept one vector of each operand in flight a thread in a grid-stride
// loop of 32 blocks an SM, so at that shape half its threads ran a 16th
// pass while the rest idled; the streaming body keeps two of each in
// flight and runs one block a pass, in address order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stream_elementwise.cuh"

namespace {

// The f32 product, rounded once to the element type.
struct Mul {
  static constexpr int kInputs = 2;

  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fmul_rn(x, y);
  }
  __device__ __forceinline__ __nv_bfloat16
  operator()(__nv_bfloat16 x, __nv_bfloat16 y) const {
    return __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(x), __bfloat162float(y)));
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(stream::kThreads)
hadamard_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, stream::Span sp) {
  stream::body<T, G>(a, b, out, sp, Mul{});
}

template <typename T>
struct HadamardLaunch {
  const T* a;
  const T* b;
  T* out;
  stream::Span sp;
  cudaStream_t s;

  template <int G>
  int run() const {
    return stream::launch(hadamard_kernel<T, G>, sp, s, a, b, out, sp);
  }
};

template <typename T>
int run(const void* a, const void* b, void* out, long long n,
        cudaStream_t s) {
  const stream::Span sp = stream::span_of<T>(out, n);
  const HadamardLaunch<T> l{static_cast<const T*>(a),
                            static_cast<const T*>(b), static_cast<T*>(out),
                            sp, s};
  return stream::dispatch<T>(l, stream::granule(l.a + sp.head,
                                                l.b + sp.head));
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
  if (bf16) return run<__nv_bfloat16>(a, b, out, n, s);
  return run<float>(a, b, out, n, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
