// Staging tiles into shared memory for Hopper (sm_90a): cp.async with zero
// fill, or masked byte loads at ragged layouts.  Shared by the tiled
// product kernels (quantized.cu, reuse_matmul.cu); each includes it into
// its own library.

#pragma once

#include <cuda_runtime.h>

namespace {

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Copy the first n bytes (n <= cp) of src into shared address dst and zero
// the rest of the cp bytes.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Wait until at most n (0..3) of this thread's newest cp.async groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void st_shared16(unsigned dst, unsigned a,
                                            unsigned b, unsigned c,
                                            unsigned d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_shared4(unsigned dst, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// One 16-byte segment of a staged tile into 16-byte-aligned shared address
// dst: the first n bytes at src (n <= 0: none), zeros after.  align (16, 4
// or 1) is what every segment's source address is aligned to: one 16-byte
// cp.async, four 4-byte ones, or masked byte loads at a ragged layout.  A
// segment of no byte is a plain shared store of zeros.
__device__ __forceinline__ void stage16(unsigned dst, const char* src, int n,
                                        int align) {
  if (n <= 0) {
    st_shared16(dst, 0u, 0u, 0u, 0u);
  } else if (align == 16) {
    cp_async16(dst, src, n < 16 ? n : 16);
  } else if (align == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nj = n - 4 * j;
      if (nj > 0)
        cp_async4(dst + 4 * j, src + 4 * j, nj < 4 ? nj : 4);
      else
        st_shared4(dst + 4 * j, 0u);
    }
  } else {
    unsigned v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * j + b < n)
          word |= (unsigned)(unsigned char)__ldg(src + 4 * j + b) << (8 * b);
      v[j] = word;
    }
    st_shared16(dst, v[0], v[1], v[2], v[3]);
  }
}

// The staging granule of an operand: 16, 4 or 1, the largest that divides
// its address, its row stride and its tile offsets (all in bytes).
int align_of(const void* p, long long row_bytes, long long tile_bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  const auto divides = [&](unsigned g) {
    return a % g == 0 && row_bytes % g == 0 && tile_bytes % g == 0;
  };
  return divides(16) ? 16 : (divides(4) ? 4 : 1);
}

}  // namespace
