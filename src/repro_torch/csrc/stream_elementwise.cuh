// One streaming body for the elementwise kernels (sm_90a): fixed_point
// (quantized.cu) and hadamard (hadamard.cu).
//
// Each kernel reads every element of one or two inputs once and writes one
// output element, so it is bound by bytes over device memory: it has to
// keep enough bytes in flight (Little's law: 3.35 TB/s at about 0.7 us of
// latency asks for some 15-20 KB on each of the 132 SMs) and read memory
// in an order the DRAM serves well.  The body:
//
//   * Vectors.  A thread moves 16 bytes at a time (4 f32 or 8 bf16) and
//     issues kUnroll vectors of every input before it computes any of them
//     (at 256 threads a block and several blocks an SM, tens of KB of
//     loads in flight an SM).  Stores carry the streaming hint (__stcs,
//     st.global.cs): no output is read back.  Loads carry none: measured
//     on the H100, __ldcs and ld.global.nc.L1::no_allocate made calls that
//     find L2 cold up to 6 % slower.
//   * Edges.  The vectors are cut on the OUTPUT's 16-byte grid: a scalar
//     head (up to 15 bytes) runs up to the first 16-byte boundary of out,
//     a scalar tail takes what is left after the last whole vector, so any
//     n works and every element is done exactly once.  When an input sits
//     at another offset from that grid than out's, the inputs are read in
//     16-byte vectors assembled from 8-, 4- or 2-byte loads (G, the largest
//     granule every input's offset allows), so a misaligned view still
//     streams.
//   * Grid.  One block a pass of kPass = kThreads x kUnroll vectors, all
//     launched at once: the block scheduler hands the passes out in
//     address order as blocks finish, so the blocks in flight read one
//     compact window of memory, and the last wave waits on one pass at
//     most.  Measured against a persistent wave of blocks (the card's
//     occupancy x its SM count) that each walk a contiguous, equal share
//     or interleaved rounds, and against a TMA ring (cp.async.bulk into
//     shared memory, one persistent block an SM), this was the fastest
//     at every shape of PERF.md (the persistent shares were 5-10 % slower
//     at (16384, 4096) f32: DRAM serves scattered streams worse).
//
// An Op is a functor with `static constexpr int kInputs` (1 or 2) and a
// __device__ operator() over T (one element of each input -> the output
// element).  Each source defines its own __global__ kernel (its name is what
// a trace shows) that calls stream::body, and launches it through
// stream::dispatch.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace stream {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors of every input in flight a thread
constexpr long long kPass = (long long)kThreads * kUnroll;  // vectors a block

// Where the stream's vectors lie: `head` scalar elements, then `nv` vectors
// of 16 bytes, then the scalar tail up to `n`.
struct Span {
  long long head, nv, n;
};

template <typename T>
Span span_of(const void* out, long long n) {
  constexpr long long V = 16 / sizeof(T);
  const long long off = (long long)(reinterpret_cast<uintptr_t>(out) % 16);
  long long head = (16 - off) % 16 / (long long)sizeof(T);
  if (head > n) head = n;
  return {head, (n - head) / V, n};
}

// The largest load granule (16, 8, 4 or 2 bytes) that p's address allows.
inline int granule(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

// The largest granule that both p and q allow.
inline int granule(const void* p, const void* q) {
  const int g = granule(p), h = granule(q);
  return g < h ? g : h;
}

// 16 bytes from p, which is aligned to G bytes.
template <int G>
__device__ __forceinline__ uint4 load16(const char* p) {
  if constexpr (G == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (G == 8) {
    const uint2 lo = *reinterpret_cast<const uint2*>(p);
    const uint2 hi = *reinterpret_cast<const uint2*>(p + 8);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else if constexpr (G == 4) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    return make_uint4(q[0], q[1], q[2], q[3]);
  } else {
    static_assert(G == 2, "granules are 16, 8, 4 or 2 bytes");
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)q[2 * i] | ((unsigned)q[2 * i + 1] << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The op over one vector of each input (the vectors' bytes move through
// memcpy, which compiles to register moves: no type punning).
template <typename T, typename Op>
__device__ __forceinline__ uint4 apply16(const Op& op, uint4 a, uint4 b) {
  constexpr int V = 16 / sizeof(T);
  T x[V], y[V], o[V];
  memcpy(x, &a, 16);
  memcpy(y, &b, 16);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (Op::kInputs == 2)
      o[i] = op(x[i], y[i]);
    else
      o[i] = op(x[i]);
  }
  uint4 r;
  memcpy(&r, o, 16);
  return r;
}

// The op over element i, scalar (the head and the tail: under 16 bytes
// each, plain loads and stores).
template <typename T, typename Op>
__device__ __forceinline__ void apply1(const Op& op, const T* in0,
                                       const T* in1, T* out, long long i) {
  if constexpr (Op::kInputs == 2)
    out[i] = op(in0[i], in1[i]);
  else
    out[i] = op(in0[i]);
}

// The whole stream; G: the load granule of the inputs at the span's first
// vector.  Block k takes one pass, vectors [k * kPass, (k + 1) *
// kPass), thread t the vectors k * kPass + t + u * kThreads: kUnroll loads
// of every input in flight before any is computed.
template <typename T, int G, typename Op>
__device__ __forceinline__ void body(const T* __restrict__ in0,
                                     const T* __restrict__ in1,
                                     T* __restrict__ out, const Span& sp,
                                     const Op& op) {
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {
    const long long tail = sp.head + sp.nv * V;
    if (t < sp.head) apply1(op, in0, in1, out, t);
    if (t < sp.n - tail) apply1(op, in0, in1, out, tail + t);
  }
  const char* a = reinterpret_cast<const char*>(in0 + sp.head);
  const char* b = nullptr;
  if constexpr (Op::kInputs == 2)
    b = reinterpret_cast<const char*>(in1 + sp.head);
  uint4* o = reinterpret_cast<uint4*>(out + sp.head);
  const long long v0 = (long long)blockIdx.x * kPass + t;
  uint4 x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + u * kThreads;
    if (v < sp.nv) {
      x[u] = load16<G>(a + 16 * v);
      if constexpr (Op::kInputs == 2) y[u] = load16<G>(b + 16 * v);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + u * kThreads;
    if (v < sp.nv)
      __stcs(o + v, apply16<T>(op, x[u], Op::kInputs == 2 ? y[u] : x[u]));
  }
}

// Launch kernel(args...) over span sp: one block a pass (at least one
// block, for a head and tail with no vector between them).
template <typename K, typename... A>
int launch(K kernel, const Span& sp, cudaStream_t s, A... args) {
  const long long blocks = sp.nv > 0 ? (sp.nv + kPass - 1) / kPass : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

// L.template run<G>() for the load granule g (2-byte granules only for
// 2-byte elements).
template <typename T, typename L>
int dispatch(const L& l, int g) {
  switch (g) {
    case 16: return l.template run<16>();
    case 8: return l.template run<8>();
    case 4: return l.template run<4>();
    default:
      if constexpr (sizeof(T) == 2) return l.template run<2>();
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace stream
