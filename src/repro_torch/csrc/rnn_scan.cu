// LSTM / GRU scan kernels for Hopper (sm_90a): the static and the pipeline
// schedules.
//
// Replaces six Pallas TPU kernels of the JAX package:
//   src/repro/kernels/lstm_scan.py  lstm_scan_pallas, lstm_scan_hoisted_pallas,
//                                   lstm_scan_pipeline_pallas
//   src/repro/kernels/gru_scan.py   gru_scan_pallas,  gru_scan_hoisted_pallas,
//                                   gru_scan_pipeline_pallas
//
// What they compute.  The final hidden state of a Keras LSTM (gates i|f|c|o,
// bias [4h]) or reset_after GRU (gates z|r|hh, bias [2, 3h]) over xs [B,T,in].
// The hoisted variants take zx = x W precomputed for every timestep (the GRU
// with b_in folded in) and carry only h U in the recurrence.
//
// Translation of the TPU grid.  The Pallas grid is (B/bt, T, R) with T and R
// sequential ("arbitrary"): the state lives in VMEM scratch across grid
// steps.  Here one thread block owns ROWS batch rows and keeps h (and c) in
// shared memory for the whole sequence; T and R become two loops inside the
// block: for t, for r in 0..R-1, tile r computes the gate pre-activation
// columns [r*gw, (r+1)*gw) into a shared z buffer, a __syncthreads()
// separates the tiles, and the gate update follows the last tile.  R keeps
// its meaning: R sequential column tiles per step, so only gw = G*h/R
// columns (one per thread) are in flight at a time.
//
// Pipeline kernels.  The TPU pipeline kernels (grid (B/bt, T) only) unroll
// the R column passes of h U inside one grid step over a fully resident U,
// so a step costs one pass, not R.  Here the same kernel template runs with
// PIPE set: the R tiles are issued together, one thread per gate column
// (G*h <= 512 for every tagger), with no barrier between tiles; a step
// costs one barrier after z and one after the gate update, where the
// hoisted kernel pays R + 1.  They take the hoisted kernels' inputs (zx
// precomputed) and compute the same function; R only names the tiles.
//
// Rows per block.  Chosen for the card, not from the schedule's block_batch:
// the smallest ROWS in {1, 2, 4, 8} that keeps the grid within one wave of
// SMs (B = 256 on 132 SMs gives ROWS = 2, 128 blocks).  block_batch only sets
// the granule the caller pads the batch to.  Rows past B are masked here.
//
// Weights.  U is not staged in shared memory: f32 U is 225 KiB for flavor
// tagging and 256 KiB for QuickDraw, at or above the 227 KiB a block may use.
// Each thread streams its own U (and W) column from device memory with
// coalesced loads across the warp; after the first step the 50 MB L2 holds
// every weight, so the per-step reads are L2 hits.
//
// What bounds it.  The work is small (QuickDraw LSTM at B = 256: 3.4 GFLOP,
// 51 us at the 67 TFLOP/s f32 peak; the bytes are < 1 MB besides the input)
// but it is a chain of T*R dependent steps (T for the pipeline kernels),
// each a block-wide barrier plus a pass over U from L2.  The per-step L2
// read of U by every block (G*h*h*4 bytes) is the throughput limit at this
// batch; the chain of dependent steps sets the latency.  The design keeps
// the state on chip, so a step costs one U pass and two barriers and
// nothing goes to device memory between steps; staging U across a block
// cluster's shared memory is left for a later change.
//
// Numerics (held to the TPU kernel): f32 FMA accumulation on CUDA cores (no
// tensor cores), LSTM pre-activation as (dot_x + dot_h) + b, GRU as
// zx = dot_x + b_in and zh = dot_h + b_rec, full-precision expf / tanhf (the
// library is built without --use_fast_math).  xs may be f32 or bf16; weights
// are f32; the output takes the type of xs (hoisted: the caller's choice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLSTM = 0;
constexpr int kGRU = 1;
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
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory floats per block; the host and the kernel carve the same
// layout: h [ROWS,h] | c [ROWS,h] (LSTM) | z [ROWS,G*h] (LSTM z, GRU zh) |
// zx [ROWS,G*h] (GRU in-loop) | x_t [ROWS,in] (in-loop).
template <int CELL, bool HOIST>
__host__ __device__ size_t smem_floats(int rows, int fin, int H) {
  const int G = CELL == kLSTM ? 4 : 3;
  size_t n = (size_t)rows * H;                         // h
  if (CELL == kLSTM) n += (size_t)rows * H;            // c
  n += (size_t)rows * G * H;                           // z / zh
  if (CELL == kGRU && !HOIST) n += (size_t)rows * G * H;  // zx
  if (!HOIST) n += (size_t)rows * fin;                 // x_t
  return n;
}

// in: xs [B,T,fin] (in-loop) or zx [B,T,G*h] f32 (hoisted).
// W [fin,G*h] (in-loop only), U [h,G*h], all f32 row-major.
// bias: LSTM [4h]; GRU in-loop [2,3h] (b_in ; b_rec); GRU hoisted b_rec [3h].
// out [B,h].
// PIPE (hoisted only): all R column tiles in one pass, no barrier between.
template <int CELL, bool HOIST, bool PIPE, typename XT, typename OT, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
rnn_scan_kernel(const XT* __restrict__ in, const float* __restrict__ W,
                const float* __restrict__ U, const float* __restrict__ bias,
                OT* __restrict__ out, int B, int T, int fin, int H,
                int reuse) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  const int GH = G * H;
  const int tiles = PIPE ? 1 : reuse;
  const int gw = GH / tiles;
  const int row0 = blockIdx.x * ROWS;

  extern __shared__ float smem[];
  float* h_s = smem;
  float* c_s = h_s + ROWS * H;
  float* z_s = c_s + (CELL == kLSTM ? ROWS * H : 0);
  float* zx_s = z_s + ROWS * GH;
  float* x_s = zx_s + (CELL == kGRU && !HOIST ? ROWS * GH : 0);

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    h_s[i] = 0.0f;
    if (CELL == kLSTM) c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (!HOIST) {
      for (int i = threadIdx.x; i < ROWS * fin; i += blockDim.x) {
        const int r = i / fin, k = i - r * fin, row = row0 + r;
        x_s[i] = row < B ? to_f32(in[((size_t)row * T + t) * fin + k]) : 0.0f;
      }
      __syncthreads();
    }

    // R sequential column tiles of the gate pre-activation (PIPE: together)
    for (int tile = 0; tile < tiles; ++tile) {
      const int n_end = (tile + 1) * gw;
      for (int n = tile * gw + threadIdx.x; n < n_end; n += blockDim.x) {
        float acc_h[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc_h[r] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float u = __ldg(&U[(size_t)k * GH + n]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc_h[r] = fmaf(h_s[r * H + k], u, acc_h[r]);
        }
        if (HOIST) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int row = row0 + r;
            if (CELL == kLSTM) {
              const float zx =
                  row < B ? to_f32(in[((size_t)row * T + t) * GH + n]) : 0.0f;
              z_s[r * GH + n] = (zx + acc_h[r]) + bias[n];
            } else {
              z_s[r * GH + n] = acc_h[r] + bias[n];
            }
          }
        } else {
          float acc_x[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc_x[r] = 0.0f;
          for (int k = 0; k < fin; ++k) {
            const float w = __ldg(&W[(size_t)k * GH + n]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc_x[r] = fmaf(x_s[r * fin + k], w, acc_x[r]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (CELL == kLSTM) {
              z_s[r * GH + n] = (acc_x[r] + acc_h[r]) + bias[n];
            } else {
              zx_s[r * GH + n] = acc_x[r] + bias[n];
              z_s[r * GH + n] = acc_h[r] + bias[GH + n];
            }
          }
        }
      }
      __syncthreads();
    }

    // gate update after the last tile
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      const float* z = z_s + r * GH;
      if (CELL == kLSTM) {
        const float ig = sigmoid(z[j]);
        const float fg = sigmoid(z[H + j]);
        const float gg = tanhf(z[2 * H + j]);
        const float og = sigmoid(z[3 * H + j]);
        const float c = fg * c_s[i] + ig * gg;
        c_s[i] = c;
        h_s[i] = og * tanhf(c);
      } else {
        float zx_z = 0.0f, zx_r = 0.0f, zx_h = 0.0f;
        if (HOIST) {
          const int row = row0 + r;
          if (row < B) {
            const XT* zx = in + ((size_t)row * T + t) * GH;
            zx_z = to_f32(zx[j]);
            zx_r = to_f32(zx[H + j]);
            zx_h = to_f32(zx[2 * H + j]);
          }
        } else {
          const float* zx = zx_s + r * GH;
          zx_z = zx[j];
          zx_r = zx[H + j];
          zx_h = zx[2 * H + j];
        }
        const float zg = sigmoid(zx_z + z[j]);
        const float rg = sigmoid(zx_r + z[H + j]);
        const float hh = tanhf(zx_h + rg * z[2 * H + j]);
        h_s[i] = zg * h_s[i] + (1.0f - zg) * hh;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H, row = row0 + r;
    if (row < B) store(&out[(size_t)row * H + j], h_s[i]);
  }
}

int rows_for(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = 1;
  while (rows < 8 && (B + rows - 1) / rows > sms) rows *= 2;
  return rows;
}

template <int CELL, bool HOIST, bool PIPE, typename XT, typename OT,
          int ROWS>
int run(const void* in, const float* W, const float* U, const float* bias,
        void* out, int B, int T, int fin, int H, int reuse, int threads,
        size_t smem, cudaStream_t stream) {
  auto kernel = rnn_scan_kernel<CELL, HOIST, PIPE, XT, OT, ROWS>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + ROWS - 1) / ROWS;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const XT*>(in), W, U, bias, static_cast<OT*>(out), B, T,
      fin, H, reuse);
  return (int)cudaGetLastError();
}

template <int CELL, bool HOIST, bool PIPE, typename XT, typename OT>
int launch(const void* in, const float* W, const float* U, const float* bias,
           void* out, int B, int T, int fin, int H, int reuse, void* stream) {
  const int GH = (CELL == kLSTM ? 4 : 3) * H;
  if (B < 1 || T < 0 || H < 1 || fin < 0 || reuse < 1 || GH % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int gw = PIPE ? GH : GH / reuse;  // columns in flight per pass
  int threads = ((gw + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const int rows = rows_for(B);
  const size_t smem = smem_floats<CELL, HOIST>(rows, fin, H) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1:
      return run<CELL, HOIST, PIPE, XT, OT, 1>(in, W, U, bias, out, B, T, fin,
                                               H, reuse, threads, smem, s);
    case 2:
      return run<CELL, HOIST, PIPE, XT, OT, 2>(in, W, U, bias, out, B, T, fin,
                                               H, reuse, threads, smem, s);
    case 4:
      return run<CELL, HOIST, PIPE, XT, OT, 4>(in, W, U, bias, out, B, T, fin,
                                               H, reuse, threads, smem, s);
    default:
      return run<CELL, HOIST, PIPE, XT, OT, 8>(in, W, U, bias, out, B, T, fin,
                                               H, reuse, threads, smem, s);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

int lstm_scan(const void* xs, int xs_bf16, const float* W, const float* U,
              const float* b, void* out, int B, int T, int fin, int H,
              int reuse, void* stream) {
  if (xs_bf16)
    return launch<kLSTM, false, false, __nv_bfloat16, __nv_bfloat16>(
        xs, W, U, b, out, B, T, fin, H, reuse, stream);
  return launch<kLSTM, false, false, float, float>(xs, W, U, b, out, B, T,
                                                   fin, H, reuse, stream);
}

int lstm_scan_hoisted(const float* zx, const float* U, const float* b,
                      void* out, int out_bf16, int B, int T, int H, int reuse,
                      void* stream) {
  if (out_bf16)
    return launch<kLSTM, true, false, float, __nv_bfloat16>(
        zx, nullptr, U, b, out, B, T, 0, H, reuse, stream);
  return launch<kLSTM, true, false, float, float>(zx, nullptr, U, b, out, B,
                                                  T, 0, H, reuse, stream);
}

int gru_scan(const void* xs, int xs_bf16, const float* W, const float* U,
             const float* b, void* out, int B, int T, int fin, int H,
             int reuse, void* stream) {
  if (xs_bf16)
    return launch<kGRU, false, false, __nv_bfloat16, __nv_bfloat16>(
        xs, W, U, b, out, B, T, fin, H, reuse, stream);
  return launch<kGRU, false, false, float, float>(xs, W, U, b, out, B, T,
                                                  fin, H, reuse, stream);
}

int gru_scan_hoisted(const float* zx, const float* U, const float* b_rec,
                     void* out, int out_bf16, int B, int T, int H, int reuse,
                     void* stream) {
  if (out_bf16)
    return launch<kGRU, true, false, float, __nv_bfloat16>(
        zx, nullptr, U, b_rec, out, B, T, 0, H, reuse, stream);
  return launch<kGRU, true, false, float, float>(zx, nullptr, U, b_rec, out,
                                                 B, T, 0, H, reuse, stream);
}

int lstm_scan_pipeline(const float* zx, const float* U, const float* b,
                       void* out, int out_bf16, int B, int T, int H, int reuse,
                       void* stream) {
  if (out_bf16)
    return launch<kLSTM, true, true, float, __nv_bfloat16>(
        zx, nullptr, U, b, out, B, T, 0, H, reuse, stream);
  return launch<kLSTM, true, true, float, float>(zx, nullptr, U, b, out, B, T,
                                                 0, H, reuse, stream);
}

int gru_scan_pipeline(const float* zx, const float* U, const float* b_rec,
                      void* out, int out_bf16, int B, int T, int H, int reuse,
                      void* stream) {
  if (out_bf16)
    return launch<kGRU, true, true, float, __nv_bfloat16>(
        zx, nullptr, U, b_rec, out, B, T, 0, H, reuse, stream);
  return launch<kGRU, true, true, float, float>(zx, nullptr, U, b_rec, out, B,
                                                T, 0, H, reuse, stream);
}

// Rows of the batch each thread block carries for a batch of B rows.
int scan_rows_per_block(int B) { return rows_for(B); }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
