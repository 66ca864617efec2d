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
// Two designs live here.
//
// 1. The in-loop static scans (lstm_scan, gru_scan), both hoisted scans
//    (lstm_scan_hoisted, gru_scan_hoisted) and both pipeline scans
//    (lstm_scan_pipeline, gru_scan_pipeline), each for H <= 128:
//    cluster_scan_kernel, a weight-stationary thread-block-cluster kernel.
//    - A cluster of C CTAs (C in {1, 2, 4, 8}) owns a tile of ROWS batch
//      rows (1 or 8: a cluster a row where the batch is small enough for
//      all CTAs to be resident, as at predict_one's B = 8).  CTA c owns the
//      hidden units [c*u, (c+1)*u), u = ceil(H/C), with all G gate columns
//      of each.  Each unit's h-side products are split over KS lanes (2 or
//      8, the fewest with KS*16 >= H): lane s holds U[k][unit's G columns]
//      for k = s, s+KS, ... (at most 16 rows) in registers, loaded once
//      before step 0.  So H <= 128 (16 lanes a unit would need more than
//      256 threads a CTA past that); repro's Pallas kernel takes any H, and
//      so does the wrapper: a larger H runs as col_matmul of every step's
//      input side and the hoisted kernel below (scan_layout.scan_route).
//      No step reads U from memory; W
//      and the biases of the CTA's units sit in its shared memory.  (U in
//      shared memory, one 16-byte U load a k step and thread, left the
//      loop bound by shared-memory load instructions, several times
//      slower.)
//    - Every CTA keeps the tile's full h, k-major ([k][ROWS], 8 rows padded
//      to 12 floats so that a warp's 16-byte h loads hit distinct banks,
//      one zero row for every k a lane walks past H) and double-buffered.
//      At step t a lane multiplies its k slice of h_t (buffer t&1) with its
//      U rows for all ROWS rows and G gates (at ROWS = 8, 32 FMAs per two
//      16-byte loads); a shuffle reduce-scatter over the unit's KS lanes
//      leaves lane s with the sums of rows (s % L) * ROWS/L .. (L =
//      min(KS, ROWS)); that lane adds the x side, does the gate update in
//      registers (the LSTM's c never leaves it) and stores its new h values
//      into buffer (t+1)&1 of every CTA of the cluster with st.async, which
//      counts the bytes against the receiving CTA's mbarrier for that
//      buffer.  Where KS > ROWS, the KS/ROWS lanes that hold the same sums
//      all update and share out the stores (one CTA each at ROWS = 1).
//    - The exchange needs no cluster barrier.  A CTA waits on its own
//      mbarrier until all of h_{t+1} has landed (one thread posts the byte
//      count each step; the phase parity follows the step).
//      Why that is enough: (a) the mbarrier phase completes only after
//      every st.async of the step has written (ROWS*H*4 bytes), and the
//      wait acquires at cluster scope, so h_{t+1} is complete and visible
//      when a CTA reads it; (b) a producer writes h_{t+2} into buffer t&1
//      only after its own wait for h_{t+1}, which needs every CTA's slice
//      of h_{t+1}, and every thread sends its slice only after its own
//      reads of h_t in buffer t&1: so no write overtakes a read of the
//      buffer it replaces, with two buffers.  (c) A remote st.async for a
//      phase can only come after the previous phase of that mbarrier
//      completed here, by the same chain.  A cluster.sync() before step 0
//      makes sure every CTA has started and initialised its mbarriers
//      before anyone stores into it;
//      after step T-1 each CTA waits for h_T to land and a last
//      cluster.sync() keeps every CTA alive until no store is in flight.
//      A cluster barrier a step (the design's first form) waits for every
//      thread of every CTA; the mbarrier wait waits only for the data.
//    - x: step t stores x_{t+2}, loaded into registers a step earlier,
//      into a 3-deep shared buffer after its products, and loads x_{t+3}
//      (plain loads: a bf16 row of 3 values starts on a 2-byte boundary,
//      below cp.async's 4-byte granule); the x side of step t is computed
//      before the wait for h_t, while h_t may still be in flight.  A
//      __syncthreads() a step orders the x buffers.
//    - The zx mode (template ZX): the same recurrence over precomputed
//      zx = x W (+ b_in for the GRU).  Step t reads the pre-activations
//      zx[b, t, .] of the CTA's units' G columns through the same 3-deep
//      shared buffer, staged two steps ahead with 4-byte cp.async (a
//      unit's gate columns are runs of f32; one commit group a step, a
//      wait_group before the step's __syncthreads()), in place of the
//      in-kernel x W; the rest of the step is unchanged: the LSTM forms
//      (zx + zh) + b and keeps c in registers, the GRU zx + (zh + b_rec).
//      The hoisted scans of both cells take it (<CELL, true, ...>), and so
//      do both pipeline scans (R tiles issued together): the ONE_PASS
//      instance at every R, R naming the tiles only, so a pipeline at any
//      R gives its cell's hoisted scan's R = 1 bits.  The layout comes
//      from kernels/scan_layout.py with hoisted=True (no x side; the
//      shared memory is one bias row [u][4] and the zx buffers
//      [3][rows][G][u]; the pipelines' is R = 1's).  Past H = 128 these
//      four run on design 2 (the *_block entry points): a route by shape,
//      as scan_route routes the in-loop scans.
//    - R keeps its meaning: at R > 1 a step runs R passes in order, pass p
//      computing the gate columns [p*gw, (p+1)*gw) (gw = G*H/R) of the
//      CTA's units (x side included), a __syncthreads() between passes, the
//      gate update after the last.  A lane updates the same rows and unit
//      in every pass, so the gates stay in registers across passes.
//    - The layout (C, rows, KS, threads, shared bytes) comes from the
//      Python wrapper (kernels/scan_layout.py), which picks the one that
//      runs in the fewest waves, then gives a CTA the least work; it counts
//      waves with cluster_scan_resident (cudaOccupancyMaxActiveClusters for
//      the kernel of that layout: an H100 holds 248 clusters of four
//      one-warp CTAs, so top tagging at B = 256 takes clusters of 2).  The
//      launcher refuses a layout that breaks the kernel's rules
//      (cudaErrorInvalidValue) or that the card cannot hold, and launches
//      with cudaLaunchKernelEx and a cluster dimension.  Rows past B are
//      masked.  There is no fallback to the other design.
//    - What bounds it on the H100.  Not L2 traffic any more: a step is a
//      chain of dependent phases, each short: the k loop (FMA issue and
//      h loads, 16 k steps a lane), the reduce-scatter (28 shuffles at
//      G = 4), the gate update, the DSMEM stores and the mbarrier wait for
//      the slowest CTA of the cluster.  At B = 256 two clusters share an
//      SM and hide part of each other's waits.  The f32 operations bound,
//      2*B*(in+H)*G*H FLOP a step over the H100 SXM's 67 TFLOP/s, is
//      0.5 us a QuickDraw step at B = 256; the kernel's step is several
//      times that, set by the chain above (times: PERF.md, chip_smoke.py).
//    - Numerics: f32 FMA on CUDA cores.  A pre-activation is KS chains over
//      interleaved k, summed in one tree whatever ROWS (reduce_scatter),
//      so every lane of a unit gets the same bits, and a batch row gets
//      the same bits at every B (predict_one's B = 8 and a flush's 256
//      take ROWS = 1 and 8).  3xTF32 on mma.sync was not taken: a CTA's
//      step is at most 8 rows against 16 units' G columns, one mma tile, and
//      splitting h into big and small parts every step costs about what
//      the tensor cores save; plain TF32 does not hold the f32 tolerance
//      over 100 steps.
//
// 2. The hoisted and pipeline scans past H = 128 (the *_block entry
//    points), and only there: rnn_scan_kernel, one thread block per ROWS
//    batch rows.
//    - Translation of the TPU grid.  The Pallas grid is (B/bt, T, R) with T
//      and R sequential: the state lives in VMEM scratch across grid steps.
//      Here one block keeps h (and c) in shared memory for the whole
//      sequence; for t, for r in 0..R-1, tile r computes the gate columns
//      [r*gw, (r+1)*gw) into a shared z buffer, a __syncthreads()
//      separates the tiles, and the gate update follows the last tile.
//    - Pipeline kernels.  The TPU pipeline kernels unroll the R column
//      passes inside one grid step over a resident U, so a step costs one
//      pass.  Here the same template runs with PIPE set: the R tiles are
//      issued together, one thread per gate column (G*h <= 512 for every
//      tagger), with no barrier between tiles.  R only names the tiles.
//    - Rows per block: the smallest ROWS in {1, 2, 4, 8} that keeps the
//      grid within one wave of SMs (B = 256 on 132 SMs: 2 rows, 128
//      blocks).  Rows past B are masked.
//    - What bounds it: U is not staged (f32 U is up to 256 KiB); every
//      thread streams its U column from L2 at every step, so each step of
//      every block re-reads all of U (G*h*h*4 bytes) from L2, a chain of
//      T*R (pipeline: T) steps of 7-8 us at QuickDraw (NVIDIA H100 80GB
//      HBM3, 700 W).  The cluster kernel's zx mode above takes all four
//      zx scans off this design up to H = 128, where the taggers run: it
//      is the route by H past that, as col_matmul + hoisted is for the
//      in-loop scans.
//    - Numerics as above: f32 FMA per column, (zx + dot_h) + b for the
//      LSTM, zh = dot_h + b_rec for the GRU.
//
// Both: full-precision expf / tanhf (no --use_fast_math).  xs may be f32 or
// bf16; weights are f32; the output takes the type of xs (hoisted: the
// caller's choice).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

#include "tile_stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLSTM = 0;
constexpr int kGRU = 1;
constexpr int kMaxThreads = 512;
constexpr int kMaxClusterThreads = 256;
constexpr int kGateSlots = 4;      // U / W / b padded to 4 gates a unit
constexpr int kXPerThread = 4;     // x values a thread carries a step
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

// ---------------------------------------------------------------------------
// 1. cluster_scan_kernel: the in-loop static scans
// ---------------------------------------------------------------------------

constexpr int kMaxK = 16;          // k steps (U rows) a lane holds

// floats per h row (one k): ROWS batch rows; 8 rows + 4 padding so that a
// warp's 16-byte loads of 8 neighbouring rows hit distinct banks
__host__ __device__ constexpr int h_stride(int rows) {
  return rows == 8 ? 12 : rows;
}

// The h exchange: an mbarrier per h buffer in every CTA; a producer
// stores into another CTA's buffer with st.async, which counts the bytes
// against that CTA's mbarrier; a consumer waits for the phase in which all
// the bytes of one step have landed.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this phase completes once `bytes` more have landed (one arrival)
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      ::"r"(bar), "r"(bytes)
      : "memory");
}

// wait for the phase of parity `parity` to complete; a trap instead of a
// hang should the bytes never come (a fault, not a path of the design)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// N floats into the shared memory (cluster address) of another CTA,
// counted against its mbarrier `bar` (cluster address)
template <int N>
__device__ __forceinline__ void store_async(unsigned dst, unsigned bar,
                                            const float (&v)[N]) {
  if (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst + 4 * i),
          "f"(v[i]), "f"(v[i + 1]), "f"(v[i + 2]), "f"(v[i + 3]), "r"(bar)
          : "memory");
  } else if (N == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(dst),
        "f"(v[0]), "f"(v[1]), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
        "[%0], %1, [%2];\n" ::"r"(dst),
        "f"(v[0]), "r"(bar)
        : "memory");
  }
}

__host__ __device__ inline int units_per_cta(int H, int C) {
  return (H + C - 1) / C;
}

// Shared-memory floats per CTA; the host and the kernel carve the same
// regions: 2 mbarriers (4 floats) | W [in][u][4] | b [1 or 2][u][4] |
// h [2][16*KS][h_stride(rows)] | x [3][rows][in].  h has a row for every
// k the lanes walk (rows past H stay 0, so the k loop needs no bound
// check).  The zx mode has no W (fin = 0), one bias row and zx buffers
// [3][rows][G][u] in place of x.  kernels/scan_layout.py's smem_bytes is
// the same formula.
__host__ __device__ inline size_t cluster_smem_floats(int cell, int fin,
                                                      int H, int C,
                                                      int k_split,
                                                      int rows,
                                                      bool zx = false) {
  const int u = units_per_cta(H, C);
  const int G = cell == kLSTM ? 4 : 3;
  const int nb = zx || cell == kLSTM ? 1 : 2;
  return 4 + (size_t)(fin + nb) * u * kGateSlots +
         2 * (size_t)kMaxK * k_split * h_stride(rows) +
         3 * (size_t)rows * (zx ? G * u : fin);
}

// x_t of the cluster's rows -> an x buffer (rows past B: 0), whole CTA
template <typename XT>
__device__ __forceinline__ void load_x(const XT* __restrict__ xs, float* x,
                                       int row0, int rows, int B, int T,
                                       int t, int fin) {
  for (int i = threadIdx.x; i < rows * fin; i += blockDim.x) {
    const int r = i / fin, row = row0 + r;
    x[i] = row < B ? to_f32(xs[((size_t)row * T + t) * fin + i - r * fin])
                   : 0.0f;
  }
}

// x_t of the cluster's rows, element threadIdx.x + q * blockDim.x of the
// tile into v[q] (0 past B or T)
template <typename XT>
__device__ __forceinline__ void load_x_regs(const XT* __restrict__ xs,
                                            float (&v)[kXPerThread],
                                            int row0, int B, int T, int t,
                                            int fin, int nx) {
#pragma unroll
  for (int q = 0; q < kXPerThread; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    v[q] = 0.0f;
    if (t < T && i < nx) {
      const int r = i / fin, row = row0 + r;
      if (row < B)
        v[q] = to_f32(xs[((size_t)row * T + t) * fin + i - r * fin]);
    }
  }
}

// zx mode: zx_t of the cluster's rows and the CTA's units, [rows][G][u]
// (a unit's G gate columns are runs of f32 in zx), into a zx buffer with
// 4-byte cp.async; zeros past B, T or the CTA's units.  One commit group a
// call.
__device__ __forceinline__ void stage_zx(const float* __restrict__ zx,
                                         float* buf, int row0, int rows,
                                         int B, int T, int t, int G, int H,
                                         int u, int uc, int j0) {
  const int gu = G * u;
  for (int i = threadIdx.x; i < rows * gu; i += blockDim.x) {
    const int r = i / gu, g = (i - r * gu) / u, j = i - r * gu - g * u;
    const int row = row0 + r;
    const bool ok = t < T && row < B && j < uc;
    const float* src =
        ok ? zx + ((size_t)row * T + t) * G * H + g * H + j0 + j : zx;
    cp_async4(smem_addr(buf + i), src, ok ? 4 : 0);
  }
  cp_async_commit();
}

// x-side products zx[r][g] = x[row0 + r] . W[:, g, unit] for N rows from
// an x buffer, for the gates g whose bit is set in `gates`
template <int G, int N>
__device__ __forceinline__ void x_side(const float* x, const float* W_s,
                                       int u, int jj, int row0, int fin,
                                       unsigned gates,
                                       float (&zx)[N][kGateSlots]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float a[kGateSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
    // blocks of 8 k, unrolled and predicated: the loads of a block are
    // issued together (in <= 6 for the taggers: one block)
    for (int k0 = 0; k0 < fin; k0 += 8) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = k0 + kk;
        if (k < fin) {
          const float xv = x[(row0 + r) * fin + k];
          const float4 w = reinterpret_cast<const float4*>(W_s)[k * u + jj];
          a[0] = fmaf(xv, w.x, a[0]);
          a[1] = fmaf(xv, w.y, a[1]);
          a[2] = fmaf(xv, w.z, a[2]);
          if (G == 4) a[3] = fmaf(xv, w.w, a[3]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (gates >> g & 1u) zx[r][g] = a[g];
  }
}

// One halving level of reduce_scatter: of the NR rows a lane holds, lanes
// with bit M of s set keep the upper half, the others the lower, and each
// adds its partner's (lane s ^ M) half of the same rows.
template <int G, int M, int NR, int ROWS>
__device__ __forceinline__ void halve(float (&v)[ROWS][kGateSlots], int s) {
  const bool upper = (s & M) != 0;
#pragma unroll
  for (int r = 0; r < NR / 2; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float send = upper ? v[r][g] : v[r + NR / 2][g];
      const float keep = upper ? v[r + NR / 2][g] : v[r][g];
      v[r][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
}

// Sum the ROWS x G partial products over the KS lanes of a unit and
// scatter them: lane s of the unit ends with the sums of rows
// [(s % L) * N, (s % L + 1) * N) in v[0..N), N = ROWS / L, L =
// min(KS, ROWS).  Butterfly levels first, for KS > ROWS (lanes s and
// s ^ m end alike), then the halving levels.  Either kind of level adds
// the partial sums of lanes s and s ^ m, and the distance m falls from
// KS / 2 to 1 at every ROWS: so every row's sum is one tree over the KS
// lanes ((s, s ^ KS/2) first), and a row has the same bits at ROWS = 1
// and 8, i.e. in a batch of any size.  Every lane of the warp takes part.
template <int G, int KS, int ROWS>
__device__ __forceinline__ void reduce_scatter(float (&v)[ROWS][kGateSlots],
                                               int s) {
  constexpr int L = KS < ROWS ? KS : ROWS;
#pragma unroll
  for (int m = KS / 2; m >= ROWS; m /= 2)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[r][g] += __shfl_xor_sync(0xffffffffu, v[r][g], m);
  if constexpr (L >= 2) halve<G, L / 2, ROWS>(v, s);
  if constexpr (L >= 4) halve<G, L / 4, ROWS / 2>(v, s);
  if constexpr (L >= 8) halve<G, L / 8, ROWS / 4>(v, s);
}

// xs [B,T,fin]; W [fin,G*H], U [H,G*H] f32 row-major; bias LSTM [4H], GRU
// [2,3H] (b_in ; b_rec); out [B,H].  Grid: ceil(B/8) clusters of C CTAs
// along x.  Thread i of a CTA is lane s = i % KS of unit jj = i / KS; it
// holds U[k][g*H + j0 + jj] for k = s, s + KS, ... in registers.
// ONE_PASS: R = 1 (all gates each pass).
// ZX (the hoisted and pipeline scans): xs is zx [B,T,G*H] f32,
// precomputed x W (the GRU with b_in folded in), W is unused and fin = 0;
// bias is the LSTM's b [4H] or the GRU's b_rec [3H]; out is OT (f32 or
// bf16).  Step t reads zx_t through the 3-deep buffer, staged two steps
// ahead with cp.async, in place of the in-kernel x W.  The pipeline scan
// (R tiles issued together) runs with ONE_PASS at every R.
template <int CELL, bool ZX, typename XT, typename OT, int ROWS, int KS,
          bool ONE_PASS>
__global__ void __launch_bounds__(kMaxClusterThreads)
cluster_scan_kernel(const XT* __restrict__ xs, const float* __restrict__ W,
                    const float* __restrict__ U,
                    const float* __restrict__ bias, OT* __restrict__ out,
                    int B, int T, int fin, int H, int reuse) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  constexpr int NB = ZX || CELL == kLSTM ? 1 : 2;
  constexpr int L = KS < ROWS ? KS : ROWS;
  constexpr int N = ROWS / L;                 // rows a lane updates
  constexpr int HS = h_stride(ROWS);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int u = units_per_cta(H, C);
  const int j0 = rank * u;                    // first unit of this CTA
  const int uc = min(u, H - j0);              // units it owns
  const int row0 = (blockIdx.x / C) * ROWS;
  const int s = threadIdx.x % KS;
  const int jj = threadIdx.x / KS;            // this thread's unit (local)
  const bool active = jj < uc;
  // after the reduce-scatter, the DUP = KS / L lanes with one s % L hold
  // the same sums: each updates rows r0 .. r0+N-1 alike, and they share
  // out the stores to the cluster's CTAs
  constexpr int DUP = KS / L;
  // The zx LSTM at R > 1 runs every gate's chain in every pass and keeps
  // the pass's gates when it sums (each column's sum is the same chain, so
  // the bits are those of a predicated FMA a gate): predicated, its
  // 8-row, 8-lane instance took 172 registers, two 128-thread CTAs an SM,
  // 30 clusters of 8 for the 32 of B = 256; so, 164 and one wave.  (The
  // GRU's instances keep the predicated FMAs: faster at R = 4 on the H100.)
  constexpr bool MASK_SUM = ZX && CELL == kLSTM && !ONE_PASS;
  const bool lead = active;
  const int dup = s / L;
  const int r0 = (s % L) * N;
  const int GH = G * H;
  const int nx = ZX ? ROWS * G * u : ROWS * fin;   // floats a x / zx buffer

  extern __shared__ float4 smem4[];
  const unsigned full = smem_addr(smem4);     // mbarrier of h buffer b: +8b
  float* W_s = reinterpret_cast<float*>(smem4 + 1);
  float* b_s = W_s + (size_t)fin * u * kGateSlots;
  const int hbuf = kMaxK * KS * HS;          // floats of one h buffer
  float* h_s = b_s + NB * u * kGateSlots;     // h_t in buffer t & 1
  float* x_s = h_s + 2 * hbuf;                // x_t (zx_t) in buffer t % 3

  // weights, once: this lane's U rows into registers; W and b slices of
  // the CTA's units into shared memory ([k][unit][gate], padding 0)
  float ur[kMaxK][kGateSlots];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    const int k = i * KS + s;
#pragma unroll
    for (int g = 0; g < kGateSlots; ++g)
      ur[i][g] = active && g < G && k < H
                     ? __ldg(&U[(size_t)k * GH + g * H + j0 + jj])
                     : 0.0f;
  }
  const int slab = u * kGateSlots;
  for (int i = threadIdx.x; i < (fin + NB) * slab; i += blockDim.x) {
    const int k = i / slab, jl = (i % slab) / kGateSlots;
    const int g = i % kGateSlots;
    const float* src = k < fin ? W + (size_t)k * GH
                               : bias + (size_t)(k - fin) * GH;
    W_s[i] = g < G && jl < uc ? src[g * H + j0 + jl] : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * hbuf; i += blockDim.x) h_s[i] = 0.0f;
  float xn[kXPerThread];                      // x_{t+2} at step t
  if constexpr (ZX) {
    stage_zx(xs, x_s, row0, ROWS, B, T, 0, G, H, u, uc, j0);
    stage_zx(xs, x_s + nx, row0, ROWS, B, T, 1, G, H, u, uc, j0);
    cp_async_wait<1>();                       // zx_0 (the sync below shares)
  } else {
    if (T > 0) load_x(xs, x_s, row0, ROWS, B, T, 0, fin);
    if (T > 1) load_x(xs, x_s + nx, row0, ROWS, B, T, 1, fin);
    load_x_regs(xs, xn, row0, B, T, 2, fin, nx);
  }
  float hr[N], cr[N], zx[N][kGateSlots];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    hr[r] = cr[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < kGateSlots; ++g) zx[r][g] = 0.0f;
  }
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started (its shared memory may be
  // written) and holds its weights and initialised mbarriers
  cluster.sync();
  const unsigned step_bytes = H * ROWS * sizeof(float);

  for (int t = 0; t < T; ++t) {
    const float* hc = h_s + (t & 1) * hbuf;
    // this step's x side (x_t, stored two steps ago or before the loop)
    // while h_t may still be in flight; in the zx mode, zx_t (landed at
    // the end of the last step) for every gate, and zx_{t+2} starts to load
    if constexpr (ZX) {
      stage_zx(xs, x_s + ((t + 2) % 3) * nx, row0, ROWS, B, T, t + 2, G, H,
               u, uc, j0);
      if (lead) {
        const float* zb = x_s + (t % 3) * nx;
#pragma unroll
        for (int r = 0; r < N; ++r)
#pragma unroll
          for (int g = 0; g < G; ++g)
            zx[r][g] = zb[((r0 + r) * G + g) * u + jj];
      }
    } else if (ONE_PASS && lead) {
      x_side<G, N>(x_s + (t % 3) * nx, W_s, u, jj, r0, fin, ~0u, zx);
    }
    // h_t has landed (h_0 = 0 needs no wait); then open the phase that
    // collects h_{t+1}: its previous phase (h_{t-1}) completed at step t-1
    if (t > 0) mbar_wait(full + 8 * (t & 1), ((t - 1) >> 1) & 1);
    if (threadIdx.x == 0) mbar_expect(full + 8 * ((t + 1) & 1), step_bytes);

    // h side: R passes in order (one at R = 1); pass p computes the gate
    // columns [p*gw, (p+1)*gw) of this CTA's units, x side included
    float zh[N][kGateSlots];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int g = 0; g < kGateSlots; ++g) zh[r][g] = 0.0f;
    const int gw = GH / reuse;
    for (int p = 0; p < (ONE_PASS ? 1 : reuse); ++p) {
      unsigned gates = ONE_PASS ? ~0u : 0u;
      if (!ONE_PASS) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int col = g * H + j0 + jj;
          if (col >= p * gw && col < (p + 1) * gw) gates |= 1u << g;
        }
      }
      float v[ROWS][kGateSlots];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < kGateSlots; ++g) v[r][g] = 0.0f;
      if (active && gates) {
        // no bound check: rows k >= H of h and of ur are 0
#pragma unroll
        for (int i = 0; i < kMaxK; ++i) {
          const float* hk = hc + (i * KS + s) * HS;
          float hv[ROWS];
          if constexpr (ROWS == 8) {
            const float4 lo = reinterpret_cast<const float4*>(hk)[0];
            const float4 hi = reinterpret_cast<const float4*>(hk)[1];
            hv[0] = lo.x; hv[1] = lo.y; hv[2] = lo.z; hv[3] = lo.w;
            hv[4] = hi.x; hv[5] = hi.y; hv[6] = hi.z; hv[7] = hi.w;
          } else {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) hv[r] = hk[r];
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (ONE_PASS || MASK_SUM || (gates >> g & 1u))
                v[r][g] = fmaf(hv[r], ur[i][g], v[r][g]);
        }
      }
      reduce_scatter<G, KS, ROWS>(v, s);
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (!MASK_SUM || (gates >> g & 1u)) zh[r][g] += v[r][g];
      if (!ONE_PASS) {
        if (!ZX && lead && gates)
          x_side<G, N>(x_s + (t % 3) * nx, W_s, u, jj, r0, fin, gates, zx);
        __syncthreads();
      }
    }

    if (lead) {
      const float* b0 = b_s + jj * kGateSlots;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        if (CELL == kLSTM) {
          const float ig = sigmoid((zx[r][0] + zh[r][0]) + b0[0]);
          const float fg = sigmoid((zx[r][1] + zh[r][1]) + b0[1]);
          const float gg = tanhf((zx[r][2] + zh[r][2]) + b0[2]);
          const float og = sigmoid((zx[r][3] + zh[r][3]) + b0[3]);
          cr[r] = fg * cr[r] + ig * gg;
          hr[r] = og * tanhf(cr[r]);
        } else if (ZX) {                 // b_in is in zx; b0 is b_rec
          const float zg = sigmoid(zx[r][0] + (zh[r][0] + b0[0]));
          const float rg = sigmoid(zx[r][1] + (zh[r][1] + b0[1]));
          const float hh = tanhf(zx[r][2] + rg * (zh[r][2] + b0[2]));
          hr[r] = zg * hr[r] + (1.0f - zg) * hh;
        } else {
          const float* b1 = b0 + u * kGateSlots;   // b_rec
          const float zg = sigmoid((zx[r][0] + b0[0]) + (zh[r][0] + b1[0]));
          const float rg = sigmoid((zx[r][1] + b0[1]) + (zh[r][1] + b1[1]));
          const float hh =
              tanhf((zx[r][2] + b0[2]) + rg * (zh[r][2] + b1[2]));
          hr[r] = zg * hr[r] + (1.0f - zg) * hh;
        }
      }
      // the new h of rows r0.. of unit j0 + jj into buffer (t+1)&1 of
      // every CTA of the cluster, counted against its mbarrier
      const int nb = (t + 1) & 1;
      const unsigned dst = smem_addr(
          h_s + nb * hbuf + (j0 + jj) * HS + r0);
      for (int q = dup; q < C; q += DUP)
        store_async<N>(cluster_addr(dst, q), cluster_addr(full + 8 * nb, q),
                       hr);
    }
    if constexpr (ZX) {
      cp_async_wait<1>();                     // zx_{t+1} has landed
    } else {
      // x_{t+2} (loaded a step ago) into its buffer; x_{t+3} into
      // registers, a whole step ahead of its store
      float* xnext = x_s + ((t + 2) % 3) * nx;
#pragma unroll
      for (int q = 0; q < kXPerThread; ++q) {
        const int i = threadIdx.x + q * blockDim.x;
        if (i < nx) xnext[i] = xn[q];
      }
      load_x_regs(xs, xn, row0, B, T, t + 3, fin, nx);
    }
    __syncthreads();
  }
  // h_T has landed here too: no store is in flight into a CTA that exits
  if (T > 0) mbar_wait(full + 8 * (T & 1), ((T - 1) >> 1) & 1);
  if constexpr (ZX) cp_async_wait<0>();
  cluster.sync();

  if (lead && dup == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int row = row0 + r0 + r;
      if (row < B) store(&out[(size_t)row * H + j0 + jj], hr[r]);
    }
  }
}

// Is the layout one that cluster_scan_kernel takes?  (kernels/scan_layout.py
// builds layouts that are; chip_smoke.py checks that this refuses others.)
bool cluster_layout_ok(int cell, int B, int T, int fin, int H, int reuse,
                       int C, int rows, int k_split, int threads, int smem,
                       bool zx = false) {
  const int G = cell == kLSTM ? 4 : 3;
  if (B < 1 || T < 0 || H < 1 || fin < 0 || reuse < 1 || (G * H) % reuse)
    return false;
  if (zx && fin != 0) return false;
  if (C != 1 && C != 2 && C != 4 && C != 8) return false;
  const int u = units_per_cta(H, C);
  if (C > H || (C - 1) * u >= H || (rows != 1 && rows != 8)) return false;
  if ((k_split != 2 && k_split != 8) || (H + k_split - 1) / k_split > kMaxK)
    return false;
  if (threads % 32 || threads > kMaxClusterThreads ||
      threads < u * k_split || rows * fin > kXPerThread * threads)
    return false;
  const size_t want =
      cluster_smem_floats(cell, fin, H, C, k_split, rows, zx) * sizeof(float);
  return (size_t)smem == want && want <= kMaxSmem;
}

// Clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: none fits, as where a cluster of 8
// finds no 8 free SMs in one GPC), or a negative CUDA error.  Asked once
// per (kernel, C, threads, smem) and remembered.
template <typename K>
int resident_clusters(K kernel, int C, int threads, int smem) {
  struct Entry { const void* fn; int C, threads, smem, clusters; };
  static Entry cache[256];
  static int n_cache = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.fn == fn && e.C == C && e.threads == threads && e.smem == smem)
      return e.clusters;
  }
  cudaError_t e = cudaSuccess;
  if ((size_t)smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return -(int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  if (n_cache < 256) cache[n_cache++] = {fn, C, threads, smem, clusters};
  return clusters;
}

// B < 0: report resident_clusters instead of launching.
template <int CELL, bool ZX, typename XT, typename OT, int ROWS, int KS,
          bool ONE_PASS>
int run_cluster(const void* xs, const float* W, const float* U,
                const float* bias, void* out, int B, int T, int fin, int H,
                int reuse, int C, int threads, int smem,
                cudaStream_t stream) {
  auto kernel = cluster_scan_kernel<CELL, ZX, XT, OT, ROWS, KS, ONE_PASS>;
  const int resident = resident_clusters(kernel, C, threads, smem);
  if (B < 0) return resident;
  if (resident < 0) return -resident;
  if (resident == 0) return (int)cudaErrorInvalidClusterSize;
  if ((size_t)smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + ROWS - 1) / ROWS) * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(xs),
                                     W, U, bias, static_cast<OT*>(out), B, T,
                                     fin, H, reuse);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int CELL, bool ZX, typename XT, typename OT, bool ONE_PASS>
int launch_cluster_as(const void* xs, const float* W, const float* U,
                      const float* b, void* out, int B, int T, int fin,
                      int H, int reuse, int C, int rows, int k_split,
                      int threads, int smem, cudaStream_t s) {
#define RUN(ROWS, KS)                                                      \
  if (rows == ROWS && k_split == KS)                                       \
  return run_cluster<CELL, ZX, XT, OT, ROWS, KS, ONE_PASS>(                \
      xs, W, U, b, out, B, T, fin, H, reuse, C, threads, smem, s)
  RUN(1, 2);
  RUN(1, 8);
  RUN(8, 2);
  RUN(8, 8);
#undef RUN
  return (int)cudaErrorInvalidValue;
}

template <int CELL>
int launch_cluster(const void* xs, int xs_bf16, const float* W,
                   const float* U, const float* b, void* out, int B, int T,
                   int fin, int H, int reuse, int C, int rows, int k_split,
                   int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (xs_bf16) {
    return reuse == 1
               ? launch_cluster_as<CELL, false, BF, BF, true>(
                     xs, W, U, b, out, B, T, fin, H, reuse, C, rows,
                     k_split, threads, smem, s)
               : launch_cluster_as<CELL, false, BF, BF, false>(
                     xs, W, U, b, out, B, T, fin, H, reuse, C, rows,
                     k_split, threads, smem, s);
  }
  return reuse == 1
             ? launch_cluster_as<CELL, false, float, float, true>(
                   xs, W, U, b, out, B, T, fin, H, reuse, C, rows, k_split,
                   threads, smem, s)
             : launch_cluster_as<CELL, false, float, float, false>(
                   xs, W, U, b, out, B, T, fin, H, reuse, C, rows, k_split,
                   threads, smem, s);
}

// The zx mode (hoisted and pipeline scans): zx [B,T,G*H] f32, out f32 or
// bf16.  one_pass: the ONE_PASS instance (the hoisted scan at R = 1, the
// pipeline scan at every R: R only names its tiles).
template <int CELL>
int launch_cluster_zx(const float* zx, int out_bf16, const float* U,
                      const float* b, void* out, int B, int T, int H,
                      int reuse, bool one_pass, int C, int rows, int k_split,
                      int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (out_bf16) {
    return one_pass
               ? launch_cluster_as<CELL, true, float, BF, true>(
                     zx, nullptr, U, b, out, B, T, 0, H, reuse, C, rows,
                     k_split, threads, smem, s)
               : launch_cluster_as<CELL, true, float, BF, false>(
                     zx, nullptr, U, b, out, B, T, 0, H, reuse, C, rows,
                     k_split, threads, smem, s);
  }
  return one_pass
             ? launch_cluster_as<CELL, true, float, float, true>(
                   zx, nullptr, U, b, out, B, T, 0, H, reuse, C, rows,
                   k_split, threads, smem, s)
             : launch_cluster_as<CELL, true, float, float, false>(
                   zx, nullptr, U, b, out, B, T, 0, H, reuse, C, rows,
                   k_split, threads, smem, s);
}

template <int CELL>
int checked_launch_cluster(const void* xs, int xs_bf16, const float* W,
                           const float* U, const float* b, void* out, int B,
                           int T, int fin, int H, int reuse, int C, int rows,
                           int k_split, int threads, int smem,
                           void* stream) {
  if (!cluster_layout_ok(CELL, B, T, fin, H, reuse, C, rows, k_split,
                         threads, smem))
    return (int)cudaErrorInvalidValue;
  return launch_cluster<CELL>(xs, xs_bf16, W, U, b, out, B, T, fin, H, reuse,
                              C, rows, k_split, threads, smem, stream);
}

template <int CELL>
int checked_launch_cluster_zx(const float* zx, int out_bf16, const float* U,
                              const float* b, void* out, int B, int T, int H,
                              int reuse, bool one_pass, int C, int rows,
                              int k_split, int threads, int smem,
                              void* stream) {
  if (!cluster_layout_ok(CELL, B, T, 0, H, reuse, C, rows, k_split, threads,
                         smem, true))
    return (int)cudaErrorInvalidValue;
  return launch_cluster_zx<CELL>(zx, out_bf16, U, b, out, B, T, H, reuse,
                                 one_pass, C, rows, k_split, threads, smem,
                                 stream);
}

// ---------------------------------------------------------------------------
// 2. rnn_scan_kernel: the hoisted and pipeline scans
// ---------------------------------------------------------------------------

// Shared-memory floats per block: h [ROWS,h] | c [ROWS,h] (LSTM) |
// z [ROWS,G*h] (LSTM z, GRU zh).
template <int CELL>
__host__ __device__ size_t smem_floats(int rows, int H) {
  const int G = CELL == kLSTM ? 4 : 3;
  size_t n = (size_t)rows * H;                         // h
  if (CELL == kLSTM) n += (size_t)rows * H;            // c
  n += (size_t)rows * G * H;                           // z / zh
  return n;
}

// in: zx [B,T,G*h] f32 (GRU: b_in folded in); U [h,G*h] f32 row-major;
// bias: LSTM [4h], GRU b_rec [3h].  out [B,h].
// PIPE: all R column tiles in one pass, no barrier between.
template <int CELL, bool PIPE, typename OT, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
rnn_scan_kernel(const float* __restrict__ in, const float* __restrict__ U,
                const float* __restrict__ bias, OT* __restrict__ out, int B,
                int T, int H, int reuse) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  const int GH = G * H;
  const int tiles = PIPE ? 1 : reuse;
  const int gw = GH / tiles;
  const int row0 = blockIdx.x * ROWS;

  extern __shared__ float smem[];
  float* h_s = smem;
  float* c_s = h_s + ROWS * H;
  float* z_s = c_s + (CELL == kLSTM ? ROWS * H : 0);

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    h_s[i] = 0.0f;
    if (CELL == kLSTM) c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
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
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int row = row0 + r;
          if (CELL == kLSTM) {
            const float zx =
                row < B ? in[((size_t)row * T + t) * GH + n] : 0.0f;
            z_s[r * GH + n] = (zx + acc_h[r]) + bias[n];
          } else {
            z_s[r * GH + n] = acc_h[r] + bias[n];
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
        const int row = row0 + r;
        if (row < B) {
          const float* zx = in + ((size_t)row * T + t) * GH;
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

template <int CELL, bool PIPE, typename OT, int ROWS>
int run(const float* zx, const float* U, const float* bias, void* out, int B,
        int T, int H, int reuse, int threads, size_t smem,
        cudaStream_t stream) {
  auto kernel = rnn_scan_kernel<CELL, PIPE, OT, ROWS>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + ROWS - 1) / ROWS;
  kernel<<<blocks, threads, smem, stream>>>(zx, U, bias,
                                            static_cast<OT*>(out), B, T, H,
                                            reuse);
  return (int)cudaGetLastError();
}

template <int CELL, bool PIPE, typename OT>
int launch(const float* zx, const float* U, const float* bias, void* out,
           int B, int T, int H, int reuse, void* stream) {
  const int GH = (CELL == kLSTM ? 4 : 3) * H;
  if (B < 1 || T < 0 || H < 1 || reuse < 1 || GH % reuse != 0)
    return (int)cudaErrorInvalidValue;
  const int gw = PIPE ? GH : GH / reuse;  // columns in flight per pass
  int threads = ((gw + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const int rows = rows_for(B);
  const size_t smem = smem_floats<CELL>(rows, H) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1:
      return run<CELL, PIPE, OT, 1>(zx, U, bias, out, B, T, H, reuse,
                                    threads, smem, s);
    case 2:
      return run<CELL, PIPE, OT, 2>(zx, U, bias, out, B, T, H, reuse,
                                    threads, smem, s);
    case 4:
      return run<CELL, PIPE, OT, 4>(zx, U, bias, out, B, T, H, reuse,
                                    threads, smem, s);
    default:
      return run<CELL, PIPE, OT, 8>(zx, U, bias, out, B, T, H, reuse,
                                    threads, smem, s);
  }
}

template <int CELL, bool PIPE>
int launch_hoisted(const float* zx, const float* U, const float* b, void* out,
                   int out_bf16, int B, int T, int H, int reuse,
                   void* stream) {
  if (out_bf16)
    return launch<CELL, PIPE, __nv_bfloat16>(zx, U, b, out, B, T, H, reuse,
                                             stream);
  return launch<CELL, PIPE, float>(zx, U, b, out, B, T, H, reuse, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

// The in-loop static scans take their cluster layout (cluster, rows,
// k_split, threads, smem_bytes) from kernels/scan_layout.py.
int lstm_scan(const void* xs, int xs_bf16, const float* W, const float* U,
              const float* b, void* out, int B, int T, int fin, int H,
              int reuse, int cluster, int rows, int k_split, int threads,
              int smem_bytes, void* stream) {
  return checked_launch_cluster<kLSTM>(xs, xs_bf16, W, U, b, out, B, T, fin,
                                       H, reuse, cluster, rows, k_split,
                                       threads, smem_bytes, stream);
}

int gru_scan(const void* xs, int xs_bf16, const float* W, const float* U,
             const float* b, void* out, int B, int T, int fin, int H,
             int reuse, int cluster, int rows, int k_split, int threads,
             int smem_bytes, void* stream) {
  return checked_launch_cluster<kGRU>(xs, xs_bf16, W, U, b, out, B, T, fin,
                                      H, reuse, cluster, rows, k_split,
                                      threads, smem_bytes, stream);
}

// Clusters of the in-loop scan kernel at this layout (cell 0: LSTM, 1:
// GRU) that the current device holds at once (cudaOccupancyMaxActiveClusters),
// or a negative CUDA error (-cudaErrorInvalidValue: no such kernel).
// kernels/scan_layout.py counts waves with it.
int cluster_scan_resident(int cell, int xs_bf16, int reuse, int cluster,
                          int rows, int k_split, int threads,
                          int smem_bytes) {
  if ((cell != kLSTM && cell != kGRU) || reuse < 1 || threads < 1 ||
      threads > kMaxClusterThreads || smem_bytes < 0 ||
      (size_t)smem_bytes > kMaxSmem ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (rows != 1 && rows != 8) || (k_split != 2 && k_split != 8))
    return -(int)cudaErrorInvalidValue;
  auto query = cell == kLSTM ? launch_cluster<kLSTM> : launch_cluster<kGRU>;
  return query(nullptr, xs_bf16, nullptr, nullptr, nullptr, nullptr, -1, 0,
               0, 0, reuse, cluster, rows, k_split, threads, smem_bytes,
               nullptr);
}

// The hoisted and pipeline scans on the cluster kernel's zx mode, at a
// cluster layout (cluster, rows, k_split, threads, smem_bytes) from
// kernels/scan_layout.py (hoisted=True; the pipelines' is R = 1's): H up to
// 128.  A pipeline runs the ONE_PASS instance at every R, so at any R it
// gives the hoisted scan's R = 1 bits.
int lstm_scan_hoisted(const float* zx, const float* U, const float* b,
                      void* out, int out_bf16, int B, int T, int H, int reuse,
                      int cluster, int rows, int k_split, int threads,
                      int smem_bytes, void* stream) {
  return checked_launch_cluster_zx<kLSTM>(zx, out_bf16, U, b, out, B, T, H,
                                          reuse, reuse == 1, cluster, rows,
                                          k_split, threads, smem_bytes,
                                          stream);
}

int gru_scan_hoisted(const float* zx, const float* U, const float* b_rec,
                     void* out, int out_bf16, int B, int T, int H, int reuse,
                     int cluster, int rows, int k_split, int threads,
                     int smem_bytes, void* stream) {
  return checked_launch_cluster_zx<kGRU>(zx, out_bf16, U, b_rec, out, B, T,
                                         H, reuse, reuse == 1, cluster, rows,
                                         k_split, threads, smem_bytes,
                                         stream);
}

int lstm_scan_pipeline(const float* zx, const float* U, const float* b,
                       void* out, int out_bf16, int B, int T, int H, int reuse,
                       int cluster, int rows, int k_split, int threads,
                       int smem_bytes, void* stream) {
  return checked_launch_cluster_zx<kLSTM>(zx, out_bf16, U, b, out, B, T, H,
                                          reuse, true, cluster, rows,
                                          k_split, threads, smem_bytes,
                                          stream);
}

int gru_scan_pipeline(const float* zx, const float* U, const float* b_rec,
                      void* out, int out_bf16, int B, int T, int H, int reuse,
                      int cluster, int rows, int k_split, int threads,
                      int smem_bytes, void* stream) {
  return checked_launch_cluster_zx<kGRU>(zx, out_bf16, U, b_rec, out, B, T,
                                         H, reuse, true, cluster, rows,
                                         k_split, threads, smem_bytes,
                                         stream);
}

// The same functions on the block kernel (rnn_scan_kernel): the route for
// H past the cluster kernel's 128.
int lstm_scan_hoisted_block(const float* zx, const float* U, const float* b,
                            void* out, int out_bf16, int B, int T, int H,
                            int reuse, void* stream) {
  return launch_hoisted<kLSTM, false>(zx, U, b, out, out_bf16, B, T, H,
                                      reuse, stream);
}

int gru_scan_hoisted_block(const float* zx, const float* U,
                           const float* b_rec, void* out, int out_bf16,
                           int B, int T, int H, int reuse, void* stream) {
  return launch_hoisted<kGRU, false>(zx, U, b_rec, out, out_bf16, B, T, H,
                                     reuse, stream);
}

int lstm_scan_pipeline_block(const float* zx, const float* U,
                             const float* b, void* out, int out_bf16, int B,
                             int T, int H, int reuse, void* stream) {
  return launch_hoisted<kLSTM, true>(zx, U, b, out, out_bf16, B, T, H, reuse,
                                     stream);
}

int gru_scan_pipeline_block(const float* zx, const float* U,
                            const float* b_rec, void* out, int out_bf16,
                            int B, int T, int H, int reuse, void* stream) {
  return launch_hoisted<kGRU, true>(zx, U, b_rec, out, out_bf16, B, T, H,
                                    reuse, stream);
}

// Clusters of the zx-mode scan kernel at this layout (cell 0: LSTM, 1:
// GRU; the ONE_PASS instance at reuse 1, as the pipelines run it) that the
// current device holds at once, or a negative CUDA error.
// kernels/scan_layout.py counts waves with it.
int cluster_zx_scan_resident(int cell, int out_bf16, int reuse, int cluster,
                             int rows, int k_split, int threads,
                             int smem_bytes) {
  if ((cell != kLSTM && cell != kGRU) || reuse < 1 || threads < 1 ||
      threads > kMaxClusterThreads || smem_bytes < 0 ||
      (size_t)smem_bytes > kMaxSmem ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (rows != 1 && rows != 8) || (k_split != 2 && k_split != 8))
    return -(int)cudaErrorInvalidValue;
  auto query =
      cell == kLSTM ? launch_cluster_zx<kLSTM> : launch_cluster_zx<kGRU>;
  return query(nullptr, out_bf16, nullptr, nullptr, nullptr, -1, 0, 0, reuse,
               reuse == 1, cluster, rows, k_split, threads, smem_bytes,
               nullptr);
}

// Rows of the batch each thread block of the hoisted and pipeline scans
// carries for a batch of B rows.
int scan_rows_per_block(int B) { return rows_for(B); }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
