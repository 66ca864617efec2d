"""Single-step decode: the ``decode_matmul`` CUDA kernel's wrapper, launch
layout and plain version, the weight-residency helpers, and the scheduled
RNN decode step.

Replaces ``repro/kernels/decode_step.py``'s ``decode_matmul_pallas``
(``[M, K] @ [K, N]``, both f32 or both bf16, the N columns in R
sequential passes, the weight resident); the kernel lives in
``csrc/decode_matmul.cu``.  It streams w split along K: K is cut into
chunks of :func:`chunk_rows` rows (a function of K, N and the dtype,
never of R), each output's chunk partial is one f32 chain in increasing
k, and the partials are folded in chunk order, so neither R nor the grid
changes a bit.  The grid
is (m tiles x column blocks x K splits) at :func:`decode_layout`'s layout,
chosen per call so that every R fills the card; it takes any M (no row
padding).  The TPU's alignment check (``check_tpu_alignment``) is not
ported.

``decode_matmul``
    The scheduled single-step matmul.  ``schedule=None`` or
    ``backend="xla"`` is the plain dot (``torch.matmul`` after jnp's type
    promotion; float32 products stay full float32 as long as TF32 matmuls
    are off, PyTorch's default).  Every other backend dispatches on the
    tensor's device: a CUDA tensor launches the kernel (or raises), a CPU
    tensor runs the kernel's plain version.  Column tiles never split the
    K reduction, and the kernel sums every column in one fixed order, so on
    the card R = 1 and R = 4 give the same bits.

``rnn_decode_step``
    One scheduled LSTM/GRU state update: the cells of ``core/rnn/cells.py``
    with ``decode_matmul`` as their ``matmul`` hook.  With ``fp`` the
    quantized cells run (the ap_fixed emulation), and an integral ``fp`` on
    a kernel schedule takes the native int8/int4 step of
    ``kernels/quantized.py`` (every gate product on ``quant_matmul``).

``resident_matrix`` / ``resident_fused`` pack weights into the
compute-ready layout (trailing dims flattened, gate-fused, cast) once per
(source tensors and versions, schedule key) through
``ops.RESIDENT_WEIGHTS``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import FixedPointConfig
from repro_torch.core.quant.fixed_point import is_native_int
from repro_torch.core.rnn.cells import (gru_cell, gru_cell_quantized,
                                        lstm_cell, lstm_cell_quantized)
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ops import resident
from repro_torch.kernels.schedule import KernelSchedule


# ---------------------------------------------------------------------------
# The reuse-tiled single-step matmul
# ---------------------------------------------------------------------------


def plain_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot`` of the two: both cast to their promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def decode_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                        reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`decode_matmul_kernel`: the R column tiles as
    float32 products, the result rounded once to the inputs' dtype.  On CPU
    tensors each product is ``ref.matmul``'s k-ordered sum, so that a row's
    bits do not depend on M, as the kernel's do not: the speculative
    verify pass runs the products of B·S rows where a sequential step runs
    B (MKL's ``matmul`` rounds a row differently at different M)."""
    ns = w.shape[1] // reuse
    x32 = x.float()
    tiles = [ref.matmul(x32, w[:, r * ns:(r + 1) * ns].float())
             for r in range(reuse)]
    return torch.cat(tiles, dim=-1).to(x.dtype)


#: the layout model's view of the card (an H100 SXM); used only to rank
#: layouts, never as a measurement.  The latency, L2 rate and lone-warp
#: issue rate are assumed values, chosen so that the model ranks the
#: layouts of gemma-2b's and the taggers' decode shapes near the order in
#: which they ran on an H100 (``chip_smoke.py --time-decode`` reports the
#: picked layout's time)
SMS = 132
SCHEDULERS = 4                    # warp schedulers an SM
SMEM_PER_SM = 233_472             # 228 KiB an SM, 227 KiB a block at most
SMEM_LIMIT = 232_448
CLOCK_HZ = 1.755e9
HBM_BPS = 3.35e12
L2_BPS = 8e12                     # assumed L2 -> SM rate
LATENCY_S = 0.3e-6                # assumed latency of a ring slot
#: a lone warp's instructions a cycle on a dependent chain (assumed)
LONE_IPC = 0.25
#: what the fold kernel adds where more than one split shares K
FOLD_S = 2e-6
#: ring slots a thread: w rows in flight (csrc kDepth)
DEPTH = 32
#: w bytes up to which a chunk is short (csrc design note)
SMALL_W = 16 * 2 ** 20
ROWS = (1, 2, 4, 8)               # rows of x a block carries
WARPS = (1, 2, 4)                 # column warps a block, a segment each
K_WARPS = (1, 2, 4, 8)            # K warps a block, a chunk each in turn
MAX_THREADS = 256
MAX_X_BYTES = 32 * 1024           # x of a block's K run, staged as f32


def chunk_rows(K: int, N: int, bf16: bool) -> int:
    """Rows of K a chunk, the unit of one f32 chain in increasing k: all of
    K up to 32 (one chunk: the kernel rounds into ``out`` itself); else 32
    where w is at most ``SMALL_W`` bytes (short chains for q|k|v, o and
    the taggers' products, whose workspace is small) and 128 beyond it
    (gate|up, down: a workspace of 6 % of w's bytes).  It depends on K, N
    and the dtype only, so a column's summation order never depends on R,
    M or the grid."""
    if K <= 32:
        return K
    return 32 if K * N * (2 if bf16 else 4) <= SMALL_W else 128


class DecodeLayout(NamedTuple):
    vec: int                      # columns a thread (16 bytes, or 1)
    rows: int                     # rows of x a block
    chunk: int                    # K rows a chunk (chunk_rows)
    chunks_per_split: int         # a block's run of chunks
    warps: int                    # column warps a block
    k_warps: int                  # K warps a block
    m_tiles: int
    col_blocks: int               # column blocks of a tile
    splits: int                   # K splits
    chunks: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.col_blocks * self.splits

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.k_warps

    @property
    def launches(self) -> int:
        """Kernels one call launches: the product, and the chunk fold where
        more than one split shares K (one split folds in the block)."""
        return 2 if self.splits > 1 else 1

    def c_args(self) -> Tuple[int, ...]:
        """What the C entry point takes: vec, rows, chunk, chunks a split,
        column warps, K warps."""
        return (self.vec, self.rows, self.chunk, self.chunks_per_split,
                self.warps, self.k_warps)


def _shape(M, K, N, reuse, vec, rows, chunk, cps, warps, k_warps
           ) -> DecodeLayout:
    """The derived shape of one candidate (as the C launcher derives it):
    shared memory holds the ring, x and, where one split covers K, the
    chunk partials of the block's columns."""
    ns = N // reuse
    chunks = -(-K // chunk)
    segs = -(-ns // (32 * vec))
    run = min(K, cps * chunk)
    splits = -(-chunks // cps)
    part = (reuse * -(-run // chunk) * rows * warps * 32 * vec * 4
            if chunks > 1 and splits == 1 else 0)
    smem = (DEPTH * 32 * warps * k_warps * 16 + -(-rows * run * 4 // 16) * 16
            + part)
    return DecodeLayout(vec, rows, chunk, cps, warps, k_warps, -(-M // rows),
                        -(-segs // warps), splits, chunks, smem)


def _modelled_s(lay: DecodeLayout, M, K, N, reuse, elt) -> float:
    """Seconds the layout model gives one call: the largest of instruction
    issue (a lone warp at ``LONE_IPC``, warps sharing a scheduler in
    turn), the ring's latency, device-memory bytes and L2 bytes (w re-read
    per m tile), plus a fold launch.  Constants are the H100's data-sheet
    rates and assumed latencies, not measurements."""
    per_sm = min(SMEM_PER_SM // (lay.smem_bytes + 1024),
                 2048 // lay.threads, 32)
    if per_sm < 1:
        return math.inf
    resident = SMS * per_sm
    waves = -(-lay.blocks // resident)
    warps_per_sched = (lay.threads // 32
                       * -(-min(lay.blocks, resident) // SMS) / SCHEDULERS)
    # a thread's rows: its chunks of the run, every tile
    run = min(K, lay.chunks_per_split * lay.chunk)
    per_warp = -(-(-(-run // lay.chunk)) // lay.k_warps)   # chunks
    rows = reuse * min(run, per_warp * lay.chunk)
    bf16 = elt == 2
    instr = (14 + -(-lay.rows // 4) + (lay.vec if bf16 else 0)
             + lay.rows * lay.vec)
    t_issue = (rows * instr / CLOCK_HZ
               * max(1.0 / LONE_IPC, warps_per_sched) * waves)
    t_lat = (rows / DEPTH + 2) * LATENCY_S * waves
    ws = 4 * lay.chunks * M * N if lay.splits > 1 else 0
    t_hbm = (K * N + M * K + M * N) * elt / HBM_BPS
    t_l2 = (lay.m_tiles * K * N * elt + 2 * ws) / L2_BPS
    return max(t_issue, t_lat, t_hbm, t_l2) + (FOLD_S if lay.splits > 1
                                               else 0.0)


@functools.lru_cache(maxsize=4096)
def decode_layout(M: int, K: int, N: int, reuse: int, bf16: bool,
                  aligned: bool = True) -> DecodeLayout:
    """The launch layout of one ``decode_matmul`` call: 16-byte pieces
    (``vec``) where N/R and w's address allow (``aligned``), the chunk of
    :func:`chunk_rows`, and of the rows, column warps and K warps a block
    and chunks a split that fit a block (x staged in at most
    ``MAX_X_BYTES``), the one the layout model (:func:`_modelled_s`) gives
    the least time, then the fewest threads.  One split folds its chunks
    in the block (one launch); more splits fill the card where the column
    blocks alone do not (R = 4 has a quarter of R = 1's) at the cost of a
    workspace and a fold launch."""
    if M < 1 or K < 1 or N < 1 or reuse < 1 or N % reuse:
        raise ValueError(f"decode_layout: M={M} K={K} N={N} R={reuse}")
    elt = 2 if bf16 else 4
    ns = N // reuse
    full = 16 // elt
    vec = full if aligned and ns % full == 0 else 1
    chunk = chunk_rows(K, N, bf16)
    chunks = -(-K // chunk)
    segs = -(-ns // (32 * vec))
    # chunks a split: halvings of all of them, down to one
    cps_all = sorted({-(-chunks // 2 ** i) for i in range(chunks.bit_length())}
                     | {1})
    best, best_key = None, None
    for rows in ROWS:
        if rows > 1 and rows // 2 >= M:
            continue
        for warps in WARPS:
            if warps > 1 and warps // 2 >= segs:
                continue
            for cps in cps_all:
                run_chunks = -(-min(K, cps * chunk) // chunk)
                if rows * min(K, cps * chunk) * 4 > MAX_X_BYTES:
                    continue
                for k_warps in K_WARPS:
                    if (32 * warps * k_warps > MAX_THREADS
                            or (k_warps > 1 and k_warps // 2 >= run_chunks)):
                        continue
                    lay = _shape(M, K, N, reuse, vec, rows, chunk, cps,
                                 warps, k_warps)
                    if lay.smem_bytes > SMEM_LIMIT:
                        continue
                    key = (_modelled_s(lay, M, K, N, reuse, elt),
                           lay.blocks * lay.threads)
                    if best_key is None or key < best_key:
                        best, best_key = lay, key
    if best is None:
        raise ValueError(f"decode_layout: no layout fits M={M} K={K} N={N} "
                         f"R={reuse}")
    return best


def decode_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                         reuse: int = 1) -> torch.Tensor:
    """x: [M, K] @ w: [K, N], both float32 or both bfloat16 -> [M, N] in
    their dtype, f32 accumulation, the N columns in ``reuse`` sequential
    tiles (``reuse`` must divide N)."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"decode_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not a matrix product")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_matmul: x and w must be both float32 or "
                        f"both bfloat16, not {x.dtype} and {w.dtype}")
    (M, K), N = x.shape, w.shape[1]
    if reuse < 1 or N % reuse:
        raise ValueError(f"decode_matmul: reuse {reuse} does not divide {N}")
    if x.device.type == "cpu":
        return decode_matmul_plain(x, w, reuse=reuse)
    if x.device.type != "cuda":
        raise ValueError(f"decode_matmul: no kernel for device {x.device}")
    return launch_decode(x, w, reuse)


def launch_decode(x: torch.Tensor, w: torch.Tensor,
                  reuse: int) -> torch.Tensor:
    """Launch ``decode_matmul`` on CUDA tensors (shapes and dtypes checked
    by the caller) at :func:`decode_layout`'s layout, with an f32
    workspace [chunks, M, N] where more than one split shares K."""
    dev = cuda.require("decode_matmul", x.dtype, io=("x", "w"), x=x, w=w)
    (M, K), N = x.shape, w.shape[1]
    if K == 0:
        raise ValueError("decode_matmul: K = 0")
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if M:
        bf16 = x.dtype == torch.bfloat16
        lay = decode_layout(M, K, N, reuse, bf16, w.data_ptr() % 16 == 0)
        ws = (torch.empty(lay.chunks, M, N, dtype=torch.float32, device=dev)
              if lay.splits > 1 else None)
        cuda.launch("decode_matmul", "decode_matmul", dev, x.data_ptr(),
                    w.data_ptr(), int(bf16), out.data_ptr(),
                    0 if ws is None else ws.data_ptr(), M, K, N, reuse,
                    *lay.c_args())
    return out


def decode_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """The scheduled single-step matmul: [M, K] @ [K, N] -> [M, N].

    ``schedule=None`` or ``backend="xla"`` is the plain dot; kernel
    backends run :func:`decode_matmul_kernel` at the schedule's effective
    reuse (the largest divisor of N that divides the reuse factor)."""
    if schedule is None or not schedule.use_pallas:
        return plain_dot(x, w)
    reuse = schedule.effective_reuse(w.shape[-1])
    return decode_matmul_kernel(x.contiguous(), w.contiguous(), reuse=reuse)


# ---------------------------------------------------------------------------
# Weight residency helpers (pack once per (sources, schedule key))
# ---------------------------------------------------------------------------


def _residency_key(schedule: Optional[KernelSchedule], tag: str) -> str:
    base = "none" if schedule is None else schedule.key()
    return f"decode/{tag}/{base}"


def resident_matrix(w: torch.Tensor, *, schedule: Optional[KernelSchedule],
                    dtype: Optional[torch.dtype] = None,
                    tag: str = "w") -> torch.Tensor:
    """The compute-ready 2D layout of one weight matrix, cached per (tensor
    and version, schedule key): trailing dims flattened to the matmul's N
    axis, optional dtype cast."""

    def pack():
        m = w.reshape(w.shape[0], -1)
        return (m if dtype is None else m.to(dtype)).contiguous()

    return resident(w, _residency_key(schedule, tag), pack)


def resident_fused(ws: Tuple[torch.Tensor, ...], *,
                   schedule: Optional[KernelSchedule],
                   dtype: Optional[torch.dtype] = None,
                   tag: str = "fused") -> torch.Tensor:
    """Gate-fuse several same-K weight matrices into ONE [K, sum(N_i)]
    matrix (q|k|v, gate|up), cached per (tensors and versions, schedule
    key).  Each output column of the fused product keeps its own full-K
    reduction."""

    def pack():
        m = torch.cat([w.reshape(w.shape[0], -1) for w in ws], dim=-1)
        return (m if dtype is None else m.to(dtype)).contiguous()

    return resident(tuple(ws), _residency_key(schedule, tag), pack)


# ---------------------------------------------------------------------------
# Scheduled single-step RNN decode (the paper's single-event engine)
# ---------------------------------------------------------------------------


def rnn_decode_step(cell: str, x_t: torch.Tensor, state,
                    W: torch.Tensor, U: torch.Tensor, b: torch.Tensor, *,
                    schedule: Optional[KernelSchedule] = None,
                    fp: Optional[FixedPointConfig] = None):
    """One scheduled recurrent state update.  x_t: [B, in]; state as in
    ``core.rnn.cells`` ((h, c) for LSTM, h for GRU).  Returns (h_t, state).

    On a kernel schedule the gate products ``[B, d] @ [d, G*h]`` run on
    :func:`decode_matmul` (R sequential column tiles); the cell equations
    are the cells' own.  Integral ``fp`` on a kernel schedule runs the
    native int8/int4 step (``kernels.quantized.quantized_decode_step``).
    """
    use_kernel = schedule is not None and schedule.use_pallas
    if fp is not None and is_native_int(fp) and use_kernel:
        from repro_torch.kernels.quantized import quantized_decode_step

        return quantized_decode_step(cell, x_t, state, W, U, b, fp=fp,
                                     schedule=schedule)
    mm = ((lambda a, w: decode_matmul(a, w, schedule=schedule))
          if use_kernel else None)
    if fp is not None:
        step = lstm_cell_quantized if cell == "lstm" else gru_cell_quantized
        return step(x_t, state, W, U, b, fp, matmul=mm)
    step = lstm_cell if cell == "lstm" else gru_cell
    return step(x_t, state, W, U, b, matmul=mm)
