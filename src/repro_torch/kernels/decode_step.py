"""Single-step decode: the ``decode_matmul`` CUDA kernel's wrapper and
plain version, the weight-residency helpers, and the scheduled RNN decode
step.

Replaces ``repro/kernels/decode_step.py``'s ``decode_matmul_pallas``
(``[M, K] @ [K, N]``, both f32 or both bf16, the N columns in R
sequential passes, the weight resident); the kernel lives in
``csrc/decode_matmul.cu``.  It spreads the columns over a grid of (row
tiles x column blocks) instead of the TPU's grid over row tiles only, and
takes any M (no row padding).  The TPU's alignment check
(``check_tpu_alignment``) is not ported.

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

from typing import Optional, Tuple

import torch

from repro_torch.config import FixedPointConfig
from repro_torch.core.quant.fixed_point import is_native_int
from repro_torch.core.rnn.cells import (gru_cell, gru_cell_quantized,
                                        lstm_cell, lstm_cell_quantized)
from repro_torch.kernels import cuda
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
    float32 products, the result rounded once to the inputs' dtype."""
    ns = w.shape[1] // reuse
    x32 = x.float()
    tiles = [x32 @ w[:, r * ns:(r + 1) * ns].float() for r in range(reuse)]
    return torch.cat(tiles, dim=-1).to(x.dtype)


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
    dev = cuda.require("decode_matmul", x.dtype, io=("x", "w"), x=x, w=w)
    if K == 0:
        raise ValueError("decode_matmul: K = 0")
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if M:
        cuda.launch("decode_matmul", "decode_matmul", dev, x.data_ptr(),
                    w.data_ptr(), int(x.dtype == torch.bfloat16),
                    out.data_ptr(), M, K, N, reuse)
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
