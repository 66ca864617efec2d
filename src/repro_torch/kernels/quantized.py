"""Native int8/int4 datapath: the ``quant_matmul`` CUDA kernel's wrapper
and plain version, the packed integer weight layouts, and the native
quantized cells and scan.

Replaces ``repro/kernels/quantized.py``'s ``quant_matmul_pallas``
(int8 [M, K] @ int8 [K, N] -> exact int32, the N columns in R sequential
tiles in-block); the kernel lives in ``csrc/quantized.cu``, tiled over
rows, columns and K on the int8 tensor cores.  The integral configs
(``is_native_int``: signed, rnd, sat, <= 8 total bits) run genuinely
low-precision:

  * weights pack to int8 grid indices (int4 configs nibble-pack two
    weights per byte along K) once per scan call, ahead of the time loop,
    and unpack to int8 before the kernel, as ``repro`` does;
  * gate products run int8 x int8 -> int32 on ``quant_matmul``;
  * the int32 accumulator (scale 2^2F) is rescaled once, and the quantized
    cells of ``core/rnn/cells.py`` run with this product as their
    ``matmul``, so the activation / Hadamard steps and every quantization
    point are the emulation's own code.

Numerical contract: ``native_matmul`` returns ``(a_int @ w_int) / scale^2``
with the division EXACT in f32 (int8 products are <= 2^14 and the K-sums of
tagger fan-ins stay far below 2^24), so the native gate pre-activation is
bit-identical to the emulation's f32 product of the same on-grid operands.
Hence native == emulation bit for bit on the same device whenever the
weights are already on the fp grid (PTQ'd).

Quantized datapaths never hoist (splitting z = q(xW + hU + b) would move
the hls4ml quantization points), so every schedule mode runs the same
per-timestep structure; the reuse factor still tiles the kernel's output
columns.

The kernel wrapper dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

from repro_torch.config import FixedPointConfig
from repro_torch.core.quant.fixed_point import (from_ints, grid_constants,
                                                is_native_int, native_bits,
                                                quantize, to_ints)
from repro_torch.core.rnn.cells import (gru_cell_quantized,
                                        lstm_cell_quantized,
                                        quantized_cell_scan)
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.schedule import KernelSchedule, schedule_key

# ---------------------------------------------------------------------------
# Packed integer weight layouts
# ---------------------------------------------------------------------------


def pack_ints(w: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """Quantize a float [K, N] weight matrix to its packed int8 layout.

    int8 grids store one weight per byte.  int4 grids nibble-pack two
    K-adjacent weights per byte (low nibble = even row, high nibble = odd
    row; odd K pads a zero row), so the packed array is [ceil(K/2), N]:
    1/8 of the f32 bytes (``packed_weight_bytes``).
    """
    q = to_ints(w, fp)
    if native_bits(fp) == 8:
        return q
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))])
    qi = q.to(torch.int32) & 0xF             # two's-complement nibbles
    return (qi[0::2] | (qi[1::2] << 4)).to(torch.int8)


def unpack_ints(packed: torch.Tensor, fp: FixedPointConfig,
                k: int) -> torch.Tensor:
    """Packed layout -> int8 grid indices [k, N] (inverse of pack_ints)."""
    if native_bits(fp) == 8:
        return packed
    b = packed.to(torch.int32) & 0xFF
    lo = b & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)   # sign-extend the 4-bit field
    hi = (b >> 4) & 0xF
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(packed.shape[1:]))
    return out[:k].to(torch.int8)


def packed_nbytes(packed: Union[torch.Tensor, Iterable[torch.Tensor]]) -> int:
    """Measured bytes of a packed layout (one tensor or several)."""
    if isinstance(packed, torch.Tensor):
        packed = (packed,)
    return sum(t.numel() * t.element_size() for t in packed)


# ---------------------------------------------------------------------------
# The int32-accumulating scheduled matmul kernel
# ---------------------------------------------------------------------------


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                       reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`quant_matmul_kernel`: the R column tiles as
    float64 products, exact while |acc| < 2^53 (int32 products are not
    implemented on CUDA)."""
    ns = w.shape[1] // reuse
    x64 = x.double()
    tiles = [x64 @ w[:, r * ns:(r + 1) * ns].double() for r in range(reuse)]
    return torch.cat(tiles, dim=-1).to(torch.int32)


def quant_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                        reuse: int = 1) -> torch.Tensor:
    """x: [M, K] int8 @ w: [K, N] int8 -> [M, N] int32, exact, the N
    columns in ``reuse`` sequential tiles (``reuse`` must divide N).  The
    kernel stages only the tiles it multiplies, so any K x N weight runs."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not a matrix product")
    (M, K), N = x.shape, w.shape[1]
    if reuse < 1 or N % reuse:
        raise ValueError(f"quant_matmul: reuse {reuse} does not divide {N}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, reuse=reuse)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    dev = cuda.require_int8("quant_matmul", x=x, w=w)
    out = torch.empty(M, N, dtype=torch.int32, device=dev)
    if M:
        cuda.launch("quantized", "quant_matmul", dev, x.data_ptr(),
                    w.data_ptr(), out.data_ptr(), M, K, N, reuse)
    return out


def _int_matmul(ai: torch.Tensor, wq: torch.Tensor,
                schedule: Optional[KernelSchedule]) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, scheduled.  Kernel backends run
    the in-block reuse-tiled kernel (it takes any M: no row padding); the
    xla backend (and schedule=None) keep the exact integer reference."""
    if schedule is None or not schedule.use_pallas:
        return ref.int_matmul_ref(ai, wq)
    re = schedule.effective_reuse(wq.shape[-1])
    return quant_matmul_kernel(ai.contiguous(), wq.contiguous(), reuse=re)


def native_int_matmul(a: torch.Tensor, wq: torch.Tensor,
                      fp: FixedPointConfig,
                      schedule: Optional[KernelSchedule] = None
                      ) -> torch.Tensor:
    """The native gate product on already unpacked int8 weights ``wq``:
    quantize ``a`` to ints, int32-accumulate, rescale by 1/scale^2."""
    acc = _int_matmul(to_ints(a, fp), wq, schedule)
    scale, _, _ = grid_constants(fp)
    return acc.float() * (1.0 / (scale * scale))


def native_matmul(a: torch.Tensor, w: torch.Tensor, fp: FixedPointConfig, *,
                  schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """The native gate matmul: quantize-to-ints, int32-accumulate, rescale.

    ``a`` [M, K] holds on-grid activations (the quantized cells quantize
    every input before the matmul, so ``to_ints`` is exact); ``w`` is the
    float weight matrix, PTQ'd to ints by the packer.  Returns
    ``(a_int @ w_int) / scale^2`` as f32: EXACT for int8/int4 ranges, i.e.
    bit-identical to the emulation's f32 ``a @ quantize(w)``.
    """
    wq = unpack_ints(pack_ints(w, fp), fp, w.shape[0])
    return native_int_matmul(a, wq, fp, schedule)


# ---------------------------------------------------------------------------
# Scheduled entry points (what ops.py dispatches to for integral fp)
# ---------------------------------------------------------------------------


def quantized_scan(cell: str, xs, W, U, b, *, fp: FixedPointConfig,
                   schedule: KernelSchedule) -> torch.Tensor:
    """[B, T, in] -> final hidden [B, h] on the native integer datapath.

    W and U pack once per call, ahead of the time loop, and unpack to int8
    grid indices; then every timestep runs the native cell: on-grid f32
    state and activations, int32-accumulated gate products on
    ``quant_matmul`` (2 launches per step).  All modes share the
    per-timestep structure: quantized datapaths never hoist.
    """
    if not is_native_int(fp):
        raise ValueError(f"quantized_scan: {fp} is not a native int config")
    Wq = unpack_ints(pack_ints(W, fp), fp, W.shape[0])
    Uq = unpack_ints(pack_ints(U, fp), fp, U.shape[0])
    return quantized_cell_scan(
        cell, xs, Wq, Uq, b, fp,
        matmul=lambda a, w: native_int_matmul(a, w, fp, schedule))


def quantized_decode_step(cell: str, x_t, state, W, U, b, *,
                          fp: FixedPointConfig,
                          schedule: Optional[KernelSchedule] = None):
    """One native single-event state update (``rnn_decode_step``'s route
    for integral configs on a kernel schedule): the quantized cell of
    ``core/rnn/cells.py`` with the int32-accumulated gate product
    (``quant_matmul``, 2 launches) as its ``matmul``.  W and U pack to
    int8 grid indices once per (tensor and version, fp) through the
    residency cache, not once per step."""
    from repro_torch.kernels.ops import resident   # ops imports this module

    if not is_native_int(fp):
        raise ValueError(f"quantized_decode_step: {fp} is not a native int "
                         f"config")
    key = f"native-int/{schedule_key(None, fp)}"
    Wq, Uq = (resident(w, key, lambda w=w: unpack_ints(pack_ints(w, fp), fp,
                                                       w.shape[0]))
              for w in (W, U))
    step = lstm_cell_quantized if cell == "lstm" else gru_cell_quantized
    return step(x_t, state, Wq, Uq, b, fp,
                matmul=lambda a, w: native_int_matmul(a, w, fp, schedule))


def quantized_rglru_scan(a, bx, *, fp: FixedPointConfig,
                         schedule: KernelSchedule) -> torch.Tensor:
    """Native RG-LRU: a, bx [B, T, W] -> all states [B, T, W] in a's dtype.

    The recurrence has no product of matrices, so it runs on int32 grid
    indices with torch's integer ops, as the JAX package runs it on XLA's
    (it has no Pallas kernel here): ``acc = a_i * h + (bx_i << F)`` lands on
    the 2^2F grid, and ``h = clip(round(acc / 2^F), lo, hi)`` requantizes
    it, round-half-even through an exact f32 round (|acc| <= 2^15, far
    below 2^24).  Every step is exact, so the result equals the numpy
    integer golden model bit for bit; a zero state comes out as +0.0
    (``from_ints``).  The schedule changes nothing here."""
    if not is_native_int(fp):
        raise ValueError(f"quantized_rglru_scan: {fp} is not a native int "
                         f"config")
    B, T, W = a.shape
    scale, lo, hi = grid_constants(fp)
    F = fp.fractional_bits
    ai = to_ints(a, fp).to(torch.int32)          # grid indices, scale 2^F
    bi = to_ints(bx, fp).to(torch.int32)
    h = torch.zeros(B, W, dtype=torch.int32, device=a.device)
    hs = []
    for t in range(T):
        acc = ai[:, t] * h + (bi[:, t] << F)
        h = torch.clamp(torch.round(acc.float() * (1.0 / scale)), lo,
                        hi).to(torch.int32)
        hs.append(h)
    return from_ints(torch.stack(hs, dim=1), fp, a.dtype)


def quantized_reuse_matmul(x, w, *, fp: FixedPointConfig,
                           schedule: Optional[KernelSchedule] = None
                           ) -> torch.Tensor:
    """Native scheduled matmul: q(x) and PTQ'd w multiply as integers, the
    int32 accumulator requantizes ONCE to the fp grid (z = q(xW), the
    dense-layer gate boundary).  The reuse factor serializes output column
    tiles in-block (the float kernel's K-split reuse has no integer
    analogue without double-rounding the accumulator)."""
    if not is_native_int(fp):
        raise ValueError(f"quantized_reuse_matmul: {fp} is not a native "
                         f"int config")
    xq = quantize(x.float(), fp)
    out = native_matmul(xq, w, fp, schedule=schedule)
    return quantize(out, fp).to(x.dtype)
