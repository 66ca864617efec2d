"""Bit-accurate ap_fixed<W,I> emulation (the paper's quantization scheme).

hls4ml represents every weight, bias, activation and accumulator as a
fixed-point number with W total bits, I integer bits (signed by default),
round-to-nearest (RND) and saturation (SAT).  We emulate by scaling to the
integer grid, rounding, saturating, and rescaling.

The port's own copy of the JAX package's ``core/quant/fixed_point.py``:
:func:`quantize` works on tensors (any device), :func:`quantize_np` on
numpy arrays in float64; both agree bit for bit with the JAX package's
quantizers.  The CUDA kernel of the same function is
``kernels/fixed_point.py``.

Exactness: the integer grid is exact while |x|*2^F < 2^24 (f32 mantissa).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import FixedPointConfig


def grid_constants(fp: FixedPointConfig) -> Tuple[float, float, float]:
    """The single source of the (scale, lo, hi) grid derivation.

    ``q = clamp(round_or_floor(x * scale), lo, hi) / scale``: lo/hi are the
    INTEGER rails of the ap_fixed grid (e.g. signed W=8: [-128, 127]).
    Every quantizer of the port (host, tensor, the CUDA kernel and the
    native-int packers) derives its grid from here.
    """
    scale = fp.scale
    return scale, fp.min_value * scale, fp.max_value * scale


def _apply_grid(y, fp: FixedPointConfig, xp):
    """Round + saturate/wrap ``y`` (already scaled to the integer grid)
    with the ``xp`` namespace (``torch`` or ``numpy``)."""
    if fp.rounding == "rnd":
        y = xp.round(y)                  # round-half-even (IEEE default)
    else:  # trn: truncate toward -inf (hls4ml AP_TRN)
        y = xp.floor(y)
    _, lo, hi = grid_constants(fp)
    if fp.saturation == "sat":
        y = xp.clip(y, lo, hi)
    else:  # wrap (AP_WRAP): modular arithmetic, floored modulo
        span = 2.0 ** fp.total_bits
        y = (xp.remainder if xp is torch else xp.mod)(y - lo, span) + lo
    return y


def quantize(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """Quantize to the ap_fixed grid (returns same dtype, values on grid)."""
    dt = x.dtype
    y = _apply_grid(x.float() * fp.scale, fp, torch)
    return (y / fp.scale).to(dt)


def quantize_np(x: np.ndarray, fp: FixedPointConfig) -> np.ndarray:
    """Exact host-side quantization in float64 (used for PTQ of weights)."""
    y = _apply_grid(np.asarray(x, np.float64) * fp.scale, fp, np)
    return (y / fp.scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Native integer execution (the int8/int4 kernel datapath)
# ---------------------------------------------------------------------------


def is_native_int(fp: Optional[FixedPointConfig]) -> bool:
    """True when ``fp`` selects the NATIVE integer datapath
    (kernels/quantized.py): signed round-to-nearest saturating grids up to
    8 total bits, whose products (<= 2^14) and gate-sum accumulators
    (<= ~2^21 for tagger fan-ins) fit int32.  Everything else (wider words,
    trn, wrap, unsigned) runs the f32 emulation."""
    return (fp is not None and fp.total_bits <= 8 and fp.signed
            and fp.rounding == "rnd" and fp.saturation == "sat")


def native_bits(fp: FixedPointConfig) -> int:
    """Storage width of the native path: 4 (nibble-packed) or 8."""
    return 4 if fp.total_bits <= 4 else 8


def to_ints(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """Quantize onto the integer grid and return the INT8 grid indices
    (``round(q * scale)``).  Exact (no extra rounding) when ``x`` is already
    on the grid: the native datapath's activation/state representation."""
    scale, lo, hi = grid_constants(fp)
    y = torch.clamp(torch.round(x.float() * scale), lo, hi)
    return y.to(torch.int8)


def from_ints(i: torch.Tensor, fp: FixedPointConfig,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`to_ints`: grid indices -> on-grid real values."""
    return (i.float() / fp.scale).to(dtype)


def packed_weight_bytes(k: int, n: int,
                        fp: Optional[FixedPointConfig]) -> int:
    """Bytes of one [k, n] weight matrix under ``fp``.  float / emulated
    fp: f32 items (4 bytes).  Native int8: one byte per weight.  Native
    int4: two weights per byte, nibble-packed along k (odd k pads one
    row)."""
    if not is_native_int(fp):
        return 4 * k * n
    if native_bits(fp) == 8:
        return k * n
    return math.ceil(k / 2) * n


def quantize_params(params: Mapping[str, object], fp: FixedPointConfig,
                    skip_substrings: tuple = ()) -> Dict[str, torch.Tensor]:
    """Post-training quantization of a parameter dict (host-side, exact in
    float64).  Tensors keep their device; numpy arrays come back as CPU
    float32 tensors."""
    out = {}
    for k, v in params.items():
        if any(s in k for s in skip_substrings):
            out[k] = v
            continue
        if isinstance(v, torch.Tensor):
            q = quantize_np(v.detach().cpu().numpy(), fp)
            out[k] = torch.from_numpy(q).to(v.device)
        else:
            out[k] = torch.from_numpy(quantize_np(np.asarray(v), fp))
    return out


def fixed_point_error_bound(fp: FixedPointConfig) -> float:
    """Max rounding error of a single quantization (half a grid step)."""
    return 0.5 / fp.scale


def saturates(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """Fraction of entries that hit the saturation rails (diagnostic)."""
    xf = x.float()
    return ((xf > fp.max_value) | (xf < fp.min_value)).float().mean()
