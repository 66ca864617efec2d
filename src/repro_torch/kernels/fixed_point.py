"""ap_fixed<W,I> quantization: the CUDA kernel's wrapper and plain version.

Replaces ``repro/kernels/fixed_point.py``'s ``fixed_point_pallas``: the
hls4ml fixed-point datapath stage, elementwise over a float32 or bfloat16
tensor, output in the input's dtype.  The kernel lives in
``csrc/quantized.cu`` (on the streaming body of
``csrc/stream_elementwise.cuh``); it takes the grid of ``grid_constants``
(scale and integer rails) and the rounding and saturation modes as
arguments and agrees bit for bit with
:func:`repro_torch.core.quant.fixed_point.quantize`, which is its plain
version.

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version; any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.config import FixedPointConfig
from repro_torch.core.quant.fixed_point import grid_constants, quantize
from repro_torch.kernels import cuda


def fixed_point_plain(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """Plain version of :func:`fixed_point_kernel`."""
    return quantize(x, fp)


def edge_values(fp: FixedPointConfig) -> torch.Tensor:
    """float32 values where a quantizer to ``fp``'s grid is most exposed:
    +-0, NaN, +-inf, ties at .5 (around 0 and each rail), the rails and
    values just past them (by one f32 ulp and by one grid step), |x *
    2^F| at and past 2^24 and near the f32 maximum, and f32 subnormals
    (the smallest, the largest, one between)."""
    scale, lo, hi = grid_constants(fp)
    f32 = torch.float32
    rails = torch.tensor([lo, hi], dtype=f32) / scale
    ulp_past = torch.nextafter(rails, torch.tensor([-float("inf"),
                                                    float("inf")]))
    ties = [(k + 0.5) / scale for k in (-3, -2, -1, 0, 1, 2)]
    ties += [(r + d) / scale for r in (lo, hi) for d in (-0.5, 0.5)]
    big = [s * m * 2.0 ** 24 / scale for s in (1, -1) for m in (1, 1.5, 3)]
    tiny = torch.finfo(f32).tiny
    vals = torch.tensor(
        [0.0, -0.0, float("nan"), float("inf"), -float("inf"),
         (lo - 1) / scale, (hi + 1) / scale, 3e38, -3e38, 1e30, -1e30,
         *ties, *big, tiny * (1 - 2 ** -23), -tiny * (1 - 2 ** -23),
         1e-40, -1e-40, 2 ** -149, -2 ** -149], dtype=f32)
    return torch.cat([vals, rails, ulp_past])


def fixed_point_kernel(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """x: any shape, float32 or bfloat16 -> quantized to the
    ap_fixed<total, integer> grid, same shape and dtype."""
    if fp.rounding not in ("rnd", "trn") or fp.saturation not in ("sat",
                                                                  "wrap"):
        raise ValueError(f"fixed_point: no mode {fp.rounding}/{fp.saturation}")
    if x.device.type == "cpu":
        return fixed_point_plain(x, fp)
    if x.device.type != "cuda":
        raise ValueError(f"fixed_point: no kernel for device {x.device}")
    dev = cuda.require("fixed_point", x.dtype, io=("x",), x=x)
    out = torch.empty_like(x)
    if x.numel():
        scale, lo, hi = grid_constants(fp)
        cuda.launch("quantized", "fixed_point", dev, x.data_ptr(),
                    int(x.dtype == torch.bfloat16), out.data_ptr(),
                    x.numel(), scale, lo, hi, int(fp.rounding == "rnd"),
                    int(fp.saturation == "sat"), 2.0 ** fp.total_bits)
    return out
