"""int8 gradient compression with error feedback — cross-replica reduction
trick.

Across hosts the links are the scarcest bandwidth; 4x compression of the
gradient all-reduce is a standard lever.  We quantize per-tensor to int8
with a dynamic scale and carry the quantization error into the next step
(error feedback keeps SGD/Adam convergence, Seide et al. 1-bit SGD
lineage).  The port of ``repro.training.grad_compression``: the same bits
(``torch.round`` and ``jnp.round`` both round half to even).
``compress_decompress`` is a plain drop-in to measure convergence impact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(
        grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, g in grads.items():
        q, s = quantize_int8(g.float())
        out[k] = dequantize_int8(q, s).to(g.dtype)
    return out


def compress_with_error_feedback(
    grads: Dict[str, torch.Tensor],
    error: Optional[Dict[str, torch.Tensor]],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (compressed grads, new error residual)."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        gf = g.float()
        if error is not None:
            gf = gf + error[k]
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        new_g[k] = deq.to(g.dtype)
        new_e[k] = gf - deq
    return new_g, new_e
