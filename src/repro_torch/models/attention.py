"""Decode attention over a KV cache (one new token per sequence), GQA/MQA.

The port of the decode part of ``repro/models/attention.py``
(``_gqa_scores``, ``_gqa_values``, ``decode_attention`` and, for the ring
buffers of the hybrid family's local attention,
``decode_attention_masked``).  As in ``repro``
these are plain tensor ops, not a kernel: scores, the softmax and the
weighted values are computed in float32, masked entries get ``NEG_INF``
before the softmax.  Prompts reach the cache token by token through
decode, so the blockwise prefill attention is not needed here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [b, sq, h, d], k: [b, sk, hk, d] -> scores [b, h, sq, sk] (f32)."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qg = q.float().reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    return s.reshape(b, h, sq, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [b, h, sq, sk] (f32), v: [b, sk, hk, d] -> [b, sq, h, d] (f32)."""
    b, h, sq, sk = p.shape
    hk = v.shape[2]
    pg = p.reshape(b, hk, h // hk, sq, sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v.float())
    return o.reshape(b, sq, h, v.shape[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     window: int = 0) -> torch.Tensor:
    """q: [b, 1, h, d]; caches [b, S, hk, d]; cache_len [b] valid lengths.
    Masked attention over the cache, returned in q's dtype."""
    d = q.shape[-1]
    S = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] >= cache_len[:, None]              # [b,S]
    if window > 0:
        mask = mask | (pos[None, :] <= (cache_len[:, None] - 1 - window))
    return _masked_softmax_values(q, k_cache, v_cache, ~mask, scale)


def decode_attention_masked(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, valid: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention with an explicit slot-validity mask (ring buffers):
    q: [b, 1, h, d]; caches [b, S, hk, d]; valid [b, S] bool, the slots
    that take part.  Returned in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _masked_softmax_values(q, k_cache, v_cache, valid, scale)


def _masked_softmax_values(q, k_cache, v_cache, valid, scale):
    """softmax(q·k * scale) over the valid slots (the others get NEG_INF
    before the softmax), times v; float32 inside, q's dtype out."""
    # the scale is rounded to q's dtype first, as jnp treats a Python float
    q = q * float(torch.tensor(scale, dtype=q.dtype))
    s = _gqa_scores(q, k_cache)                            # [b,h,1,S] f32
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = _gqa_values(p / torch.clamp(l, min=1e-30), v_cache)  # [b,1,h,d]
    return o.to(q.dtype)
