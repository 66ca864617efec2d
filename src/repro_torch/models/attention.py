"""Attention, GQA/MQA: blockwise (memory-linear) causal, local and
bidirectional attention over a whole sequence, full (einsum) attention, and
decode attention over a KV cache (one new token per sequence).

The port of ``repro/models/attention.py``.  As in ``repro`` these are plain
tensor ops, not a kernel: scores, the softmax and the weighted values are
computed in float32 (bfloat16 inputs are upcast before each product, which
is what ``preferred_element_type=float32`` computes), masked entries get
``NEG_INF``.

``blockwise_attention`` keeps ``repro``'s schedule: q scaled (and rounded
back to its dtype) once, q and k/v padded to chunk multiples, a Python
loop over q chunks, each attending to its causal kv prefix only (``hi``
chunks: the triangular FLOP count), with an online-softmax merge of f32
accumulators (m, l, o) over the kv chunks, where ``repro`` runs a
``lax.scan``.  Its sequence-parallel variant is
``transformer._sp_attention``, which a sharding context in mode 'sp'
selects.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import weak_scale

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


def _chunk_scores_block(q, k, v, bias):
    """One (q-chunk, kv-chunk) block -> (scores max, exp sum, weighted v)."""
    s = _gqa_scores(q, k)                                  # [b,h,cq,ck] f32
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)                                     # [b,h,cq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                      # [b,h,cq]
    o = _gqa_values(p, v)                                  # [b,cq,h,d] f32
    return m, l, o


def _merge(acc, m, l, o):
    """Online-softmax merge of a new block into (m_acc, l_acc, o_acc)."""
    m_acc, l_acc, o_acc = acc
    m_new = torch.maximum(m_acc, m)
    c_old = torch.exp(m_acc - m_new)
    c_new = torch.exp(m - m_new)
    l_new = l_acc * c_old + l * c_new
    # o carried as [b, cq, h, d]; the coefficients are [b, h, cq]
    co = c_old.permute(0, 2, 1)[..., None]
    cn = c_new.permute(0, 2, 1)[..., None]
    return m_new, l_new, o_acc * co + o * cn


def _finalize(m, l, o):
    li = (1.0 / torch.clamp(l, min=1e-30)).permute(0, 2, 1)[..., None]
    return o * li


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, scale: Optional[float] = None,
                        chunk_q: int = 1024, chunk_kv: int = 2048,
                        window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Memory-linear attention.  q: [b, sq, h, d], k / v: [b, sk, hk, d] ->
    [b, sq, h, d] in q's dtype.

    ``causal`` runs the triangular schedule (each q chunk sees its kv
    prefix only); ``window > 0`` also masks keys ``window`` or more
    positions back; ``q_offset`` is the absolute position of q[0]
    relative to k[0]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q = weak_scale(q, scale)

    cq = min(chunk_q, sq)
    ck = min(chunk_kv, sk)
    nq = -(-sq // cq)
    pad_q = nq * cq - sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nk = -(-sk // ck)
    pad_k = nk * ck - sk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))

    dev = q.device
    q_pos_base = torch.arange(cq, device=dev)
    k_pos_base = torch.arange(ck, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        q_pos = q_pos_base + i * cq + q_offset
        # the kv prefix this q chunk can see (exact FLOPs)
        if causal:
            hi = max(min(nk, -(-(i * cq + cq + q_offset) // ck)), 1)
        else:
            hi = nk
        acc = (torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                          device=dev),
               torch.zeros((b, h, cq), dtype=torch.float32, device=dev),
               torch.zeros((b, cq, h, d), dtype=torch.float32, device=dev))
        for j in range(hi):
            k_pos = k_pos_base + j * ck
            bias = zero.expand(cq, ck)
            if causal:
                bias = torch.where(k_pos[None, :] > q_pos[:, None], neg,
                                   bias)
            if window > 0:
                bias = torch.where(
                    k_pos[None, :] <= q_pos[:, None] - window, neg, bias)
            if pad_k:
                bias = torch.where(k_pos[None, :] >= sk, neg, bias)
            acc = _merge(acc, *_chunk_scores_block(
                qi, k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck],
                bias[None, None]))
        outs.append(_finalize(*acc))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, scale: Optional[float] = None,
                   window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Full (einsum) attention, the reference of the blockwise schedule:
    q: [b, sq, h, d], k / v: [b, sk, hk, d] -> [b, sq, h, d] in q's
    dtype."""
    sq, sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _gqa_scores(weak_scale(q, scale), k)                 # [b,h,sq,sk]
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        s = torch.where(k_pos[None, :] > q_pos[:, None], neg, s)
    if window > 0:
        s = torch.where(k_pos[None, :] <= q_pos[:, None] - window, neg, s)
    return _gqa_values(torch.softmax(s, dim=-1), v).to(q.dtype)


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
    q = weak_scale(q, scale)
    s = _gqa_scores(q, k_cache)                            # [b,h,1,S] f32
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = _gqa_values(p / torch.clamp(l, min=1e-30), v_cache)  # [b,1,h,d]
    return o.to(q.dtype)
