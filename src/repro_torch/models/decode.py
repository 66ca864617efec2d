"""Single-token decode for every LM family: the paper's "static mode"
state update at LM scale (the state is resident: a KV cache, an SSM state,
an LRU state and a local-attention ring; one step processes each new
token).  A hybrid may hold two kinds side by side: granite-4.0-h-micro's
Mamba-2 layers keep an SSM state and a conv tail, its attention layers a
full-length KV cache, in one cache dict.

The port of ``repro/models/decode.py``:

  * ``schedule=None`` is the einsum path (plain tensor ops, a Python loop
    over the stacked layer weights in place of ``lax.scan``);
  * for the families whose step is matmul-shaped (dense and vlm:
    :func:`decode_schedulable`), a schedule routes every per-token
    projection (fused q|k|v, o, fused gate|up or up, down) through
    ``kernels.decode_step.decode_matmul`` over the weight-resident layout
    of :func:`pack_decode_params`; on a kernel backend that is the
    ``decode_matmul`` CUDA kernel, 4 launches per layer and token step.
    Norms, rotary embeddings, attention over the cache and the unembedding
    stay plain tensor ops, as ``repro`` leaves them to XLA outside any
    kernel.
  * moe (routed experts, ``models/moe.py``), ssm (``models/ssm.py``),
    hybrid (Griffin's RG-LRU and ring-buffer local attention,
    ``models/rglru.py``; or Mamba-2 and NoPE full attention with Granite's
    scalars, ``cfg.pattern``) and enc-dec (sinusoidal positions, self- and
    cross-attention) accept a schedule and ignore it, as ``repro`` does:
    their per-token math is einsums and elementwise ops outside any Pallas
    kernel.

``decode_steps`` is the speculative verify pass: S tokens a row in one
pass with the bits of S sequential steps (dense and vlm under a kernel
schedule: each projection once over [B*S, d], ``_dense_steps`` says why;
every other case unrolls the sequential step), and ``kv_trim`` rolls the
KV cache back to the accepted prefix.  ``lm_params_from_jax`` carries
``repro``'s flat LM parameters over, dtypes kept.  A whole prompt in one
pass is ``transformer.forward`` (``Model.forward``); as in ``repro``, no
decode entry point fills a cache from it: the serving engine teacher-
forces prompts through decode, and whisper's ``cache/xk`` / ``cache/xv``
are the caller's (``transformer._encode`` computes the encoder).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_step import decode_matmul
from repro_torch.kernels.ops import resident
from repro_torch.kernels.schedule import KernelSchedule
from repro_torch.models import transformer as tf
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_masked)
from repro_torch.models.init import ParamSpec, ParamSpecs
from repro_torch.models.layers import (ACTIVATIONS, apply_rope,
                                      attention_scale, embed, embed_scale,
                                      norm, residual_scale, uses_rope,
                                      weak_scale)
from repro_torch.models.mlp import glu_activation, mlp
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import rglru_decode_step
from repro_torch.models.ssm import ssm_decode_step, ssm_dims
from repro_torch.sharding.api import constrain

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                cache_dtype: str = "bfloat16") -> ParamSpecs:
    """The decode state of ``cfg``'s family, all zeros at the start:

      * dense / moe / vlm: ``cache/k`` and ``cache/v``, each [L, batch,
        max_len, kv_heads, head_dim];
      * ssm: ``cache/state`` [L, batch, heads, head_dim, d_state] (float32)
        and ``cache/conv`` [L, batch, d_conv-1, conv_dim];
      * hybrid: per block of the pattern, ``cache/hyb{j}_*`` stacked over
        the super-blocks and ``cache/hybrem{j}_*`` for a remainder layer:
        an RG-LRU's ``_state`` [.., batch, width] (float32) and ``_conv``,
        a local-attention ring's ``_k`` / ``_v`` [.., batch, W, kv_heads,
        head_dim] and ``_pos`` [.., batch, W] (int32, position + 1; 0 is
        empty), W = min(window, max_len); a Mamba-2 block's ``_state``
        [.., batch, heads, head_dim, d_state] (float32) and ``_conv``
        [.., batch, d_conv-1, conv_dim]; a full-attention block's ``_k`` /
        ``_v`` [.., batch, max_len, kv_heads, head_dim];
      * enc-dec: the decoder's ``cache/k`` / ``cache/v`` and the encoder's
        ``cache/xk`` / ``cache/xv``, each [L_dec, batch, max_len,
        kv_heads, head_dim]."""
    tf.require_lm(cfg, "cache_specs")
    L, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads_r", "head_dim")
    specs: ParamSpecs = {}
    if cfg.family == "ssm":
        _, h, conv_dim = ssm_dims(cfg)
        s = cfg.ssm
        specs["cache/state"] = ParamSpec(
            (L, batch, h, s.head_dim, s.d_state), "zeros", "float32",
            logical_axes=("layers", "batch", "ssm_heads", None, None))
        specs["cache/conv"] = ParamSpec(
            (L, batch, s.d_conv - 1, conv_dim), "zeros", cache_dtype,
            logical_axes=("layers", "batch", None, "ssm_inner"))
        return specs
    if cfg.family == "hybrid":
        rg = cfg.rglru
        pattern = cfg.hybrid_pattern
        n_super, rem = divmod(cfg.n_layers, len(pattern))
        groups = [(f"cache/hyb{j}", kind, (n_super, batch))
                  for j, kind in enumerate(pattern)]
        groups += [(f"cache/hybrem{j}", pattern[j], (batch,))
                   for j in range(rem)]
        for pre, kind, lead in groups:
            la = ("layers", "batch")[-len(lead):]
            if kind == "mamba":
                _, h, conv_dim = ssm_dims(cfg)
                s = cfg.ssm
                specs[f"{pre}_state"] = ParamSpec(
                    lead + (h, s.head_dim, s.d_state), "zeros", "float32",
                    logical_axes=la + ("ssm_heads", None, None))
                specs[f"{pre}_conv"] = ParamSpec(
                    lead + (s.d_conv - 1, conv_dim), "zeros", cache_dtype,
                    logical_axes=la + (None, "ssm_inner"))
            elif kind == "attn":
                for n in ("k", "v"):
                    specs[f"{pre}_{n}"] = ParamSpec(
                        lead + (max_len, hk, hd), "zeros", cache_dtype,
                        logical_axes=la + ("kv_seq", "kv_heads_r",
                                           "head_dim"))
            elif kind == "rglru":
                w = rg.lru_width or cfg.d_model
                specs[f"{pre}_state"] = ParamSpec(
                    lead + (w,), "zeros", "float32",
                    logical_axes=la + ("lru_width",))
                specs[f"{pre}_conv"] = ParamSpec(
                    lead + (rg.conv_width - 1, w), "zeros", cache_dtype,
                    logical_axes=la + (None, "lru_width"))
            else:
                W = min(rg.window, max_len)
                for n in ("k", "v"):
                    specs[f"{pre}_{n}"] = ParamSpec(
                        lead + (W, hk, hd), "zeros", cache_dtype,
                        logical_axes=la + ("kv_seq", "kv_heads_r",
                                           "head_dim"))
                specs[f"{pre}_pos"] = ParamSpec(
                    lead + (W,), "zeros", "int32",
                    logical_axes=la + ("kv_seq",))
        return specs
    if cfg.enc_dec:
        shape = (cfg.n_decoder_layers, batch, max_len, hk, hd)
        return {k: ParamSpec(shape, "zeros", cache_dtype,
                             logical_axes=kv_axes)
                for k in ("cache/k", "cache/v", "cache/xk", "cache/xv")}
    shape = (L, batch, max_len, hk, hd)
    return {"cache/k": ParamSpec(shape, "zeros", cache_dtype,
                                 logical_axes=kv_axes),
            "cache/v": ParamSpec(shape, "zeros", cache_dtype,
                                 logical_axes=kv_axes)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               cache_dtype: str = "bfloat16",
               device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """An all-zeros cache of :func:`cache_specs` on ``device``."""
    return {k: torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                           device=device)
            for k, s in cache_specs(cfg, batch, max_len, cache_dtype).items()}


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _layer(stacked: Dict, l: int) -> Dict:
    """Layer ``l`` of a stacked [L, ...] parameter group (views)."""
    return {k: v[l] for k, v in stacked.items()}


def _update_cache(cache_l: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """cache_l: [b, S, hk, hd]; new: [b, 1, hk, hd]; pos: [b].  A masked
    write (``repro``'s one-hot select); the cache is not updated in
    place."""
    S = cache_l.shape[1]
    sel = torch.arange(S, device=cache_l.device)[None, :] == pos[:, None]
    return torch.where(sel[..., None, None], new.to(cache_l.dtype), cache_l)


def _ring_write_pos(pos_l: torch.Tensor, slot: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """pos_l: [b, W] stores (absolute position + 1); 0 = empty slot.  The
    slot's entry is written in pos_l's own dtype."""
    sel = (torch.arange(pos_l.shape[1], device=pos_l.device)[None, :]
           == slot[:, None])
    return torch.where(sel, (pos[:, None] + 1).to(pos_l.dtype), pos_l)


def _qkv(cfg: ModelConfig, x, p, pre, pos, rope=True):
    q = torch.einsum("bsd,dhk->bshk", x, p[f"{pre}/wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p[f"{pre}/wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p[f"{pre}/wv"].to(x.dtype))
    if rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def _attn_decode(cfg: ModelConfig, x, p, pre, ck, cv, pos, window=0,
                 rope=True):
    """x: [b,1,d] pre-normed.  Returns (out [b,1,d], new_ck, new_cv).
    No rotary embeddings under Granite's NoPE; its softmax scale where it
    has one."""
    q, k, v = _qkv(cfg, x, p, pre, pos, rope and uses_rope(cfg))
    ck = _update_cache(ck, k, pos)
    cv = _update_cache(cv, v, pos)
    ck = constrain(ck, "batch", "kv_seq", "kv_heads_r", "head_dim")
    cv = constrain(cv, "batch", "kv_seq", "kv_heads_r", "head_dim")
    o = decode_attention(q, ck.to(x.dtype), cv.to(x.dtype), pos + 1,
                         scale=attention_scale(cfg), window=window)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype),
                       p[f"{pre}/wo"].to(x.dtype))
    return out, ck, cv


def _local_attn_decode(cfg: ModelConfig, x, p, pre, ck, cv, cpos, pos,
                       window: int):
    """Ring-buffer windowed attention decode (Griffin's local layers).
    x: [b, 1, d] pre-normed; ck / cv: [b, W, hk, hd]; cpos: [b, W].
    Returns (out [b, 1, d], ck, cv, cpos)."""
    q, k, v = _qkv(cfg, x, p, pre, pos, rope=True)
    slot = torch.remainder(pos, ck.shape[1])
    # a ring write is the KV cache's masked write at the slot
    ck = _update_cache(ck, k, slot)
    cv = _update_cache(cv, v, slot)
    cpos = _ring_write_pos(cpos, slot, pos)
    # slots hold pos+1 (0 = never written); window mask on absolute position
    valid = ((cpos > 0) & (cpos <= pos[:, None] + 1)
             & (cpos > pos[:, None] + 1 - window))
    o = decode_attention_masked(q, ck.to(x.dtype), cv.to(x.dtype), valid)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype),
                       p[f"{pre}/wo"].to(x.dtype))
    return out, ck, cv, cpos


def _sinusoid(cfg: ModelConfig, x: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """x + whisper's sinusoidal position embedding at each row's pos."""
    d = cfg.d_model
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)[None]
    ang = pos[:, None].float() / torch.pow(10000.0, dim / d)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]
    return x + pe[:, None, :].to(x.dtype)


# ---------------------------------------------------------------------------
# Schedule-driven decode: fused, weight-resident dense-decoder step
# ---------------------------------------------------------------------------


def decode_schedulable(cfg: ModelConfig) -> bool:
    """Families whose per-token hot path is matmul-shaped and therefore
    runs the scheduled kernel path: the dense decoder stack (dense / vlm).
    MoE routing, SSM and RG-LRU state updates, the hybrid block pattern
    and enc-dec cross-attention keep the einsum path (a schedule is
    accepted and ignored), as in ``repro``."""
    return cfg.family in ("dense", "vlm") and not cfg.enc_dec


def pack_decode_params(cfg: ModelConfig, params: Dict) -> Dict:
    """The weight-resident decode layout, packed ONCE per (params tensors
    and versions, compute dtype) through the kernels' residency cache.  The
    layout does not depend on the schedule: every scheduled key shares one
    pack.

    Per decoder layer: q|k|v gate-fused into ``__wqkv`` [d, (hq+2*hk)*hd],
    the MLP gate|up projections into ``__wgu`` (``__wup`` without a GLU),
    the output / down projections as 2D ``__wo`` / ``__wdown`` (views of
    the stacked params where no cast is needed), everything in the compute
    dtype, and the layer's norm params sliced out of their stacked [L, ...]
    arrays.  A full-width pack is larger than the residency cache's byte
    bound and is evicted as soon as it is stored: callers keep their own
    reference (``LMServingEngine`` holds one for all its keys)."""
    stacked = tf.slice_layer(params, "decoder/")
    srcs = tuple(stacked[k] for k in sorted(stacked))
    cdt = getattr(torch, cfg.compute_dtype)
    glu = cfg.mlp_type in ("swiglu", "geglu")
    d = cfg.d_model

    def flat(t: torch.Tensor, rows: int) -> torch.Tensor:
        return t.reshape(rows, -1).to(cdt).contiguous()

    def pack() -> Dict:
        layers: List[Dict] = []
        for l in range(cfg.n_layers):
            p_l = _layer(stacked, l)
            entry = {k: v for k, v in p_l.items()
                     if "/attn/w" not in k and "/mlp/w" not in k}
            entry["__wqkv"] = torch.cat(
                [flat(p_l[f"decoder/attn/{n}"], d)
                 for n in ("wq", "wk", "wv")], dim=-1)
            entry["__wo"] = flat(p_l["decoder/attn/wo"],
                                 cfg.n_heads * cfg.head_dim)
            if glu:
                entry["__wgu"] = torch.cat(
                    [flat(p_l["decoder/mlp/w_gate"], d),
                     flat(p_l["decoder/mlp/w_up"], d)], dim=-1)
            else:
                entry["__wup"] = flat(p_l["decoder/mlp/w_up"], d)
            entry["__wdown"] = flat(p_l["decoder/mlp/w_down"], cfg.d_ff)
            layers.append(entry)
        return {"layers": layers}

    return resident(srcs, f"lm-decode/{cfg.compute_dtype}", pack)


def _rows(ts: List[torch.Tensor], B: int) -> torch.Tensor:
    """S per-position tensors [B, ...] -> the chunk's rows [B*S, w], row
    ``b*S + i`` from position i (one position: a reshape, no copy)."""
    if len(ts) == 1:
        return ts[0].reshape(B, -1)
    return torch.stack([t.reshape(B, -1) for t in ts], 1).reshape(
        B * len(ts), -1)


def _positions(z: torch.Tensor, B: int, S: int) -> List[torch.Tensor]:
    """The chunk's rows [B*S, n] -> S contiguous [B, n], one a position,
    each laid out as a sequential step's [B, n] (one position: itself)."""
    if S == 1:
        return [z]
    z = z.reshape(B, S, -1)
    return [z[:, i].contiguous() for i in range(S)]


def _dense_steps(cfg: ModelConfig, params: Dict, packed: Dict, cache: Dict,
                 x: torch.Tensor, pos: torch.Tensor,
                 schedule: Optional[KernelSchedule]
                 ) -> Tuple[torch.Tensor, Dict]:
    """The fused dense-decoder pass under ``schedule`` for a CHUNK of
    ``S = x.shape[1]`` tokens a row (x: [B, S, d]; pos: [B], the position
    of each row's first token): the einsum branch's math with every
    projection on ``decode_matmul`` over the resident packed weights.  S =
    1 is the sequential step; S > 1 is the speculative verify pass, and
    ``logits[:, i]`` and the caches have the bits of S sequential steps.

    Exact by construction: only the four products of a layer see the
    chunk, as one ``decode_matmul`` over [B*S, ·] (4 calls a layer for any
    S).  Their rows do not depend on M: the kernel sums every output in
    one order fixed by K, N and the dtype, and on CPU tensors its plain
    version is k-ordered.  Everything else runs position by position, on
    contiguous [B, 1, ·] tensors laid out as the sequential step lays out
    its own: the norms (a reduction over d, whose tree a library may pick
    by the row count), rotary embeddings, activations, residual adds, the
    final norm, the unembedding and ``softcap`` (on the CPU an ``x @ wᵀ``
    at S = 5 already rounds a row otherwise than at S = 1, and a
    transcendental runs a vector or a scalar formula by an element's place
    in the tensor).  The cache is written position by position; position
    i attends over ``pos + i + 1`` entries, and entries written by later
    chunk positions (or left by a rejected draft) are masked with NEG_INF
    before the softmax, so they add exactly zero.  The chunk therefore
    costs S times the sequential step's small kernels, and the products
    once."""
    B, S = x.shape[0], x.shape[1]
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    glu = cfg.mlp_type in ("swiglu", "geglu")

    def mm(ts, w):
        return _positions(decode_matmul(_rows(ts, B), w, schedule=schedule),
                          B, S)

    ck_all, cv_all = cache["cache/k"], cache["cache/v"]
    cks, cvs = [], []
    hs = [x[:, i:i + 1].contiguous() for i in range(S)]
    ps = [pos + i if i else pos for i in range(S)]
    for l, p_l in enumerate(packed["layers"]):
        zs = mm([norm(cfg, h, p_l, "decoder/norm1") for h in hs],
                p_l["__wqkv"])
        ck, cv = ck_all[l], cv_all[l]
        qs = []
        for z, p in zip(zs, ps):
            q = z[:, :hq * hd].reshape(B, 1, hq, hd)
            k = z[:, hq * hd:(hq + hk) * hd].reshape(B, 1, hk, hd)
            v = z[:, (hq + hk) * hd:].reshape(B, 1, hk, hd)
            qs.append(apply_rope(q, p[:, None], cfg.rope_theta))
            k = apply_rope(k, p[:, None], cfg.rope_theta)
            ck = _update_cache(ck, k, p)
            cv = _update_cache(cv, v, p)
        ck = constrain(ck, "batch", "kv_seq", "kv_heads_r", "head_dim")
        cv = constrain(cv, "batch", "kv_seq", "kv_heads_r", "head_dim")
        os_ = [decode_attention(q, ck.to(x.dtype), cv.to(x.dtype), p + 1,
                                window=cfg.attn_window).to(x.dtype)
               for q, p in zip(qs, ps)]
        hs = [h + o.reshape(B, 1, -1)
              for h, o in zip(hs, mm(os_, p_l["__wo"]))]
        zs = mm([norm(cfg, h, p_l, "decoder/norm2") for h in hs],
                p_l["__wgu" if glu else "__wup"])
        if glu:
            f = zs[0].shape[-1] // 2
            mids = [glu_activation(cfg)(z[:, :f]) * z[:, f:] for z in zs]
        else:
            act = ACTIVATIONS["relu2" if cfg.mlp_type == "relu2" else "gelu"]
            mids = [act(z) for z in zs]
        mids = [constrain(m.reshape(B, 1, -1), "batch", "seq_nosp",
                          "ffn").reshape(B, -1) for m in mids]
        hs = [h + o.reshape(B, 1, -1)
              for h, o in zip(hs, mm(mids, p_l["__wdown"]))]
        cks.append(ck)
        cvs.append(cv)
    new_cache = dict(cache)
    new_cache["cache/k"] = torch.stack(cks)
    new_cache["cache/v"] = torch.stack(cvs)
    logits = [tf.logits_fn(cfg, params, norm(cfg, h, params, "final_norm"))
              for h in hs]
    return (logits[0] if S == 1 else torch.cat(logits, 1)), new_cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos: torch.Tensor, *,
                schedule: Optional[KernelSchedule] = None,
                packed: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: [b, 1] int; pos: [b] current positions.  Returns
    (logits [b, 1, V], new cache).

    ``schedule`` routes the projections of a dense or vlm step through the
    weight-resident decode kernel (module docstring); ``packed`` is the
    layout of :func:`pack_decode_params` (derived, and cached, from
    ``params`` when omitted).  ``schedule=None``, and every other family
    under any schedule, is the einsum path."""
    tf.require_lm(cfg, "decode_step")
    cdt = getattr(torch, cfg.compute_dtype)
    x = embed_scale(cfg, embed(tokens, params["embed/table"], cdt))
    if schedule is not None and decode_schedulable(cfg):
        if packed is None:
            packed = pack_decode_params(cfg, params)
        return _dense_steps(cfg, params, packed, cache, x, pos, schedule)
    new_cache = dict(cache)
    if cfg.family == "ssm":
        x = _ssm_layers(cfg, params, cache, new_cache, x)
    elif cfg.family == "hybrid":
        x = _hybrid_layers(cfg, params, cache, new_cache, x, pos)
    elif cfg.enc_dec:
        x = _xdecoder_layers(cfg, params, cache, new_cache,
                             _sinusoid(cfg, x, pos), pos)
    else:
        x = _decoder_layers(cfg, params, cache, new_cache, x, pos)
    x = norm(cfg, x, params, "final_norm")
    return tf.logits_fn(cfg, params, x), new_cache


def _decoder_layers(cfg, params, cache, new_cache, x, pos):
    """dense / moe / vlm: attention over the KV cache, then the MLP (moe:
    the routed experts, at eval capacity)."""
    stacked = tf.slice_layer(params, "decoder/")
    cks, cvs = [], []
    for l in range(cfg.n_layers):
        p_l = _layer(stacked, l)
        hn = norm(cfg, x, p_l, "decoder/norm1")
        out, ck, cv = _attn_decode(cfg, hn, p_l, "decoder/attn",
                                   cache["cache/k"][l], cache["cache/v"][l],
                                   pos, window=cfg.attn_window)
        cks.append(ck)
        cvs.append(cv)
        x = x + out
        h2 = norm(cfg, x, p_l, "decoder/norm2")
        if cfg.family == "moe":
            x = x + moe_block(cfg, h2, p_l, "decoder/moe", train=False)[0]
        else:
            x = x + mlp(cfg, h2, p_l, "decoder/mlp")
    new_cache["cache/k"] = torch.stack(cks)
    new_cache["cache/v"] = torch.stack(cvs)
    return x


def _ssm_layers(cfg, params, cache, new_cache, x):
    """ssm: one Mamba-2 state update a layer (no MLP, no second norm)."""
    stacked = tf.slice_layer(params, "decoder/")
    states, convs = [], []
    for l in range(cfg.n_layers):
        p_l = _layer(stacked, l)
        hn = norm(cfg, x, p_l, "decoder/norm1")
        out, (st, cv) = ssm_decode_step(cfg, hn, p_l, "decoder/ssm",
                                        cache["cache/state"][l],
                                        cache["cache/conv"][l])
        states.append(st)
        convs.append(cv)
        x = x + out
    new_cache["cache/state"] = torch.stack(states)
    new_cache["cache/conv"] = torch.stack(convs)
    return x


#: the span of each hybrid block kind's mixer (``tracing``)
_MIXER_SPANS = {"mamba": "hybrid.mamba", "attn": "hybrid.attn",
                "local_attn": "hybrid.attn", "rglru": "hybrid.rglru"}


def _hybrid_block(cfg, x, p, pre, kind, c, pos):
    """One hybrid layer ``pre`` (its mixer: an RG-LRU, Griffin's local
    attention, a Mamba-2 state update or full attention over the KV cache;
    then the MLP) over its cache entries ``c`` (``cache/{pre}_*`` without
    the prefix); ``c`` is updated in place (a dict).  Spans
    ``hybrid.<mixer>`` and ``hybrid.mlp`` while a recording is on."""
    rec = tracing.ACTIVE
    if rec is not None:
        span = rec.open(_MIXER_SPANS[kind])
    hn = norm(cfg, x, p, f"{pre}/norm1")
    if kind == "mamba":
        out, (c["state"], c["conv"]) = ssm_decode_step(
            cfg, hn, p, f"{pre}/ssm", c["state"], c["conv"])
    elif kind == "attn":
        out, c["k"], c["v"] = _attn_decode(
            cfg, hn, p, f"{pre}/attn", c["k"], c["v"], pos)
    elif kind == "rglru":
        out, (c["state"], c["conv"]) = rglru_decode_step(
            cfg, hn, p, f"{pre}/mix", c["state"], c["conv"])
    else:
        out, c["k"], c["v"], c["pos"] = _local_attn_decode(
            cfg, hn, p, f"{pre}/attn", c["k"], c["v"], c["pos"], pos,
            cfg.rglru.window)
    x = x + residual_scale(cfg, out)
    if rec is not None:
        rec.close(span)
        span = rec.open("hybrid.mlp")
    h2 = norm(cfg, x, p, f"{pre}/norm2")
    x = x + residual_scale(cfg, mlp(cfg, h2, p, f"{pre}/mlp"))
    if rec is not None:
        rec.close(span)
    return x


def _hybrid_layers(cfg, params, cache, new_cache, x, pos):
    """hybrid: the stacked super-blocks ``hyb{j}`` in turn (the pattern's
    blocks within each), then the remainder layers ``hybrem{j}``."""
    pattern = cfg.hybrid_pattern
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    stacked = {k: v for k, v in params.items()
               if k.startswith("hyb") and not k.startswith("hybrem")}
    names = {j: [k for k in cache if k.startswith(f"cache/hyb{j}_")]
             for j in range(len(pattern))}
    outs = {k: [] for ks in names.values() for k in ks}
    for l in range(n_super):
        p_l = _layer(stacked, l)
        for j, kind in enumerate(pattern):
            pre = f"cache/hyb{j}_"
            c = {k[len(pre):]: cache[k][l] for k in names[j]}
            x = _hybrid_block(cfg, x, p_l, f"hyb{j}", kind, c, pos)
            for k in names[j]:
                outs[k].append(c[k[len(pre):]])
    for k, v in outs.items():
        new_cache[k] = torch.stack(v)
    for j in range(rem):
        pre = f"cache/hybrem{j}_"
        c = {k[len(pre):]: v for k, v in cache.items() if k.startswith(pre)}
        x = _hybrid_block(cfg, x, tf.slice_layer(params, f"hybrem{j}/"),
                          f"hybrem{j}", pattern[j], c, pos)
        new_cache.update({pre + k: v for k, v in c.items()})
    return x


def _xdecoder_layers(cfg, params, cache, new_cache, x, pos):
    """enc-dec (whisper's decoder): self-attention over the KV cache
    without rotary embeddings, cross-attention over all of ``cache/xk`` /
    ``cache/xv``, then the MLP."""
    stacked = tf.slice_layer(params, "xdecoder/")
    cks, cvs = [], []
    for l in range(cfg.n_decoder_layers):
        p_l = _layer(stacked, l)
        hn = norm(cfg, x, p_l, "xdecoder/norm1")
        out, ck, cv = _attn_decode(cfg, hn, p_l, "xdecoder/attn",
                                   cache["cache/k"][l], cache["cache/v"][l],
                                   pos, rope=False)
        cks.append(ck)
        cvs.append(cv)
        x = x + out
        hx = norm(cfg, x, p_l, "xdecoder/norm_x")
        qx = torch.einsum("bsd,dhk->bshk", hx,
                          p_l["xdecoder/xattn/wq"].to(hx.dtype))
        xk, xv = cache["cache/xk"][l], cache["cache/xv"][l]
        enc_len = torch.full((x.shape[0],), xk.shape[1], dtype=torch.int64,
                             device=x.device)
        ox = decode_attention(qx, xk.to(hx.dtype), xv.to(hx.dtype), enc_len)
        x = x + torch.einsum("bshk,hkd->bsd", ox.to(hx.dtype),
                             p_l["xdecoder/xattn/wo"].to(hx.dtype))
        h2 = norm(cfg, x, p_l, "xdecoder/norm2")
        x = x + mlp(cfg, h2, p_l, "xdecoder/mlp")
    new_cache["cache/k"] = torch.stack(cks)
    new_cache["cache/v"] = torch.stack(cvs)
    return x


# ---------------------------------------------------------------------------
# Multi-token verify and KV rollback (the speculative-decode seam)
# ---------------------------------------------------------------------------


def decode_steps(cfg: ModelConfig, params: Dict, cache: Dict,
                 tokens: torch.Tensor, pos: torch.Tensor, *,
                 schedule: Optional[KernelSchedule] = None,
                 packed: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Multi-token decode: ``S = tokens.shape[1]`` consecutive positions a
    row in one pass.  tokens: [b, S] int; pos: [b], the position of each
    row's FIRST token.  Returns (logits [b, S, V], new cache):
    ``logits[:, i]`` is what :func:`decode_step` gives for token i with
    the cache advanced through the tokens before it, bit for bit.

    The speculative decoder's verify pass.  For dense and vlm a kernel
    schedule runs :func:`_dense_steps` over the chunk (its four products a
    layer once over [b*S, d]; see its docstring for why the bits are the
    sequential chain's).  ``schedule=None`` (the einsum path),
    ``backend="xla"`` (the plain dot) and every other family unroll the
    sequential step, as ``repro`` unrolls them: their products are library
    products, whose rows may round otherwise at another M.  An ssm or
    hybrid state absorbs every token it sees and nothing rolls it back, so
    the serving path refuses speculation there (``serving/speculative.py``)."""
    tf.require_lm(cfg, "decode_steps")
    if (schedule is not None and schedule.use_pallas
            and decode_schedulable(cfg)):
        cdt = getattr(torch, cfg.compute_dtype)
        x = weak_scale(embed(tokens, params["embed/table"], cdt),
                        math.sqrt(cfg.d_model))
        if packed is None:
            packed = pack_decode_params(cfg, params)
        return _dense_steps(cfg, params, packed, cache, x, pos, schedule)
    logits: List[torch.Tensor] = []
    for i in range(tokens.shape[1]):
        li, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1],
                                pos + i if i else pos, schedule=schedule,
                                packed=packed)
        logits.append(li)
    return (logits[0] if len(logits) == 1 else torch.cat(logits, 1)), cache


def kv_trim(cache: Dict, keep: torch.Tensor) -> Dict:
    """Roll the KV cache back to ``keep[b]`` valid entries a row: positions
    ``>= keep[b]`` of ``cache/k`` / ``cache/v`` return to zeros (their
    initial state), so a cache that saw rejected speculative writes becomes
    bit-equal to one that only advanced through the accepted prefix (the
    encoder's ``cache/xk`` / ``cache/xv`` do not depend on the decode
    position and are left as they are).  Not
    needed for exactness (attention masks every entry past a row's length
    with NEG_INF, and the next verify window rewrites them first); it is
    the strict rollback mode (``SpecConfig.trim``).  Other entries of the
    cache dict are returned as they are."""
    new = dict(cache)
    for name in ("cache/k", "cache/v"):
        if name not in cache:
            continue
        c = cache[name]                      # [L, b, S, hk, hd]
        sel = (torch.arange(c.shape[2], device=c.device)[None, :]
               < keep.to(c.device)[:, None])                      # [b, S]
        new[name] = torch.where(sel[None, :, :, None, None], c,
                                c.new_zeros(()))
    return new


# ---------------------------------------------------------------------------
# Parameters from the JAX package
# ---------------------------------------------------------------------------


def lm_params_from_jax(params: Mapping[str, object],
                       device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """``repro``'s flat LM parameters (numpy or JAX arrays, layout of
    ``transformer.param_specs``: every family's tree) as tensors on
    ``device``, each in its own dtype.  bfloat16 (``ml_dtypes``, which
    ``torch.from_numpy`` rejects) crosses through float32, which holds
    every bfloat16 value exactly."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[k] = t.to(device)
    stacks = ("decoder/", "xdecoder/", "hyb")
    if "embed/table" not in out or not any(k.startswith(stacks)
                                           for k in out):
        raise KeyError(f"not LM parameters (embed/table and a layer stack "
                       f"{stacks}): {sorted(out)}")
    return out
