"""LM assembly for every family (dense, moe, ssm, hybrid, audio enc-dec,
vlm): parameter specs, the sequence forward, logits and the LM loss.

The port of ``repro/models/transformer.py``.  ``param_specs(cfg)`` is the
single source of truth for the parameters, with the layer weights stacked
along a leading [L, ...] dim as in ``repro`` (the hybrid family:
``hyb{j}/`` stacked over its super-blocks, ``hybrem{j}/`` for the
remainder layers; enc-dec: ``encoder/`` and ``xdecoder/``), so both
packages hold the same flat dicts.

``forward`` runs a whole sequence (prefill, the training forward pass):
token embeddings (vlm: the projected image patches first; enc-dec: the
decoder over ``_encode``'s output), the layer stack, the final norm.  A
Python loop over the stacked layers takes the place of ``lax.scan``, and
``_remat`` maps ``cfg.remat`` onto ``torch.utils.checkpoint`` (values do
not depend on it).  ``lm_loss`` is the stable cross entropy with the
z-loss.  ``constrain`` stands at ``repro``'s places (the identity
without a sharding context).  Attention modes, as in ``repro`` (chosen by
the context's overrides, ``sharding/auto.py``): 'tp' gathers the sequence
and shards heads (the exact triangular blockwise schedule); 'sp' keeps
the sequence sharded, one q chunk per TP rank against the whole KV
(``_sp_attention``: rectangular masked blocks, ``_masked_rect``), for
archs whose head count does not divide the TP axis.  The single-step
decode path is ``models/decode.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.config import ModelConfig
from repro_torch.models.attention import (NEG_INF, _finalize, _gqa_scores,
                                          _gqa_values, _merge,
                                          blockwise_attention)
from repro_torch.models.init import ParamSpec, ParamSpecs
from repro_torch.models.layers import (apply_rope, embed, norm, norm_specs,
                                       softcap, weak_scale)
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.moe import moe_block, moe_specs, padded_n_experts
from repro_torch.models.rglru import rglru_mix, rglru_specs
from repro_torch.models.ssm import ssm_block, ssm_specs
from repro_torch.sharding.api import constrain, current_context

#: the LM families (every ``ModelConfig.family`` but the taggers' "rnn")
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def require_lm(cfg: ModelConfig, what: str) -> None:
    """Refuse a config that is not an LM (a tagger, an unknown family)."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(
            f"{what}: {cfg.name!r} has family {cfg.family!r}, not an LM "
            f"family {LM_FAMILIES}")


def _attn_specs(cfg: ModelConfig, prefix: str, stacked=None) -> ParamSpecs:
    d = cfg.d_model
    lead = (stacked,) if stacked else ()
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    return {
        f"{prefix}/wq": ParamSpec(lead + (d, cfg.n_heads, cfg.head_dim),
                                  "lecun", dt, logical_axes=la + (
                                      "embed", "heads", "head_dim")),
        f"{prefix}/wk": ParamSpec(lead + (d, cfg.n_kv_heads, cfg.head_dim),
                                  "lecun", dt, logical_axes=la + (
                                      "embed", "kv_heads", "head_dim")),
        f"{prefix}/wv": ParamSpec(lead + (d, cfg.n_kv_heads, cfg.head_dim),
                                  "lecun", dt, logical_axes=la + (
                                      "embed", "kv_heads", "head_dim")),
        f"{prefix}/wo": ParamSpec(lead + (cfg.n_heads, cfg.head_dim, d),
                                  "lecun", dt, logical_axes=la + (
                                      "heads", "head_dim", "embed")),
    }


def _layer_specs(cfg: ModelConfig, n_stacked: int,
                 kind: str = "decoder") -> ParamSpecs:
    """Specs for one stacked layer group of the given kind."""
    specs: ParamSpecs = {}
    specs.update(norm_specs(cfg, f"{kind}/norm1", n_stacked))
    if cfg.family == "ssm":
        specs.update(ssm_specs(cfg, f"{kind}/ssm", n_stacked))
        return specs
    specs.update(_attn_specs(cfg, f"{kind}/attn", n_stacked))
    specs.update(norm_specs(cfg, f"{kind}/norm2", n_stacked))
    if cfg.family == "moe":
        specs.update(moe_specs(cfg, f"{kind}/moe", n_stacked,
                               padded_n_experts(cfg)))
    else:
        specs.update(mlp_specs(cfg, f"{kind}/mlp", n_stacked))
    if kind == "xdecoder":  # enc-dec decoder layer: + cross attention
        specs.update(norm_specs(cfg, f"{kind}/norm_x", n_stacked))
        specs.update(_attn_specs(cfg, f"{kind}/xattn", n_stacked))
    return specs


def _hybrid_specs(cfg: ModelConfig) -> ParamSpecs:
    """Griffin pattern: super-blocks of (rglru, rglru, local_attn) stacked
    as ``hyb{j}/``, plus the remainder layers ``hybrem{j}/`` unstacked."""
    rg = cfg.rglru
    n_super, rem = divmod(cfg.n_layers, len(rg.pattern))
    groups = [(f"hyb{j}", kind, n_super) for j, kind in enumerate(rg.pattern)]
    groups += [(f"hybrem{j}", rg.pattern[j], None) for j in range(rem)]
    specs: ParamSpecs = {}
    for pre, kind, n in groups:
        specs.update(norm_specs(cfg, f"{pre}/norm1", n))
        if kind == "rglru":
            specs.update(rglru_specs(cfg, f"{pre}/mix", n))
        else:
            specs.update(_attn_specs(cfg, f"{pre}/attn", n))
        specs.update(norm_specs(cfg, f"{pre}/norm2", n))
        specs.update(mlp_specs(cfg, f"{pre}/mlp", n))
    return specs


def padded_vocab(cfg: ModelConfig, multiple: int = 128) -> int:
    """Vocab padded to a multiple of ``multiple``, as in ``repro``; padded
    ids never appear in data."""
    return -(-cfg.vocab_size // multiple) * multiple


def param_specs(cfg: ModelConfig) -> ParamSpecs:
    require_lm(cfg, "param_specs")
    d, V = cfg.d_model, padded_vocab(cfg)
    dt = cfg.param_dtype
    specs: ParamSpecs = {
        "embed/table": ParamSpec((V, d), "embed", dt, 0.02,
                                 ("vocab", "embed")),
    }
    specs.update(norm_specs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        specs["unembed/w"] = ParamSpec((d, V), "lecun", dt,
                                       logical_axes=("embed", "vocab"))
    if cfg.frontend == "vision":
        specs["img_proj/w"] = ParamSpec((d, d), "lecun", dt,
                                        logical_axes=("embed", None))
    if cfg.enc_dec:
        specs.update(_layer_specs(cfg, cfg.n_encoder_layers, "encoder"))
        specs.update(_layer_specs(cfg, cfg.n_decoder_layers, "xdecoder"))
        specs.update(norm_specs(cfg, "enc_final_norm"))
        return specs
    if cfg.family == "hybrid":
        specs.update(_hybrid_specs(cfg))
        return specs
    specs.update(_layer_specs(cfg, cfg.n_layers, "decoder"))
    return specs


def slice_layer(params: Dict, prefix: str) -> Dict:
    return {k: v for k, v in params.items() if k.startswith(prefix)}


def logits_fn(cfg: ModelConfig, params: Dict,
              x: torch.Tensor) -> torch.Tensor:
    """x: [b, s, d] -> logits [b, s, V] (padded vocab), soft-capped.  A plain
    product, as ``repro`` leaves it to XLA outside any kernel."""
    if cfg.tie_embeddings:
        w = params["embed/table"].to(x.dtype)                # [V, d]
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["unembed/w"].to(x.dtype))
    logits = softcap(logits, cfg.logits_softcap)
    return constrain(logits, "batch", "seq_nosp", "vocab")


# ---------------------------------------------------------------------------
# Attention block and layer bodies
# ---------------------------------------------------------------------------


def _attn_meta() -> Tuple[str, int]:
    """(attention mode, TP width) of the active context: ('tp', 0)
    without one."""
    ctx = current_context()
    if ctx is None:
        return "tp", 0
    mode = ctx.overrides.get("__attn_mode__", "tp")
    tp = ctx.axis_sizes.get("model", 1)
    return mode, tp


def attention_block(cfg: ModelConfig, x: torch.Tensor, p: Dict, prefix: str,
                    *, causal: bool, window: int = 0,
                    kv_source: Optional[torch.Tensor] = None,
                    pos_offset: int = 0) -> torch.Tensor:
    """Pre-normed input -> attention output (before the residual add).
    x: [b, s, d]; ``kv_source`` (cross-attention) gives k and v.  Rotary
    embeddings at positions ``arange(s) + pos_offset``, none for the audio
    family or cross-attention.  Under a context in mode 'sp' with TP > 1
    a causal block runs ``_sp_attention``, else the heads-TP blockwise
    schedule."""
    s = x.shape[1]
    mode, tp = _attn_meta()
    xs = kv_source if kv_source is not None else x
    q = torch.einsum("bsd,dhk->bshk", x, p[f"{prefix}/wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", xs, p[f"{prefix}/wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", xs, p[f"{prefix}/wv"].to(x.dtype))
    if kv_source is None and cfg.family != "audio":
        pos = torch.arange(s, device=x.device) + pos_offset
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if mode == "sp" and tp > 1 and causal:
        # sequence stays sharded; KV gathered (small for MQA/GQA archs)
        q = constrain(q, "batch", "seq", None, "head_dim")
        k = constrain(k, "batch", None, None, "head_dim")
        v = constrain(v, "batch", None, None, "head_dim")
        o = _sp_attention(q, k, v, causal=causal, window=window, tp=tp,
                          chunk_kv=min(cfg.attn_chunk_kv, 512))
    else:
        # heads-TP: gather sequence, shard heads (exact triangular schedule)
        q = constrain(q, "batch", None, "heads", "head_dim")
        k = constrain(k, "batch", None, "kv_heads", "head_dim")
        v = constrain(v, "batch", None, "kv_heads", "head_dim")
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_kv=cfg.attn_chunk_kv)
    return torch.einsum("bshk,hkd->bsd", o.to(x.dtype),
                        p[f"{prefix}/wo"].to(x.dtype))


def _sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, tp: int,
                  chunk_kv: int) -> torch.Tensor:
    """Sequence-parallel attention: q cut into ``tp`` chunks along the
    sequence (the chunk-grid dim sharded over 'model', one chunk per
    rank), each attending to the whole (gathered) KV with rectangular
    masked blocks (``_masked_rect``).  About 2x the triangular FLOPs for
    causal, as in ``repro``.  q: [b, s, h, d], s a multiple of ``tp``."""
    b, s, h, d = q.shape
    if s % tp:
        raise ValueError(f"_sp_attention: seq {s} % tp {tp}")
    cq = s // tp
    qg = constrain(q.reshape(b, tp, cq, h, d),
                   "batch", "seq_chunks", None, None, None)
    o = torch.stack([_masked_rect(qg[:, i], k, v, i * cq, causal, window,
                                  chunk_kv) for i in range(tp)], dim=1)
    o = constrain(o, "batch", "seq_chunks", None, None, None)
    return o.reshape(b, s, h, d)


def _masked_rect(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_off: int, causal: bool, window: int,
                 chunk_kv: int) -> torch.Tensor:
    """Rectangular blockwise attention for one q chunk at offset
    ``q_off``: qc [b, cq, h, d] against every kv block of k / v [b, sk,
    hk, d] (``sk // chunk`` blocks), the causal / window mask applied to
    each, with the online-softmax merge of f32 accumulators; returned in
    qc's dtype."""
    b, cq, h, d = qc.shape
    sk = k.shape[1]
    ck = min(chunk_kv, sk)
    nk = sk // ck
    qs = weak_scale(qc, 1.0 / math.sqrt(d))
    dev = qc.device
    q_pos = torch.arange(cq, device=dev) + q_off
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    acc = (torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev),
           torch.zeros((b, h, cq), dtype=torch.float32, device=dev),
           torch.zeros((b, cq, h, d), dtype=torch.float32, device=dev))
    for j in range(nk):
        k_pos = j * ck + torch.arange(ck, device=dev)
        mask = torch.zeros((cq, ck), dtype=torch.bool, device=dev)
        if causal:
            mask = mask | (k_pos[None, :] > q_pos[:, None])
        if window > 0:
            mask = mask | (k_pos[None, :] <= q_pos[:, None] - window)
        s = _gqa_scores(qs, k[:, j * ck:(j + 1) * ck])
        s = torch.where(mask[None, None], neg, s)
        m = s.amax(dim=-1)
        pexp = torch.exp(s - m[..., None])
        o = _gqa_values(pexp, v[:, j * ck:(j + 1) * ck])
        acc = _merge(acc, m, pexp.sum(dim=-1), o)
    return _finalize(*acc).to(qc.dtype)


def _residual_in(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "batch", "seq", "embed_act")


def dense_layer(cfg, x, p, pre, *, causal=True, kv_source=None,
                cross=False):
    h = norm(cfg, _residual_in(x), p, f"{pre}/norm1")
    x = _residual_in(x + attention_block(cfg, h, p, f"{pre}/attn",
                                         causal=causal))
    if cross:
        hx = norm(cfg, x, p, f"{pre}/norm_x")
        x = _residual_in(x + attention_block(cfg, hx, p, f"{pre}/xattn",
                                             causal=False,
                                             kv_source=kv_source))
    h2 = norm(cfg, x, p, f"{pre}/norm2")
    return _residual_in(x + mlp(cfg, h2, p, f"{pre}/mlp"))


def moe_layer(cfg, x, p, pre, *, train):
    """An attention block, then the routed experts.  Returns (x, aux)."""
    h = norm(cfg, _residual_in(x), p, f"{pre}/norm1")
    x = _residual_in(x + attention_block(cfg, h, p, f"{pre}/attn",
                                         causal=True))
    h2 = norm(cfg, x, p, f"{pre}/norm2")
    h2, aux = moe_block(cfg, h2, p, f"{pre}/moe", train=train)
    return _residual_in(x + h2), aux


def ssm_layer(cfg, x, p, pre):
    h = norm(cfg, _residual_in(x), p, f"{pre}/norm1")
    return _residual_in(x + ssm_block(cfg, h, p, f"{pre}/ssm"))


def hybrid_layer(cfg, x, p, pre, kind):
    h = norm(cfg, _residual_in(x), p, f"{pre}/norm1")
    if kind == "rglru":
        h = rglru_mix(cfg, h, p, f"{pre}/mix")
    else:
        h = attention_block(cfg, h, p, f"{pre}/attn", causal=True,
                            window=cfg.rglru.window)
    x = _residual_in(x + h)
    h2 = norm(cfg, x, p, f"{pre}/norm2")
    return _residual_in(x + mlp(cfg, h2, p, f"{pre}/mlp"))


# ---------------------------------------------------------------------------
# Stack runner (a loop over the stacked layers, with rematerialisation)
# ---------------------------------------------------------------------------

#: the matmul ops whose outputs ``remat="dots"`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` under ``cfg.remat``: "none" calls it; "full" keeps only its
    inputs for the backward pass and runs it again there
    (``torch.utils.checkpoint``, as ``jax.checkpoint``); "dots" also keeps
    the outputs of its matmuls (selective checkpointing, as
    ``checkpoint_dots_with_no_batch_dims``).  Without autograd every mode
    calls ``fn``.  The values do not depend on the mode."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: not one of none, full, dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _layers(stacked: Dict, n_layers: int) -> list:
    """A stacked [L, ...] group as L per-layer dicts of views.  One
    ``unbind`` a tensor: its backward stacks the L gradients once, where
    L separate ``v[i]`` would each add a zero-filled [L, ...] gradient."""
    per = {k: v.unbind(0) for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n_layers)]


def _run_stack(cfg, x, params, kind, layer_fn, n_layers):
    """``layer_fn(x, layer params)`` over the stacked group ``kind``
    (``hyb``: every ``hyb{j}/`` super-block group, not the remainder
    layers), layer by layer, each under ``_remat``."""
    if kind == "hyb":
        stacked = {k: v for k, v in params.items()
                   if k.startswith("hyb") and not k.startswith("hybrem")}
    else:
        stacked = slice_layer(params, f"{kind}/")
    body = _remat(cfg, layer_fn)
    for p_layer in _layers(stacked, n_layers):
        x = body(x, p_layer)
    return x


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def required_inputs(cfg: ModelConfig) -> Tuple[str, ...]:
    """The batch entries beside ``tokens`` that ``forward`` needs: an
    enc-dec model's ``frame_embeds`` [b, s_frames, d] and a vision model's
    ``img_embeds`` [b, n_patches, d] (the frontends are stubs that take
    precomputed embeddings)."""
    return (("frame_embeds",) if cfg.enc_dec else ()) + (
        ("img_embeds",) if cfg.frontend == "vision" else ())


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            train: bool = True, img_embeds: Optional[torch.Tensor] = None,
            frame_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """tokens: [b, s_text] -> (final hidden states [b, s, d] in the
    compute dtype, aux dict: the moe family's mean ``moe_load_balance`` and
    ``moe_z_loss`` over its layers).  vlm: s = n_patches + s_text."""
    require_lm(cfg, "forward")
    given = {"frame_embeds": frame_embeds, "img_embeds": img_embeds}
    missing = [k for k in required_inputs(cfg) if given[k] is None]
    if missing:
        raise ValueError(f"forward of {cfg.name!r} ({cfg.family}) needs "
                         f"{missing} beside the tokens")
    cdt = getattr(torch, cfg.compute_dtype)
    aux: Dict = {}

    if cfg.enc_dec:
        enc = _encode(cfg, params, frame_embeds.to(cdt))
        x = embed(tokens, params["embed/table"], cdt)
        x = _residual_in(_add_sinusoidal(weak_scale(x,
                                                    math.sqrt(cfg.d_model))))
        x = _run_stack(cfg, x, params, "xdecoder",
                       lambda h, p: dense_layer(cfg, h, p, "xdecoder",
                                                causal=True, cross=True,
                                                kv_source=enc),
                       cfg.n_decoder_layers)
        return norm(cfg, x, params, "final_norm"), aux

    x = embed(tokens, params["embed/table"], cdt)
    if cfg.family in ("dense", "vlm", "hybrid"):
        x = weak_scale(x, math.sqrt(cfg.d_model))  # gemma / griffin scaling
    if cfg.frontend == "vision":
        img = torch.einsum("bnd,de->bne", img_embeds.to(cdt),
                           params["img_proj/w"].to(cdt))
        x = torch.cat([img, x], dim=1)
    x = _residual_in(x)

    if cfg.family == "ssm":
        x = _run_stack(cfg, x, params, "decoder",
                       lambda h, p: ssm_layer(cfg, h, p, "decoder"),
                       cfg.n_layers)
    elif cfg.family == "moe":
        def moe_fn(h, lb, zl, p):
            h, acc = moe_layer(cfg, h, p, "decoder", train=train)
            return (h, lb + acc["moe_load_balance"],
                    zl + acc["moe_z_loss"])

        body = _remat(cfg, moe_fn)
        lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
        for p_layer in _layers(slice_layer(params, "decoder/"),
                               cfg.n_layers):
            x, lb, zl = body(x, lb, zl, p_layer)
        aux["moe_load_balance"] = lb / cfg.n_layers
        aux["moe_z_loss"] = zl / cfg.n_layers
    elif cfg.family == "hybrid":
        rg = cfg.rglru
        n_super, rem = divmod(cfg.n_layers, len(rg.pattern))

        def super_fn(h, p_sb):
            for j, kind in enumerate(rg.pattern):
                h = hybrid_layer(cfg, h, p_sb, f"hyb{j}", kind)
            return h

        x = _run_stack(cfg, x, params, "hyb", super_fn, n_super)
        for j in range(rem):
            # j bound now: a checkpoint calls the layer again in backward
            x = _remat(cfg, lambda h, p, j=j: hybrid_layer(
                cfg, h, p, f"hybrem{j}", rg.pattern[j]))(
                    x, slice_layer(params, f"hybrem{j}/"))
    else:  # dense / vlm
        x = _run_stack(cfg, x, params, "decoder",
                       lambda h, p: dense_layer(cfg, h, p, "decoder"),
                       cfg.n_layers)
    return norm(cfg, x, params, "final_norm"), aux


def _encode(cfg: ModelConfig, params: Dict,
            frames: torch.Tensor) -> torch.Tensor:
    """The enc-dec encoder: sinusoidal positions, bidirectional layers
    without rotary embeddings, its final norm.  frames: [b, s, d]."""
    x = _run_stack(cfg, _residual_in(_add_sinusoidal(frames)), params,
                   "encoder",
                   lambda h, p: dense_layer(cfg, h, p, "encoder",
                                            causal=False),
                   cfg.n_encoder_layers)
    return norm(cfg, x, params, "enc_final_norm")


def _add_sinusoidal(x: torch.Tensor) -> torch.Tensor:
    """x + the sinusoidal position embedding of positions 0..s-1."""
    s, d = x.shape[1], x.shape[2]
    pos = torch.arange(s, dtype=torch.float32, device=x.device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)[None]
    angle = pos / torch.pow(10000.0, dim / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)[:, :d]
    return x + pe[None].to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _vocab_sharded(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor split along its vocab (last) dim."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(logits, DTensor) and any(
        isinstance(pl, Shard) and pl.dim in (-1, logits.ndim - 1)
        for pl in logits.placements)


def lm_loss(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
            labels: torch.Tensor, z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict]:
    """Stable cross entropy over the padded vocab, plus ``z_loss`` times
    the mean squared log-normaliser.  labels: [b, s], -1 = masked.
    Returns (loss, {"nll", "z_loss", "accuracy"}).

    As in ``repro``, the max subtracted inside the exponent is detached
    but the one added back is not, so the gradient of the log-normaliser
    is the softmax plus one at each row's argmax (``ROADMAP.md`` §3: kept
    equal to ``repro`` on purpose)."""
    logits = logits_fn(cfg, params, hidden).float()
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    lab = torch.clamp(labels, min=0).long()
    if _vocab_sharded(logits):
        # vocab-parallel pick (Megatron-style, as repro's): each shard's
        # one-hot product, summed over the vocab; the same value as the
        # gather (one nonzero term), with no gather across shards
        hot = torch.arange(logits.shape[-1], device=lab.device) == lab[..., None]
        picked = (logits * hot.to(logits.dtype)).sum(-1)
    else:
        picked = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = lse - picked
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    zl = (lse.square() * mask).sum() / denom
    acc = ((logits.argmax(-1) == lab).float() * mask).sum() / denom
    metrics = {"nll": loss, "z_loss": zl, "accuracy": acc}
    return loss + z_loss * zl, metrics
