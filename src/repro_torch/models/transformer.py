"""LM assembly for every family (dense, moe, ssm, hybrid, audio enc-dec,
vlm): parameter specs and logits.

The port of the spec half of ``repro/models/transformer.py``.
``param_specs(cfg)`` is the single source of truth for the parameters,
with the layer weights stacked along a leading [L, ...] dim as in
``repro`` (the hybrid family: ``hyb{j}/`` stacked over its super-blocks,
``hybrem{j}/`` for the remainder layers; enc-dec: ``encoder/`` and
``xdecoder/``), so both packages hold the same flat dicts.  Sharding
constraints are dropped: the port runs on one device.  ``forward`` over a
whole sequence (prefill, the training forward pass) and ``lm_loss`` are
not ported yet (``ROADMAP.md`` module item 10, prefill); the decode path
is ``models/decode.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec, ParamSpecs
from repro_torch.models.layers import norm_specs, softcap
from repro_torch.models.mlp import mlp_specs
from repro_torch.models.moe import moe_specs, padded_n_experts
from repro_torch.models.rglru import rglru_specs
from repro_torch.models.ssm import ssm_specs

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
    dt = cfg.param_dtype
    return {
        f"{prefix}/wq": ParamSpec(lead + (d, cfg.n_heads, cfg.head_dim),
                                  "lecun", dt),
        f"{prefix}/wk": ParamSpec(lead + (d, cfg.n_kv_heads, cfg.head_dim),
                                  "lecun", dt),
        f"{prefix}/wv": ParamSpec(lead + (d, cfg.n_kv_heads, cfg.head_dim),
                                  "lecun", dt),
        f"{prefix}/wo": ParamSpec(lead + (cfg.n_heads, cfg.head_dim, d),
                                  "lecun", dt),
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
        "embed/table": ParamSpec((V, d), "embed", dt, 0.02),
    }
    specs.update(norm_specs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        specs["unembed/w"] = ParamSpec((d, V), "lecun", dt)
    if cfg.frontend == "vision":
        specs["img_proj/w"] = ParamSpec((d, d), "lecun", dt)
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
    return softcap(logits, cfg.logits_softcap)
