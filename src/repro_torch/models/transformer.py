"""Decoder-only LM assembly, dense family: parameter specs and logits.

The port of the dense subset of ``repro/models/transformer.py``.
``param_specs(cfg)`` is the single source of truth for the parameters,
with the layer weights stacked along a leading [L, ...] dim as in
``repro``, so both packages hold the same flat dicts.  Sharding
constraints are dropped: the port runs on one device.  Other families
raise (``ROADMAP.md`` module item 10).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec, ParamSpecs
from repro_torch.models.layers import norm_specs, softcap
from repro_torch.models.mlp import mlp_specs


def require_dense(cfg: ModelConfig, what: str) -> None:
    """Refuse every family but the dense decoder: MoE, SSM, hybrid,
    enc-dec and vlm are ROADMAP.md module item 10."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} ({cfg.name}) is not ported; the "
            f"port runs the dense decoder only (ROADMAP.md module item 10)")


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
    """Specs for one stacked group of decoder layers."""
    specs: ParamSpecs = {}
    specs.update(norm_specs(cfg, f"{kind}/norm1", n_stacked))
    specs.update(_attn_specs(cfg, f"{kind}/attn", n_stacked))
    specs.update(norm_specs(cfg, f"{kind}/norm2", n_stacked))
    specs.update(mlp_specs(cfg, f"{kind}/mlp", n_stacked))
    return specs


def padded_vocab(cfg: ModelConfig, multiple: int = 128) -> int:
    """Vocab padded to a multiple of ``multiple``, as in ``repro``; padded
    ids never appear in data."""
    return -(-cfg.vocab_size // multiple) * multiple


def param_specs(cfg: ModelConfig) -> ParamSpecs:
    require_dense(cfg, "param_specs")
    d, V = cfg.d_model, padded_vocab(cfg)
    dt = cfg.param_dtype
    specs: ParamSpecs = {
        "embed/table": ParamSpec((V, d), "embed", dt, 0.02),
    }
    specs.update(norm_specs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        specs["unembed/w"] = ParamSpec((d, V), "lecun", dt)
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
