"""Shared primitive layers of the dense decoder: norms, embedding, rotary,
activations.

The port of ``repro/models/layers.py``.  Norms and rotary embeddings
compute in float32 and return the input's dtype, as in ``repro``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def norm(cfg: ModelConfig, x: torch.Tensor, p: dict,
         prefix: str) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p[f"{prefix}/scale"], cfg.norm_eps)
    return layer_norm(x, p[f"{prefix}/scale"], p[f"{prefix}/bias"],
                      cfg.norm_eps)


def norm_specs(cfg: ModelConfig, prefix: str,
               stacked: Optional[int] = None) -> dict:
    """ParamSpecs for a norm layer (optionally layer-stacked)."""
    from repro_torch.models.init import ParamSpec

    lead = (stacked,) if stacked else ()
    ax = ("layers",) * len(lead) + ("embed_nofsdp",)
    init_scale = "zeros" if cfg.norm_type == "rmsnorm" else "ones"
    out = {f"{prefix}/scale": ParamSpec(lead + (cfg.d_model,), init_scale,
                                        cfg.param_dtype, logical_axes=ax)}
    if cfg.norm_type == "layernorm":
        out[f"{prefix}/bias"] = ParamSpec(lead + (cfg.d_model,), "zeros",
                                          cfg.param_dtype, logical_axes=ax)
    return out


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)            # [head_dim//2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # [hd/2]
    angles = positions[..., :, None].float() * freqs         # [..., s, hd/2]
    sin = torch.sin(angles)[..., :, None, :]                 # [..., s, 1, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)


def weak_scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with the Python float first rounded to x's dtype, as jnp
    treats a weakly typed scalar (rounded on the host: no device copy)."""
    return x * float(torch.tensor(c, dtype=x.dtype))


def embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The token embeddings as the first layer takes them: Granite's
    ``embedding_multiplier`` (a plain product, as Granite computes it);
    else sqrt(d_model) for the families that scale (gemma, griffin,
    whisper's decoder), rounded as jnp rounds a weak scalar."""
    if cfg.granite is not None:
        return x * cfg.granite.embedding_multiplier
    if cfg.family in ("dense", "vlm", "hybrid") or cfg.enc_dec:
        return weak_scale(x, math.sqrt(cfg.d_model))
    return x


def residual_scale(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A sublayer's output as it joins the residual stream: times
    Granite's ``residual_multiplier``, else as it is."""
    if cfg.granite is None:
        return h
    return h * cfg.granite.residual_multiplier


def uses_rope(cfg: ModelConfig) -> bool:
    """Whether self-attention rotates q and k (not with Granite's NoPE)."""
    return cfg.granite is None


def attention_scale(cfg: ModelConfig) -> Optional[float]:
    """The softmax scale: Granite's ``attention_multiplier``, else None
    (1/sqrt(head_dim), the attention functions' default)."""
    return None if cfg.granite is None else cfg.granite.attention_multiplier


def logits_scale(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Granite's logits over ``logits_scaling``; else as they are."""
    if cfg.granite is None:
        return logits
    return logits / cfg.granite.logits_scaling


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": torch.relu,
    "relu2": squared_relu,
    "gelu": gelu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}
