"""MLP blocks of the dense decoder: SwiGLU / GeGLU / squared-ReLU / GELU.

The port of ``repro/models/mlp.py`` (the einsum path, with ``repro``'s
sharding constraint on the hidden activations).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import ACTIVATIONS
from repro_torch.sharding.api import constrain


def mlp_specs(cfg: ModelConfig, prefix: str, stacked=None,
              d_ff=None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    lead = (stacked,) if stacked else ()
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    up = la + ("embed", "ffn")
    specs = {f"{prefix}/w_up": ParamSpec(lead + (d, f), "lecun", dt,
                                         logical_axes=up),
             f"{prefix}/w_down": ParamSpec(lead + (f, d), "lecun", dt,
                                           logical_axes=la + ("ffn", "embed"))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        specs[f"{prefix}/w_gate"] = ParamSpec(lead + (d, f), "lecun", dt,
                                              logical_axes=up)
    return specs


def glu_activation(cfg: ModelConfig):
    """The gate's activation of a GLU MLP (SiLU for SwiGLU, tanh-GELU for
    GeGLU)."""
    return F.silu if cfg.mlp_type == "swiglu" else ACTIVATIONS["gelu"]


def mlp(cfg: ModelConfig, x: torch.Tensor, p: dict,
        prefix: str) -> torch.Tensor:
    """x: [b, s, d] -> [b, s, d]."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = glu_activation(cfg)
        g = torch.einsum("bsd,df->bsf", x, p[f"{prefix}/w_gate"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, p[f"{prefix}/w_up"].to(x.dtype))
        h = act(g) * u
    else:
        act = ACTIVATIONS["relu2" if cfg.mlp_type == "relu2" else "gelu"]
        h = act(torch.einsum("bsd,df->bsf", x,
                             p[f"{prefix}/w_up"].to(x.dtype)))
    h = constrain(h, "batch", "seq_nosp", "ffn")
    return torch.einsum("bsf,fd->bsd", h, p[f"{prefix}/w_down"].to(x.dtype))
