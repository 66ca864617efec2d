"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): its
parameter specs and its single-token decode.

A gated linear recurrence,
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates,
the analogue at LM scale of the paper's LSTM/GRU state update.

The port of the decode part of ``repro/models/rglru.py`` (``rglru_specs``,
``_lru_gates``, ``rglru_decode_step``): the O(1) "static-mode" state
update, one ``a * h + b`` step in plain tensor ops, as ``repro`` runs it
in XLA outside any kernel (no model calls ``rglru_scan``).  The gate
products take compute-dtype inputs with a float32 result (``repro``'s
``preferred_element_type``); the decay math and the state are float32.
``rglru_mix`` and its scans (prefill) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import ACTIVATIONS
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_specs(cfg: ModelConfig, prefix: str, stacked=None) -> dict:
    rg = cfg.rglru
    d = cfg.d_model
    w = rg.lru_width or d
    lead = (stacked,) if stacked else ()
    dt = cfg.param_dtype
    return {
        f"{prefix}/w_x": ParamSpec(lead + (d, w), "lecun", dt),
        f"{prefix}/w_gate": ParamSpec(lead + (d, w), "lecun", dt),
        f"{prefix}/conv_w": ParamSpec(lead + (rg.conv_width, w), "lecun",
                                      dt, 3.0),
        f"{prefix}/conv_b": ParamSpec(lead + (w,), "zeros", dt),
        f"{prefix}/lambda": ParamSpec(lead + (w,), "ones", dt),
        f"{prefix}/wa_gate": ParamSpec(lead + (w, w), "lecun", dt),
        f"{prefix}/wi_gate": ParamSpec(lead + (w, w), "lecun", dt),
        f"{prefix}/ba_gate": ParamSpec(lead + (w,), "zeros", dt),
        f"{prefix}/bi_gate": ParamSpec(lead + (w,), "zeros", dt),
        f"{prefix}/w_out": ParamSpec(lead + (w, d), "lecun", dt),
    }


def _gate_product(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsw,wv->bsv", xc, w.astype(xc.dtype),
    preferred_element_type=float32)``: w rounded to xc's dtype, the
    product of those values in float32 (exact inputs, f32 sums)."""
    return torch.einsum("bsw,wv->bsv", xc.float(), w.to(xc.dtype).float())


def _lru_gates(p: dict, prefix: str, xc: torch.Tensor):
    """Input gate and log-decay, float32.  xc: [b, s, w] (post-conv)."""
    r = torch.sigmoid(_gate_product(xc, p[f"{prefix}/wa_gate"])
                      + p[f"{prefix}/ba_gate"].float())
    i = torch.sigmoid(_gate_product(xc, p[f"{prefix}/wi_gate"])
                      + p[f"{prefix}/bi_gate"].float())
    log_a = (-_C * torch.nn.functional.softplus(p[f"{prefix}/lambda"].float())
             * r)
    return i, log_a


def rglru_decode_step(cfg: ModelConfig, x: torch.Tensor, p: dict,
                      prefix: str, state: torch.Tensor,
                      conv_cache: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Single-token decode.  x: [b, 1, d]; state: [b, w] float32;
    conv_cache [b, conv_width-1, w].  Returns (out [b, 1, d], (new state,
    new conv cache))."""
    gate = ACTIVATIONS["gelu"](
        torch.einsum("bsd,dw->bsw", x, p[f"{prefix}/w_gate"].to(x.dtype)))
    xb = torch.einsum("bsd,dw->bsw", x, p[f"{prefix}/w_x"].to(x.dtype))
    xc, new_conv_cache = _causal_conv(
        xb, p[f"{prefix}/conv_w"].to(x.dtype),
        p[f"{prefix}/conv_b"].to(x.dtype), conv_cache)

    i, log_a = _lru_gates(p, prefix, xc)                    # [b,1,w]
    a = torch.exp(log_a[:, 0])
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a[:, 0]),
                                  min=1e-12))
    new_state = a * state + beta * (i[:, 0] * xc[:, 0].float())
    h = new_state[:, None].to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", h, p[f"{prefix}/w_out"].to(x.dtype))
    return out, (new_state, new_conv_cache)
