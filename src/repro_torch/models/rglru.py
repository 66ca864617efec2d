"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): its
parameter specs, its sequence forward and its single-token decode.

A gated linear recurrence,
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates,
the analogue at LM scale of the paper's LSTM/GRU state update.

The port of ``repro/models/rglru.py``.  Prefill and training
(``rglru_mix``) run the recurrence over the sequence as an associative
scan in tensor ops (``_scan_linear_recurrence``: doubling passes within
chunks of 256, a carry loop over the chunks, one combine pass), as
``repro`` runs ``lax.associative_scan``; decode is the O(1)
"static-mode" state update, one ``a * h + b`` step.  Both stay outside
any kernel, as in ``repro``: no model calls ``rglru_scan``.  The gate
products take compute-dtype inputs with a float32 result (``repro``'s
``preferred_element_type``); the decay math and the state are float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import ACTIVATIONS
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding.api import constrain

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_specs(cfg: ModelConfig, prefix: str, stacked=None) -> dict:
    rg = cfg.rglru
    d = cfg.d_model
    w = rg.lru_width or d
    lead = (stacked,) if stacked else ()
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype

    def spec(shape, axes, init, scale=1.0):
        return ParamSpec(lead + shape, init, dt, scale, la + axes)

    return {
        f"{prefix}/w_x": spec((d, w), ("embed", "lru_width"), "lecun"),
        f"{prefix}/w_gate": spec((d, w), ("embed", "lru_width"), "lecun"),
        f"{prefix}/conv_w": spec((rg.conv_width, w), ("conv", "lru_width"),
                                 "lecun", 3.0),
        f"{prefix}/conv_b": spec((w,), ("lru_width",), "zeros"),
        f"{prefix}/lambda": spec((w,), ("lru_width",), "ones"),
        f"{prefix}/wa_gate": spec((w, w), ("lru_width", None), "lecun"),
        f"{prefix}/wi_gate": spec((w, w), ("lru_width", None), "lecun"),
        f"{prefix}/ba_gate": spec((w,), ("lru_width",), "zeros"),
        f"{prefix}/bi_gate": spec((w,), ("lru_width",), "zeros"),
        f"{prefix}/w_out": spec((w, d), ("lru_width", "embed"), "lecun"),
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


def _combine(e1, e2):
    """The scan's operator: e1 (earlier) then e2, each an (a, b) pair of
    ``h -> a * h + b``."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _scan(a: torch.Tensor, b: torch.Tensor,
          dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` along ``dim`` by doubling passes
    (ceil(log2 T) of them): after the pass of stride d each position holds
    the combination of the 2d positions up to it."""
    T = a.shape[dim]
    d = 1
    while d < T:
        a_new, b_new = _combine((a.narrow(dim, 0, T - d),
                                 b.narrow(dim, 0, T - d)),
                                (a.narrow(dim, d, T - d),
                                 b.narrow(dim, d, T - d)))
        a = torch.cat([a.narrow(dim, 0, d), a_new], dim)
        b = torch.cat([b.narrow(dim, 0, d), b_new], dim)
        d *= 2
    return a, b


def _scan_linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                            h0: Optional[torch.Tensor] = None,
                            chunk: int = 256) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 of [B, T, W], from ``h0``
    [B, W] (zeros when None).

    ``repro``'s two-level schedule: where T > chunk and chunk divides T,
    scans within chunks (all chunks at once), a sequential carry over the
    chunks, and one pass that adds each chunk's incoming state; otherwise
    one scan over all of T."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    Bsz, T, W = a.shape
    if T <= chunk or T % chunk != 0:
        return _scan(a, b, 1)[1]
    nc = T // chunk
    A_cum, h_within = _scan(a.reshape(Bsz, nc, chunk, W),
                            b.reshape(Bsz, nc, chunk, W), 2)
    A_c = A_cum[:, :, -1]                       # [B, nc, W] chunk decay
    h_c = h_within[:, :, -1]                    # [B, nc, W] chunk output
    h_in = torch.zeros((Bsz, W), dtype=a.dtype, device=a.device)
    h_ins = []
    for c in range(nc):
        h_ins.append(h_in)                      # the state before chunk c
        h_in = A_c[:, c] * h_in + h_c[:, c]
    h = h_within + A_cum * torch.stack(h_ins, 1)[:, :, None, :]
    return h.reshape(Bsz, T, W)


def rglru_mix(cfg: ModelConfig, x: torch.Tensor, p: dict, prefix: str,
              state: Optional[torch.Tensor] = None,
              conv_cache: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """Griffin's recurrent temporal-mixing block over a sequence.  x: [b,
    s, d] -> out [b, s, d]; with ``return_state`` also (the last
    pre-gate state [b, w] float32, the new conv cache)."""
    gate = ACTIVATIONS["gelu"](
        torch.einsum("bsd,dw->bsw", x, p[f"{prefix}/w_gate"].to(x.dtype)))
    xb = torch.einsum("bsd,dw->bsw", x, p[f"{prefix}/w_x"].to(x.dtype))
    xb = constrain(xb, "batch", "seq_nosp", "lru_width")
    xc, new_conv_cache = _causal_conv(
        xb, p[f"{prefix}/conv_w"].to(x.dtype),
        p[f"{prefix}/conv_b"].to(x.dtype), conv_cache)

    i, log_a = _lru_gates(p, prefix, xc)
    a = torch.exp(log_a)                                    # [b,s,w] f32
    # sqrt(1 - a^2) input normalisation (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = _scan_linear_recurrence(a, beta * (i * xc.float()),
                                None if state is None else state.float())
    h_last = h[:, -1]
    h = h.to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", h, p[f"{prefix}/w_out"].to(x.dtype))
    if return_state:
        return out, (h_last, new_conv_cache)
    return out


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
