"""A plain reference of Granite 4.0-H's dense hybrid (``model_type``
``granitemoehybrid`` with no experts, e.g. granite-4.0-h-micro): the
whole-sequence forward, in float32 with TF32 off, written from the
published description and importing nothing but ``torch``.

    logits = forward(cfg, weights, tokens)            # [T, vocab]

``cfg`` holds the published ``config.json``'s keys (``hidden_size``,
``layer_types``, ``mamba_*``, ``num_attention_heads``,
``num_key_value_heads``, ``rms_norm_eps``, ``embedding_multiplier``,
``attention_multiplier``, ``residual_multiplier``, ``logits_scaling``,
``position_embedding_type``, ``vocab_size``).  The forward:

    x = embed[tokens] * embedding_multiplier
    per layer:  x += residual_multiplier * mixer(rmsnorm(x))
                x += residual_multiplier * swiglu(rmsnorm(x))
    logits = rmsnorm(x) @ embed.T / logits_scaling        (tied)

where a "mamba" layer's mixer is Mamba-2 (in_proj -> z | xBC | dt; a
depthwise causal conv with bias and SiLU over xBC; the SSD recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t; the
gated RMSNorm of y * silu(z); out_proj) and an "attention" layer's is
causal GQA with the softmax scale ``attention_multiplier`` and no
positions (NoPE).  The SSD runs in its quadratic (attention-like) form,
y_t = sum_{s<=t} exp(a_t - a_s) (C_t . B_s) dt_s x_s with a the running
sum of dt A, not a chunked scan.  ``state_dtype`` runs the recurrence
step by step instead, carrying h in that dtype between steps (a
precision control: float32 gives the quadratic form's values).

    h = mamba_state(cfg, weights, tokens, layer)      # [heads, P, N]

``mamba_state`` is a Mamba layer's SSM state after the last of
``tokens``, h_T = sum_s exp(a_T - a_s) dt_s x_s B_s^T (float32, the sums
of dt A in float64), or, with ``state_dtype``, the recurrence step by
step with h carried in that dtype.

``weights``: ``embed`` [vocab, d], ``final_norm`` [d] and ``layers``, one
dict a layer: ``input_norm`` and ``post_norm`` [d]; a mamba layer's
``in_proj`` [d, 2 d_inner + 2 groups d_state + heads], ``conv_w`` [k,
conv_dim], ``conv_b`` [conv_dim], ``dt_bias``, ``A_log``, ``D`` [heads],
``gate_norm`` [d_inner], ``out_proj`` [d_inner, d]; an attention layer's
``q_proj`` [d, heads head_dim], ``k_proj`` / ``v_proj`` [d, kv_heads
head_dim], ``o_proj`` [heads head_dim, d]; every layer's ``mlp_gate`` /
``mlp_up`` [d, ffn] and ``mlp_down`` [ffn, d].  Any float dtype; each
layer's tensors are taken to float32 as the layer runs.

Departures from the published description, each at its site: matrices are
[in, out] (``x @ w``, not a linear layer's [out, in]); the SSD's running
sums of dt A are taken in float64 (their differences set the decay, and
float32 loses them at long positions); the final norm and the
unembedding run only at the positions asked for; attention runs one KV
head's group of query heads at a time and the SSD ``HEAD_BLOCK`` heads at
a time, so that a sequence of a few thousand tokens fits on one card at
the published widths.  No cache, no batching: one sequence a call.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

#: SSD heads computed at once in the quadratic form
HEAD_BLOCK = 8


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32 (TF32 off) inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def swiglu(cfg: Mapping, x: torch.Tensor, p: Mapping) -> torch.Tensor:
    return (F.silu(x @ p["mlp_gate"]) * (x @ p["mlp_up"])) @ p["mlp_down"]


def attention(cfg: Mapping, x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """Causal GQA over x [T, d], NoPE, softmax scale
    ``attention_multiplier``."""
    if cfg["position_embedding_type"] != "nope":
        raise ValueError("this reference has no rotary embeddings")
    T = x.shape[0]
    h, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // h
    q = (x @ p["q_proj"]).reshape(T, h, hd)
    k = (x @ p["k_proj"]).reshape(T, hk, hd)
    v = (x @ p["v_proj"]).reshape(T, hk, hd)
    future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    g = h // hk
    out = torch.empty(T, h, hd, dtype=x.dtype, device=x.device)
    for j in range(hk):            # one KV head's query heads at a time
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)         # [g, T, hd]
        s = qj @ k[:, j].T * cfg["attention_multiplier"]     # [g, T, T]
        s = s.masked_fill(future, float("-inf"))
        out[:, j * g:(j + 1) * g] = (torch.softmax(s, -1) @ v[:, j]
                                     ).transpose(0, 1)
    return out.reshape(T, h * hd) @ p["o_proj"]


def ssd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, state_dtype: Optional[torch.dtype]
        ) -> torch.Tensor:
    """The SSD recurrence over one sequence: xdt [T, H, P] (x times dt),
    dA [T, H] (dt times A), B / C [T, G, N] shared by H // G heads each.
    Returns y [T, H, P] without the D skip."""
    T, H, P = xdt.shape
    G, N = B.shape[1], B.shape[2]
    per = H // G
    Bh = B.repeat_interleave(per, 1)                         # [T, H, N]
    Ch = C.repeat_interleave(per, 1)
    if state_dtype is not None:    # step by step, h carried in state_dtype
        h = torch.zeros(H, P, N, dtype=state_dtype, device=xdt.device)
        decay = torch.exp(dA)
        ys = []
        for t in range(T):
            h = (h.float() * decay[t, :, None, None]
                 + xdt[t, :, :, None] * Bh[t, :, None, :]).to(state_dtype)
            ys.append(torch.einsum("hpn,hn->hp", h.float(), Ch[t]))
        return torch.stack(ys)
    # a_t - a_s in float64 (departure: see the module's docstring)
    a = torch.cumsum(dA.double(), 0)                         # [T, H]
    past = torch.ones(T, T, dtype=torch.bool, device=xdt.device).tril()
    y = torch.empty_like(xdt)
    for h0 in range(0, H, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, H))
        seg = a[:, None, hs] - a[None, :, hs]                # [t, s, h]
        L = torch.exp(seg.masked_fill(~past[..., None], float("-inf")))
        cb = torch.einsum("thn,shn->tsh", Ch[:, hs], Bh[:, hs])
        y[:, hs] = torch.einsum("tsh,shp->thp", L.float() * cb, xdt[:, hs])
    return y


def mamba_terms(cfg: Mapping, x: torch.Tensor, p: Mapping):
    """The Mamba-2 mixer's per-token terms over x [T, d]: z [T, d_inner],
    xs [T, H, P], dt and dA = dt A [T, H], B and C [T, G, N]."""
    T = x.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    d_in = H * P
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * G * N, H], -1)
    k = p["conv_w"].shape[0]
    xBC = F.conv1d(xBC.T[None], p["conv_w"].T[:, None, :], p["conv_b"],
                   padding=k - 1, groups=xBC.shape[1])[0, :, :T].T
    xBC = F.silu(xBC)
    xs, B, C = torch.split(xBC, [d_in, G * N, G * N], -1)
    dt = F.softplus(dt + p["dt_bias"])                       # [T, H]
    dA = dt * -torch.exp(p["A_log"])
    return (z, xs.reshape(T, H, P), dt, dA, B.reshape(T, G, N),
            C.reshape(T, G, N))


def mamba(cfg: Mapping, x: torch.Tensor, p: Mapping,
          state_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The Mamba-2 mixer over x [T, d]."""
    z, xs, dt, dA, B, C = mamba_terms(cfg, x, p)
    y = ssd(xs * dt[..., None], dA, B, C, state_dtype)
    y = (y + xs * p["D"][:, None]).reshape(z.shape)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg["rms_norm_eps"])
    return y @ p["out_proj"]


def layer(cfg: Mapping, kind: str, p: Mapping, x: torch.Tensor,
          state_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One layer over the residual stream x [T, d] (``p`` in float32)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rms_norm(x, p["input_norm"], eps)
    if kind == "mamba":
        h = mamba(cfg, h, p, state_dtype)
    elif kind == "attention":
        h = attention(cfg, h, p)
    else:
        raise ValueError(f"layer type {kind!r}")
    x = x + r * h
    return x + r * swiglu(cfg, rms_norm(x, p["post_norm"], eps), p)


def _check(cfg: Mapping, weights: Mapping) -> None:
    if len(weights["layers"]) != len(cfg["layer_types"]):
        raise ValueError(f"{len(weights['layers'])} layers of weights, "
                         f"{len(cfg['layer_types'])} layer_types")


def forward(cfg: Mapping, weights: Mapping, tokens: torch.Tensor,
            positions: Optional[Sequence[int]] = None, *,
            state_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The logits [len(positions), vocab] (float32) of one sequence
    ``tokens`` [T] at ``positions`` (every position when None).
    ``state_dtype``: the SSD run step by step with its state carried in
    that dtype."""
    _check(cfg, weights)
    with no_tf32(), torch.no_grad():
        emb = weights["embed"].float()
        x = emb[tokens] * cfg["embedding_multiplier"]
        for kind, p in zip(cfg["layer_types"], weights["layers"]):
            p = {k: v.float() for k, v in p.items()}
            x = layer(cfg, kind, p, x, state_dtype)
        if positions is not None:
            x = x[torch.as_tensor(list(positions), device=x.device)]
        x = rms_norm(x, weights["final_norm"].float(), cfg["rms_norm_eps"])
        return (x @ emb.T) / cfg["logits_scaling"]


def mamba_state(cfg: Mapping, weights: Mapping, tokens: torch.Tensor,
                index: int, *, state_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """The SSM state [H, P, N] (float32) of the Mamba layer ``index``
    after the last of ``tokens`` [T]: the closed form h_T = sum_s exp(a_T
    - a_s) dt_s x_s B_s^T, with a the running sum of dt A in float64, or
    with ``state_dtype`` the recurrence step by step, h carried in that
    dtype (a precision control).  The layers before it run as
    ``forward``'s (a float32 state there)."""
    _check(cfg, weights)
    if cfg["layer_types"][index] != "mamba":
        raise ValueError(f"layer {index} is not a mamba layer")
    with no_tf32(), torch.no_grad():
        x = weights["embed"].float()[tokens] * cfg["embedding_multiplier"]
        for kind, p in zip(cfg["layer_types"][:index],
                           weights["layers"][:index]):
            x = layer(cfg, kind, {k: v.float() for k, v in p.items()}, x,
                      None)
        p = {k: v.float() for k, v in weights["layers"][index].items()}
        _, xs, dt, dA, B, _ = mamba_terms(
            cfg, rms_norm(x, p["input_norm"], cfg["rms_norm_eps"]), p)
        xdt = xs * dt[..., None]                             # [T, H, P]
        Bh = B.repeat_interleave(xs.shape[1] // B.shape[1], 1)  # [T, H, N]
        if state_dtype is not None:
            h = torch.zeros(xdt.shape[1:] + Bh.shape[-1:],
                            dtype=state_dtype, device=xdt.device)
            decay = torch.exp(dA)
            for t in range(xdt.shape[0]):
                h = (h.float() * decay[t, :, None, None]
                     + xdt[t, :, :, None] * Bh[t, :, None, :]
                     ).to(state_dtype)
            return h.float()
        a = torch.cumsum(dA.double(), 0)                     # [T, H]
        w = torch.exp(a[-1] - a).float()
        return torch.einsum("th,thp,thn->hpn", w, xdt, Bh)
