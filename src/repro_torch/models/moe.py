"""Mixture-of-Experts block: token-choice top-k routing with a per-expert
capacity.

The port of ``repro/models/moe.py`` (``padded_n_experts``, ``moe_specs``,
``moe_block``, ``_moe_tokens``): router softmax in float32, each token's
top-k experts (weights renormalised), then each expert takes its top-C
tokens by combine weight (``C = min(max(int(t * top_k * cf / e), 4), t)``,
``cf`` the eval or train capacity factor): tokens past C are dropped and
fall back to the residual path, GShard's semantics, kept as ``repro``
has them (at decode, a row's answer may depend on the other rows of its
batch where C < t).  Shared experts (qwen2-moe) add a sigmoid-gated dense
MLP; the aux losses (Switch load balance, router z-loss) come back beside
the output.  Ties in either top-k go to the lowest index first, as
``lax.top_k``'s do.

The combine is deterministic on the card: each expert writes its C rows
into its own slice of an [e, t, d] buffer (within one expert the token
indices are distinct, so this is a scatter, not an accumulate), which is
then summed over e.  ``repro``'s ``.at[idx].add`` ported to ``index_add_``
would accumulate with atomics on a CUDA tensor, so two calls with the same
inputs could differ in the last bit.  Under a sharding context the
expert count is padded to a multiple of the model axis (the phantom
experts' router logits are -1e30, so no token reaches them), the chunking
counts the tokens of one data-parallel shard, and ``constrain`` pins the
dispatch buffers to the expert axis, as in ``repro``; on one device there
are no phantom experts.  ``repro``'s ``_shard_map_combine`` has no caller
there (its scatter measured better) and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.sharding.api import constrain, current_context

_CHUNK_TOKENS = 8192   # token budget of one chunk's dispatch buffers


def padded_n_experts(cfg: ModelConfig) -> int:
    """Experts padded to a multiple of the active context's model axis
    (without a context, the expert count itself)."""
    e = cfg.moe.n_experts
    ctx = current_context()
    tp = ctx.axis_sizes.get("model", 1) if ctx is not None else 1
    return -(-e // tp) * tp


def moe_specs(cfg: ModelConfig, prefix: str, stacked=None,
              n_experts_padded=None) -> dict:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    e = n_experts_padded or m.n_experts
    lead = (stacked,) if stacked else ()
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype

    def spec(shape, axes):
        return ParamSpec(lead + shape, "lecun", dt, logical_axes=la + axes)

    specs = {
        f"{prefix}/router": spec((d, e), ("embed_nofsdp", "experts")),
        f"{prefix}/we_gate": spec((e, d, f), ("experts", "embed", None)),
        f"{prefix}/we_up": spec((e, d, f), ("experts", "embed", None)),
        f"{prefix}/we_down": spec((e, f, d), ("experts", None, "embed")),
    }
    if m.n_shared_experts:
        fs = m.n_shared_experts * f
        specs.update({
            f"{prefix}/ws_gate": spec((d, fs), ("embed", "ffn")),
            f"{prefix}/ws_up": spec((d, fs), ("embed", "ffn")),
            f"{prefix}/ws_down": spec((fs, d), ("ffn", "embed")),
            f"{prefix}/shared_gate": spec((d, 1), ("embed_nofsdp", None)),
        })
    return specs


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, equal
    values lowest index first (``lax.top_k``'s order): a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(cfg: ModelConfig, x: torch.Tensor, p: dict, prefix: str, *,
              train: bool) -> Tuple[torch.Tensor, dict]:
    """x: [b, s, d] -> (out [b, s, d], aux losses dict).

    Long sequences run in sequential chunks along s (their capacity scales
    with the chunk), so the dispatch buffers stay bounded; a decode step's
    b tokens are one chunk."""
    b, s, d = x.shape
    ctx = current_context()
    dp = 1
    if ctx is not None:
        for a in ctx.data_axes:
            dp *= ctx.axis_sizes.get(a, 1)
    per_dev = (b * s) // max(dp, 1)
    n_chunks = 1
    while (per_dev // n_chunks > _CHUNK_TOKENS and s % (n_chunks * 2) == 0
           and s // (n_chunks * 2) >= 1):
        n_chunks *= 2
    if n_chunks == 1:
        return _moe_tokens(cfg, x, p, prefix, train=train)
    sc = s // n_chunks
    outs, auxs = [], []
    for c in range(n_chunks):
        o_c, a_c = _moe_tokens(cfg, x[:, c * sc:(c + 1) * sc], p, prefix,
                               train=train)
        outs.append(o_c)
        auxs.append(a_c)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return torch.cat(outs, dim=1), aux


def _moe_tokens(cfg: ModelConfig, x: torch.Tensor, p: dict, prefix: str, *,
                train: bool) -> Tuple[torch.Tensor, dict]:
    """x: [b, s, d] chunk -> (out [b, s, d], aux)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)

    w_router = p[f"{prefix}/router"]
    e = w_router.shape[-1]
    e_real = m.n_experts

    logits = torch.einsum("td,de->te", xf,
                          w_router.to(xf.dtype)).float()        # [t, e]
    if e > e_real:
        phantom = torch.arange(e, device=logits.device) >= e_real
        logits = torch.where(phantom[None, :],
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, m.top_k)                        # [t, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # per-(token, expert) combine weight (0 if not routed)
    combine_te = torch.zeros_like(probs).scatter(1, top_i, top_p)

    # capacity: top-C tokens per expert by combine weight
    cf = m.capacity_factor if train else m.eval_capacity_factor
    cap = min(max(int(t * m.top_k * cf / m.n_experts), 4), t)
    sel_w, sel_idx = top_k(combine_te.T, cap)                   # [e, C]
    sel_w = torch.where(sel_w > 0, sel_w, torch.zeros_like(sel_w))

    xe = xf[sel_idx.reshape(-1)].reshape(e, cap, d)
    xe = constrain(xe, "experts", "expert_cap", None)
    wg = p[f"{prefix}/we_gate"].to(xe.dtype)
    wu = p[f"{prefix}/we_up"].to(xe.dtype)
    wd = p[f"{prefix}/we_down"].to(xe.dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, wg)) * torch.einsum(
        "ecd,edf->ecf", xe, wu)
    h = constrain(h, "experts", "expert_cap", None)
    ye = torch.einsum("ecf,efd->ecd", h, wd)                    # [e, C, d]
    ye = ye * sel_w[..., None].to(ye.dtype)

    # combine: expert e's rows into slice e of [e, t, d] (distinct token
    # indices within an expert), then the sum over e
    buf = ye.new_zeros((e, t, d)).scatter(
        1, sel_idx[..., None].expand(e, cap, d), ye)
    out = constrain(buf.sum(0), "batch", None)

    # shared experts (always-on) + learned gate (qwen2-moe style)
    if m.n_shared_experts:
        g = F.silu(torch.einsum("bsd,df->bsf", x,
                                p[f"{prefix}/ws_gate"].to(x.dtype)))
        u = torch.einsum("bsd,df->bsf", x, p[f"{prefix}/ws_up"].to(x.dtype))
        hs = constrain(g * u, "batch", "seq_nosp", "ffn")
        ys = torch.einsum("bsf,fd->bsd", hs,
                          p[f"{prefix}/ws_down"].to(x.dtype))
        gate = torch.sigmoid(torch.einsum(
            "bsd,do->bso", x, p[f"{prefix}/shared_gate"].to(x.dtype)))
        out = out + (gate * ys).reshape(t, d)

    # aux losses: load balance (Switch) + router z-loss
    me = combine_te.mean(0) * e_real                     # frac prob mass
    routed = torch.zeros_like(probs).scatter(1, top_i, 1.0)
    ce = routed.mean(0) * e_real / m.top_k
    aux = {
        "moe_load_balance": (me[:e_real] * ce[:e_real]).sum() / e_real,
        "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    return out.reshape(b, s, d).to(x.dtype), aux
