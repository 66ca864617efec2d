"""Mamba-2 (SSD, state-space duality) block, arXiv:2405.21060: its
parameter specs, its sequence forward and its single-token decode.

The port of ``repro/models/ssm.py``.  Prefill and training run the chunked
SSD (``_ssd_chunked``): within a chunk the quadratic, attention-like form,
across chunks a recurrence of the [b, h, p, n] float32 state, carried by a
Python loop where ``repro`` runs a ``lax.scan``.  Decode is the O(1) state
update, the paper's "static mode" RNN block: the state stays resident,
one step a token.  As in ``repro`` these are plain tensor ops outside any
kernel; every cast is ``repro``'s, and a mixed-dtype product runs in the
promoted dtype, as ``jnp.einsum`` does.

One deliberate difference (``ROADMAP.md`` §3): the intra-chunk decay is
``exp(where(tril, seg, -inf))`` where ``repro`` takes ``where(tril,
exp(seg), 0)``.  The forward has the same bits (exp(-inf) is exactly 0),
but above the diagonal ``seg`` is positive and its ``exp`` can overflow to
inf at a real chunk size and ``dt``; ``repro``'s backward then multiplies
that inf by a zero cotangent, a NaN, where the port's stays finite.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import rms_norm
from repro_torch.sharding.api import constrain


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, value heads, conv channels) of the block."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def ssm_specs(cfg: ModelConfig, prefix: str, stacked=None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, h, conv_dim = ssm_dims(cfg)
    lead = (stacked,) if stacked else ()
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype

    def spec(shape, axes, init, scale=1.0):
        return ParamSpec(lead + shape, init, dt, scale, la + axes)

    # in_proj emits [z (d_in), xBC (conv_dim), dt (h)]
    return {
        f"{prefix}/w_in": spec(
            (d, 2 * d_in + 2 * s.n_groups * s.d_state + h),
            ("embed", "ssm_inner"), "lecun"),
        f"{prefix}/conv_w": spec((s.d_conv, conv_dim), ("conv", "ssm_inner"),
                                 "lecun", 3.0),
        f"{prefix}/conv_b": spec((conv_dim,), ("ssm_inner",), "zeros"),
        f"{prefix}/dt_bias": spec((h,), ("ssm_heads",), "zeros"),
        f"{prefix}/a_log": spec((h,), ("ssm_heads",), "ones"),
        f"{prefix}/d_skip": spec((h,), ("ssm_heads",), "ones"),
        f"{prefix}/norm_scale": spec((d_in,), ("ssm_inner",), "zeros"),
        f"{prefix}/w_out": spec((d_in, d), ("ssm_inner", "embed"), "lecun"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: [b, s, c]; w: [k, c]; cache: the last k-1
    inputs [b, k-1, c] (zeros when None).  Returns (y, new cache).

    The new cache holds x's values (``repro`` hands back x's dtype); it is
    kept in the wider of x's and the old cache's dtypes, which holds those
    values exactly and does not change from step to step."""
    k = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [b, s+k-1, c]
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1]] * w[i][None, None]
    y = y + b[None, None]
    keep = (x.dtype if cache is None
            else torch.promote_types(cache.dtype, x.dtype))
    return y, xp[:, -(k - 1):].to(keep)


def _ssd_chunked(xdt: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD core over chunks of ``chunk`` positions.  xdt: [b, s, h, p]
    (x times dt), log_a: [b, s, h] (float32), B, C: [b, s, g, n]; heads
    grouped as h = g * hg (B / C shared by a group).  Returns (y [b, s, h,
    p] in xdt's dtype, final state [b, h, p, n] float32).

    A ragged tail is padded with the identity (log_a = 0, x = 0: the
    state passes through unchanged); each chunk adds its intra-chunk term
    and the carried state's term, then updates the state."""
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    pad = (-s) % chunk
    if pad:
        def zpad(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xdt, log_a, B, C = zpad(xdt), zpad(log_a), zpad(B), zpad(C)
        s = s + pad
    nc = s // chunk
    hg = h // g
    q = chunk

    xdt = xdt.reshape(b, nc, q, g, hg, p)
    log_a = log_a.reshape(b, nc, q, g, hg)
    B = B.reshape(b, nc, q, g, n)
    C = C.reshape(b, nc, q, g, n)

    tril = torch.ones((q, q), dtype=torch.bool,
                      device=xdt.device).tril()[None, :, :, None, None]
    neg_inf = torch.full((), float("-inf"), device=xdt.device)
    state = (torch.zeros((b, g, hg, p, n), dtype=torch.float32,
                         device=xdt.device)
             if initial_state is None
             else initial_state.reshape(b, g, hg, p, n).float())
    ys = []
    for c in range(nc):
        xdt_c, B_c, C_c = xdt[:, c], B[:, c], C[:, c]
        xf = xdt_c.float()
        la = torch.cumsum(log_a[:, c], dim=1)              # [b,q,g,hg] f32
        # intra-chunk triangular term (exp of -inf above the diagonal: 0
        # with a finite gradient)
        seg = la[:, :, None] - la[:, None, :]              # [b,i,j,g,hg]
        decay = torch.exp(torch.where(tril, seg, neg_inf))
        cb = torch.einsum("bign,bjgn->bijg", C_c.float(), B_c.float())
        y_intra = torch.einsum("bijg,bijgh,bjghp->bighp", cb, decay, xf)
        # inter-chunk term from the carried state
        y_inter = torch.einsum("bqgn,bghpn->bqghp", C_c.float(),
                               state) * torch.exp(la)[..., None]
        # state update
        la_last = la[:, -1:]                               # [b,1,g,hg]
        s_c = torch.einsum("bqgn,bqgh,bqghp->bghpn", B_c.float(),
                           torch.exp(la_last - la), xf)
        state = state * torch.exp(la_last[:, 0])[..., None, None] + s_c
        ys.append((y_intra + y_inter).to(xdt_c.dtype))
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)[:, :s_orig]
    return y, state.reshape(b, h, p, n)


def ssm_block(cfg: ModelConfig, x: torch.Tensor, p: dict,
              prefix: str) -> torch.Tensor:
    """The training / prefill forward.  x: [b, s, d] -> [b, s, d]."""
    return ssm_block_with_state(cfg, x, p, prefix)[0]


def ssm_block_with_state(cfg: ModelConfig, x: torch.Tensor, p: dict,
                         prefix: str,
                         initial_state: Optional[torch.Tensor] = None,
                         conv_cache: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """x: [b, s, d] from ``initial_state`` [b, h, p, n] and ``conv_cache``
    (zeros when None) -> (out [b, s, d] in x's dtype, (final state, new
    conv cache))."""
    s_cfg = cfg.ssm
    d_in, h, conv_dim = ssm_dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.d_state
    b, s, _ = x.shape

    zxbcdt = torch.einsum("bsd,de->bse", x, p[f"{prefix}/w_in"].to(x.dtype))
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_dim, h], dim=-1)
    xBC, new_conv_cache = _causal_conv(
        xBC, p[f"{prefix}/conv_w"].to(x.dtype),
        p[f"{prefix}/conv_b"].to(x.dtype), conv_cache)
    xBC = F.silu(xBC)
    xv, B, C = torch.split(xBC, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + p[f"{prefix}/dt_bias"].float())
    a = -torch.exp(p[f"{prefix}/a_log"].float())            # [h], negative
    log_a = dt * a[None, None, :]                            # [b,s,h]

    xv = xv.reshape(b, s, h, s_cfg.head_dim)
    xdt = xv * dt[..., None].to(xv.dtype)
    xdt = constrain(xdt, "batch", "seq_nosp", "ssm_heads", None)
    y, final_state = _ssd_chunked(xdt, log_a, B.reshape(b, s, g, n),
                                  C.reshape(b, s, g, n),
                                  min(s_cfg.chunk_size, s), initial_state)
    y = y + xv * p[f"{prefix}/d_skip"].to(xv.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p[f"{prefix}/norm_scale"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p[f"{prefix}/w_out"].to(y.dtype))
    return out.to(x.dtype), (final_state, new_conv_cache)


def ssm_decode_step(cfg: ModelConfig, x: torch.Tensor, p: dict, prefix: str,
                    state: torch.Tensor, conv_cache: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Single-token decode: x [b, 1, d]; state [b, h, p, n] (float32);
    conv_cache [b, d_conv-1, conv_dim].  Returns (out [b, 1, d] in x's
    dtype, (new state, new conv cache)).  O(1) in context length."""
    s_cfg = cfg.ssm
    d_in, h, conv_dim = ssm_dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.d_state
    b = x.shape[0]

    zxbcdt = torch.einsum("bsd,de->bse", x, p[f"{prefix}/w_in"].to(x.dtype))
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_dim, h], dim=-1)
    xBC, new_conv_cache = _causal_conv(
        xBC, p[f"{prefix}/conv_w"].to(x.dtype),
        p[f"{prefix}/conv_b"].to(x.dtype), conv_cache)
    xBC = F.silu(xBC)
    xv, B, C = torch.split(xBC, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float()
                    + p[f"{prefix}/dt_bias"].float())[:, 0]      # [b,h]
    a = -torch.exp(p[f"{prefix}/a_log"].float())
    a_t = torch.exp(dt * a[None, :])                             # [b,h]

    xv = xv.reshape(b, h, s_cfg.head_dim)
    xdt = xv * dt[..., None].to(xv.dtype)
    hg = h // g
    Bh = B.reshape(b, g, n).repeat_interleave(hg, dim=1)        # [b,h,n]
    Ch = C.reshape(b, g, n).repeat_interleave(hg, dim=1)

    new_state = (state * a_t[..., None, None].to(state.dtype)
                 + xdt[..., :, None] * Bh[..., None, :])         # [b,h,p,n]
    # the f32 state and C in their promoted dtype, as jnp.einsum takes them
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.to(new_state.dtype))
    y = y + xv * p[f"{prefix}/d_skip"].to(xv.dtype)[None, :, None]
    y = y.reshape(b, 1, d_in)
    y = rms_norm(y * F.silu(z), p[f"{prefix}/norm_scale"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p[f"{prefix}/w_out"].to(y.dtype))
    return out.to(x.dtype), (new_state, new_conv_cache)
