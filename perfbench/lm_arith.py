"""The yardstick's arithmetic for an LM decode cell: the card's peaks, and
the model's operations and a tick's least bytes, counted from the
published ``config.json`` keys of its configuration file (a Granite
4.0-H dense hybrid: Mamba-2 and full-attention layers, a SwiGLU MLP in
every layer, tied embeddings).  None of it reads the program.
"""

from __future__ import annotations

from typing import Mapping

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
BF16_PEAK = 989e12          # FLOP/s, bfloat16 on the tensor cores
HBM_BPS = 3.35e12           # bytes/s, device memory
BYTES = {"float32": 4, "bfloat16": 2}


def mamba_dims(cfg: Mapping):
    """(heads, head size, d_state, conv channels) of a Mamba-2 mixer."""
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n = cfg["mamba_d_state"]
    return h, p, n, h * p + 2 * cfg["mamba_n_groups"] * n


def param_count(cfg: Mapping) -> int:
    """Every parameter: the (tied) embedding, each layer's mixer, MLP and
    two norms, the final norm."""
    d, f = cfg["hidden_size"], cfg["shared_intermediate_size"]
    h, p, n, conv = mamba_dims(cfg)
    d_in = h * p
    mamba = (d * (2 * d_in + 2 * cfg["mamba_n_groups"] * n + h)  # in_proj
             + (cfg["mamba_d_conv"] + 1) * conv                # conv w, b
             + 3 * h + d_in + d_in * d)       # dt_bias, A_log, D; norm; out
    hd = d // cfg["num_attention_heads"]
    attn = 2 * d * d + 2 * d * cfg["num_key_value_heads"] * hd
    per_kind = {"mamba": mamba, "attention": attn}
    layers = sum(per_kind[k] + 3 * d * f + 2 * d
                 for k in cfg["layer_types"])
    return cfg["vocab_size"] * d + layers + d


def flops_per_token(cfg: Mapping) -> float:
    """The model's products for one token: 2 x every parameter (the
    unembedding counted, the embedding's lookup not; attention's products
    over the context left out)."""
    return 2.0 * param_count(cfg)


def tick_floor_bytes(cfg: Mapping, slots: int) -> float:
    """The least bytes one tick of ``slots`` slots must move: the weights
    once, each slot's SSM state (``ssm_state_dtype``) and conv tail
    (``cache_dtype``) read and written once, and the new K / V entries
    written.  The attention's reads of the live cache are left out, so the
    floor stays under the true bytes whatever attention does."""
    h, p, n, conv = mamba_dims(cfg)
    n_mamba = cfg["layer_types"].count("mamba")
    n_attn = cfg["layer_types"].count("attention")
    cache = BYTES[cfg["cache_dtype"]]
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    per_slot = (n_mamba * 2 * (h * p * n * BYTES[cfg["ssm_state_dtype"]]
                               + (cfg["mamba_d_conv"] - 1) * conv * cache)
                + n_attn * 2 * cfg["num_key_value_heads"] * hd * cache)
    return param_count(cfg) * BYTES[cfg["dtype"]] + slots * per_slot
