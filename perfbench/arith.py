"""The yardstick's arithmetic: the card's peaks, and each tagger's
operations and bytes counted from its published shapes.

The counts are those of ``chip_smoke.py``'s bounds: a product of [M, K] by
[K, N] is 2·M·K·N operations; the recurrent layer over B events of T steps
does 2·B·T·(in + H)·G·H (G = 4 LSTM gates, 3 GRU) and reads x, W, U and b
once and writes the final h once, in float32.  None of it depends on the
schedule the program runs.
"""

from __future__ import annotations

from typing import Mapping

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
F32_PEAK = 67e12            # FLOP/s, float32 outside the tensor cores
HBM_BPS = 3.35e12           # bytes/s, device memory
F32_BYTES = 4


def gates(cfg: Mapping) -> int:
    return 4 if cfg["cell"] == "lstm" else 3


def rnn_flops(cfg: Mapping, events: int) -> float:
    """The recurrent layer's products over ``events`` events."""
    h = cfg["hidden"]
    return (2.0 * events * cfg["seq_len"] * (cfg["input_size"] + h)
            * gates(cfg) * h)


def rnn_bytes(cfg: Mapping, events: int) -> int:
    """x, W, U and b read once, the final h written once (float32)."""
    h, fin, g = cfg["hidden"], cfg["input_size"], gates(cfg)
    bias = g * h if cfg["cell"] == "lstm" else 2 * g * h
    return F32_BYTES * (events * cfg["seq_len"] * fin + fin * g * h
                        + h * g * h + bias + events * h)


def head_flops(cfg: Mapping, events: int) -> float:
    """The dense head's products: hidden -> dense_sizes -> n_outputs."""
    widths = [cfg["hidden"], *cfg["dense_sizes"], cfg["n_outputs"]]
    return 2.0 * events * sum(a * b for a, b in zip(widths, widths[1:]))


def model_flops(cfg: Mapping, events: int) -> float:
    """The tagger's products for ``events`` events."""
    return rnn_flops(cfg, events) + head_flops(cfg, events)


def rnn_bound_s(cfg: Mapping, events: int) -> float:
    """The least time the card could take for the recurrent layer: the
    larger of its operations over the f32 peak and its bytes over the
    device memory's bandwidth."""
    return max(rnn_flops(cfg, events) / F32_PEAK,
               rnn_bytes(cfg, events) / HBM_BPS)
