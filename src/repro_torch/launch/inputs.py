"""Meta-device stand-ins for every model input: the dry run's.

The port of ``repro/launch/inputs.py``.  ``batch_specs`` /
``decode_input_specs`` give tensors on the ``meta`` device (no storage)
with ``repro``'s shapes and dtypes; under a context on a ``DeviceMesh``
they are DTensors with the placements of ``repro``'s pspecs.  Each
stand-in carries its pspec as ``.pspec`` (``None`` without a context).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.decode import cache_specs
from repro_torch.models.init import abstract_params, meta_tensor

WHISPER_TEXT_LEN = 448


def _sds(shape, dtype: str, ctx, axes) -> torch.Tensor:
    t = meta_tensor(tuple(shape), getattr(torch, dtype), ctx, axes)
    t.pspec = ctx.pspec(axes) if ctx is not None else None
    return t


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx) -> Dict:
    """Training/prefill batch: tokens/labels (+ frontend stubs)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "rnn":
        r = cfg.rnn
        return {
            "x": _sds((B, r.seq_len, r.input_size), "float32", ctx,
                      ("batch", None, None)),
            "y": _sds((B,), "int32", ctx, ("batch",)),
        }
    if cfg.enc_dec:
        out = {
            "frame_embeds": _sds((B, S, cfg.d_model), cfg.compute_dtype, ctx,
                                 ("batch", None, None)),
            "tokens": _sds((B, WHISPER_TEXT_LEN), "int32", ctx,
                           ("batch", None)),
        }
        if shape.kind == "train":
            out["labels"] = _sds((B, WHISPER_TEXT_LEN), "int32", ctx,
                                 ("batch", None))
        return out
    if cfg.frontend == "vision":
        n_img = cfg.n_frontend_tokens
        out = {
            "tokens": _sds((B, S - n_img), "int32", ctx, ("batch", None)),
            "img_embeds": _sds((B, n_img, cfg.d_model), cfg.compute_dtype,
                               ctx, ("batch", None, None)),
        }
        if shape.kind == "train":
            out["labels"] = _sds((B, S), "int32", ctx, ("batch", None))
        return out
    out = {"tokens": _sds((B, S), "int32", ctx, ("batch", None))}
    if shape.kind == "train":
        out["labels"] = _sds((B, S), "int32", ctx, ("batch", None))
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, ctx
                       ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """(cache, tokens, pos) stand-ins for ``decode_step``."""
    B, S = shape.global_batch, shape.seq_len
    cspecs = cache_specs(cfg, B, S)
    cache = abstract_params(cspecs, ctx)
    for k, t in cache.items():
        t.pspec = ctx.pspec(cspecs[k].axes) if ctx is not None else None
    tokens = _sds((B, 1), "int32", ctx, ("batch", None))
    pos = _sds((B,), "int32", ctx, ("batch",))
    return cache, tokens, pos
