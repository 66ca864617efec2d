"""Logical-axis -> mesh-axis rules (MaxText-style), per parallelism profile.

Logical axes used by the model zoo:

  batch        global batch                    -> all data-parallel axes
  seq          sequence (residual storage)     -> 'model' when SP is on
  seq_nosp     sequence, never sharded
  embed        d_model                         -> FSDP ('data') on weights
  embed_act    d_model on activations          -> unsharded
  heads        query heads                     -> 'model' (TP)
  kv_heads     kv heads                        -> 'model' if divisible else None
  kv_heads_r   kv heads, forced replicated
  head_dim     per-head dim                    -> unsharded
  ffn          MLP hidden                      -> 'model' (TP)
  vocab        vocabulary                      -> 'model' (parallel xent)
  experts      MoE experts                     -> 'model' (EP)
  expert_cap   expert capacity                 -> unsharded
  ssm_heads    mamba value heads               -> 'model' (TP)
  ssm_state    SSM state dim                   -> unsharded
  lru_width    RG-LRU width                    -> 'model' (TP)
  conv         conv taps                       -> unsharded
  layers       stacked-scan layer dim          -> unsharded
  rnn_hidden / rnn_gates / rnn_in              paper RNN tagger dims

A rule maps logical name -> mesh axis (str | tuple | None).  ``data_axes`` in
the context decides what 'batch' means ('data' alone or ('pod','data')).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

# Profile: family -> {logical axis -> mesh axis}.  'batch' and FSDP axes are
# filled dynamically from the context's data axes.
_BASE: Dict[str, MeshAxes] = {
    "batch": "__data__",          # placeholder -> ctx.data_axes
    "seq": None,
    "seq_nosp": None,
    "embed": "__data__",          # FSDP shard of weight d_model dim
    "embed_nofsdp": None,
    "embed_act": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_heads_r": None,
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_ffn": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "lru_width": "model",
    "conv": None,
    "layers": None,
    "seq_chunks": "model",        # SP attention chunk-grid dim
    "rnn_hidden": None,
    "rnn_gates": None,
    "rnn_in": None,
    "kv_seq": None,               # kv-cache sequence dim (decode)
    "qkv_fused": "model",
}

# dense transformers: Megatron TP + SP residuals + FSDP
_DENSE = dict(_BASE)
_DENSE.update({"seq": "model"})

# MoE: no SP (model axis is used by experts/ffn); EP over 'model'
_MOE = dict(_BASE)

# SSM / hybrid: TP over heads/width, sequence unsharded (recurrence is local)
_SSM = dict(_BASE)
_HYBRID = dict(_BASE)

# enc-dec (whisper-scale is small): TP + FSDP, no SP (short decoder seqs)
_ENCDEC = dict(_BASE)

# paper RNN taggers: replicated (they are kilobyte-scale) — batch DP only
_RNN = dict(_BASE)
_RNN.update({"heads": None, "ffn": None, "vocab": None, "embed": None})

# decode profiles: kv cache seq dim sharded over 'model' (flash-decode),
# weights TP as usual, no FSDP gathering needed (inference)
_DECODE = dict(_BASE)
_DECODE.update({"kv_seq": "model", "seq": None, "embed": None})

_DECODE_MOE = dict(_DECODE)
_DECODE_SSM = dict(_DECODE)

RULE_PROFILES: Dict[str, Dict[str, MeshAxes]] = {
    "dense": _DENSE,
    "moe": _MOE,
    "ssm": _SSM,
    "hybrid": _HYBRID,
    "audio": _ENCDEC,
    "vlm": _DENSE,
    "rnn": _RNN,
    "dense_decode": _DECODE,
    "moe_decode": _DECODE_MOE,
    "ssm_decode": _DECODE_SSM,
    "hybrid_decode": _DECODE_SSM,
    "audio_decode": _DECODE,
    "vlm_decode": _DECODE,
    "rnn_decode": _RNN,
}


def rules_for(family: str, kind: str = "train") -> Dict[str, MeshAxes]:
    key = family if kind in ("train", "prefill") else f"{family}_decode"
    if key not in RULE_PROFILES:
        key = family
    return RULE_PROFILES[key]
