"""Per-(arch, mesh, shape) sharding auto-configuration.

The port of ``repro/sharding/auto.py``, line for line.  Divisibility
drives the layout: a logical axis is TP-sharded over 'model' only when its
size divides the axis; otherwise it falls back (replication or an
alternative parallel dim), and attention picks the 'sp' schedule when the
head count does not divide the TP width (gemma-2b: 8 heads,
deepseek-coder: 56 heads on a 16-wide axis).  ``mesh`` is a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(``sharding.api.mesh_view``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.sharding.api import mesh_view


def dp_size(mesh: Any) -> int:
    shape = mesh_view(mesh).shape
    n = 1
    for a in ("pod", "data"):
        n *= shape.get(a, 1)
    return n


def auto_overrides(cfg: ModelConfig, mesh: Any,
                   shape: Optional[ShapeConfig] = None) -> Dict[str, object]:
    view = mesh_view(mesh)
    tp = view.shape.get("model", 1)
    dp = dp_size(mesh)
    ov: Dict[str, object] = {}

    if cfg.family == "rnn":
        return ov

    # batch divisibility (long_500k has global_batch=1)
    if shape is not None and shape.global_batch % max(dp, 1) != 0:
        if shape.global_batch % view.shape.get("data", 1) == 0:
            ov["batch"] = "data"
        else:
            ov["batch"] = None

    if cfg.n_heads:
        heads_div = cfg.n_heads % tp == 0
        kv_div = cfg.n_kv_heads % tp == 0
        if not heads_div:
            ov["heads"] = None
            ov["__attn_mode__"] = "sp"
        if not kv_div:
            ov["kv_heads"] = None

    if cfg.d_ff and cfg.d_ff % tp != 0:
        ov["ffn"] = None

    # vocab-parallel loss requires divisibility (whisper pads, see transformer)
    from repro_torch.models.transformer import padded_vocab
    if padded_vocab(cfg) % tp != 0:
        ov["vocab"] = None

    if cfg.ssm is not None:
        from repro_torch.models.ssm import ssm_dims
        d_in, h, conv_dim = ssm_dims(cfg)
        if h % tp != 0:
            ov["ssm_heads"] = None
        if d_in % tp != 0 or conv_dim % tp != 0:
            ov["ssm_inner"] = None

    if cfg.rglru is not None:
        w = cfg.rglru.lru_width or cfg.d_model
        if w % tp != 0:
            ov["lru_width"] = None

    # SP residual requires seq % tp == 0 (and is train/prefill only)
    if shape is not None and shape.kind in ("train", "prefill"):
        if shape.seq_len % tp != 0:
            ov["seq"] = None
            ov["seq_chunks"] = None
    if shape is not None and shape.kind == "decode":
        # kv cache seq dim must divide the model axis
        if shape.seq_len % tp != 0:
            ov["kv_seq"] = None
        if cfg.rglru is not None and min(cfg.rglru.window, shape.seq_len) % tp != 0:
            ov["kv_seq"] = None
        # big-weight archs: TP alone leaves GiBs of bf16 weights per device;
        # switch to 2D weight sharding (embed over 'data') with the batch
        # replicated.  Threshold 2 GiB, as repro's.
        if cfg.family != "rnn":
            wb = cfg.param_count() * 2 / max(tp, 1)
            if wb > 2 * 2 ** 30 and "data" in view.axis_names:
                ov["batch"] = None
                ov["embed"] = "data"
                if shape.seq_len % (tp * view.shape["data"]) == 0:
                    ov["kv_seq"] = ("data", "model")

    return ov
