"""Post-training quantization + AUC profiling (paper Sec. 5.1, Fig. 2).

The paper quantizes trained Keras models post-training (PTQ) and scans the
AUC ratio (quantized / float) as a function of fractional bits at fixed
integer bits {6, 8, 10, 12}.  ``auc_scan`` reproduces that protocol.

``forward_fn(cfg, params, x, fp=...)`` runs a tagger on ``x`` (a CPU
float32 tensor) and returns class probabilities; :func:`tagger_forward` is
the port's ``RNNTagger`` call in that form.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.core.quant.fixed_point import quantize_params


def ptq_quantize_model(params: Dict, fp: FixedPointConfig) -> Dict:
    """Quantize all weights/biases to the ap_fixed grid (host-side, exact)."""
    return quantize_params(params, fp)


def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUC via the rank statistic (exact, ties averaged)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel()
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            avg = (ranks[order[i]] + ranks[order[j]]) / 2.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels > 0].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def multiclass_mean_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean one-vs-rest AUC (paper's top-1 AUC metric for multiclass)."""
    n_classes = probs.shape[-1]
    aucs = [binary_auc(probs[:, c], (labels == c).astype(np.int32))
            for c in range(n_classes)]
    return float(np.nanmean(aucs))


def tagger_forward(cfg: ModelConfig, params: Dict, x: torch.Tensor, *,
                   fp: Optional[FixedPointConfig] = None,
                   impl: str = "xla") -> torch.Tensor:
    """The port's tagger on ``x``'s device, as a ``forward_fn``."""
    from repro_torch.models.rnn_tagger import RNNTagger

    with torch.inference_mode():
        return RNNTagger(cfg, params, device=x.device)(x, fp=fp, impl=impl)


def model_auc(cfg: ModelConfig, forward_fn: Callable, params: Dict,
              x: np.ndarray, y: np.ndarray,
              fp: Optional[FixedPointConfig] = None) -> float:
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    probs = forward_fn(cfg, params, xt, fp=fp)
    if isinstance(probs, torch.Tensor):
        probs = probs.detach().cpu().numpy()
    probs = np.asarray(probs)
    if cfg.rnn.output_activation == "sigmoid":
        return binary_auc(probs[:, 0], y)
    return multiclass_mean_auc(probs, y)


def auc_scan(
    cfg: ModelConfig,
    forward_fn: Callable,
    params: Dict,
    x: np.ndarray,
    y: np.ndarray,
    integer_bits: Iterable[int] = (6, 8, 10, 12),
    fractional_bits: Iterable[int] = tuple(range(0, 17, 2)),
) -> Dict[int, List[Tuple[int, float]]]:
    """Paper Fig. 2: AUC(quantized)/AUC(float) vs fractional bits, one curve
    per integer-bit setting.  Weights are PTQ'd; activations quantized
    in-graph (the full hls4ml datapath)."""
    float_auc = model_auc(cfg, forward_fn, params, x, y, fp=None)
    out: Dict[int, List[Tuple[int, float]]] = {}
    for ib in integer_bits:
        curve = []
        for fb in fractional_bits:
            fp = FixedPointConfig(total_bits=ib + fb, integer_bits=ib)
            qparams = ptq_quantize_model(params, fp)
            auc = model_auc(cfg, forward_fn, qparams, x, y, fp=fp)
            curve.append((fb, auc / float_auc))
        out[ib] = curve
    return out
