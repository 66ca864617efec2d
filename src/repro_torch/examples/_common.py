"""What the examples share: the paper's tagger training protocol and the
dataset of each tagger.

The port of the part of ``benchmarks/common.py`` that ``repro``'s examples
use (``train_tagger``, ``dataset_for``): 150 AdamW steps of 128 events
drawn from 1500 (seed 0, step ``i`` from ``RandomState(i)``), lr 5e-3
with 10 warm-up steps, weight decay 1e-4, through the port's train step
(``training.make_train_step``) on ``device``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.data import (flavor_tagging_dataset, quickdraw_dataset,
                              top_tagging_dataset)
from repro_torch.device import require_device
from repro_torch.models.model import build_model
from repro_torch.registry import get_config
from repro_torch.training import adamw_init, make_train_step

DATASETS = {
    "top-tagging": top_tagging_dataset,
    "flavor-tagging": flavor_tagging_dataset,
    "quickdraw": quickdraw_dataset,
}

_CACHE: Dict[Tuple, Tuple] = {}


def dataset_for(arch: str):
    for key, fn in DATASETS.items():
        if key in arch:
            return fn
    raise KeyError(arch)


def train_tagger(arch: str, steps: int = 150, n: int = 1500,
                 lr: float = 5e-3, batch: int = 128,
                 device: Union[str, torch.device] = "cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 log_every: int = 0):
    """Train and return (cfg, model, params on ``device``); cached per
    process for the port's seeded init (``params`` None: seed 0 on the
    CPU's generator).  ``log_every`` > 0 prints the loss every so many
    steps."""
    device = require_device(device, "train_tagger")
    memo = (arch, steps, n, lr, batch, str(device))
    if params is None and memo in _CACHE:
        return _CACHE[memo]
    cfg = get_config(arch)
    m = build_model(cfg)
    p = (m.init(torch.Generator().manual_seed(0), device=device)
         if params is None else {k: v.to(device) for k, v in params.items()})
    x, y = dataset_for(arch)(n, seed=0)
    opt = OptimizerConfig(lr=lr, warmup_steps=10, total_steps=steps,
                          weight_decay=1e-4)
    st = adamw_init(p, opt)
    step = make_train_step(m, TrainConfig(optimizer=opt), grad_accum=1)
    for i in range(steps):
        idx = np.random.RandomState(i).randint(0, n, batch)
        p, st, metrics = step(p, st, {
            "x": torch.from_numpy(x[idx]).to(device),
            "y": torch.from_numpy(y[idx]).to(device)})
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss={float(metrics['loss']):.4f}")
    out = (cfg, m, p)
    if params is None:
        _CACHE[memo] = out
    return out
