"""The train step: gradient accumulation over microbatches + AdamW
update + optional int8 gradient compression.

The port of ``repro.training.train_step``.  The returned function is
``(params, opt_state, batch) -> (params, opt_state, metrics)``, eager: the
gradients come from ``torch.autograd.grad`` over fresh leaf tensors of the
parameters, a Python loop over the microbatches takes the place of
``lax.scan``, and the parameters it returns are new tensors that need no
gradient.  ``donate=True`` is the port of ``jax.jit(...,
donate_argnums=(0, 1))``: the step updates the parameters and the
optimizer state it is given in place (``adamw_update_``, the same bits)
and returns them, so a caller that keeps the step's inputs must clone
them first.  ``grad_shardings`` (path -> ``sharding.api.NamedSharding``,
``models.init.param_shardings``) pins every gradient of a DTensor
parameter to its parameter's placements (``_shard_grads``), in the
accumulation branch and the plain one, as ``repro`` pins them with
``with_sharding_constraint``: a gradient DTensor left as autograd gives it
(a replicated parameter's gradient is a pending sum over the data axes)
is reduced into the parameter's layout before the update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.model import Model
from repro_torch.training.grad_compression import compress_decompress
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            adamw_update_)


def _split_microbatches(batch: Dict, accum: int) -> list:
    """[B, ...] -> ``accum`` microbatches of [B/accum, ...], in order."""
    def r(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} % accum {accum}")
        return x.reshape(accum, b // accum, *x.shape[1:])
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def make_train_step(
    model: Model,
    train_cfg: TrainConfig,
    grad_accum: Optional[int] = None,
    accum_dtype: str = "float32",
    grad_shardings: Optional[Dict] = None,
    donate: bool = False,
) -> Callable:
    cfg = model.cfg
    accum = grad_accum if grad_accum is not None else max(cfg.grad_accum, 1)
    opt = train_cfg.optimizer
    acc_dt = getattr(torch, accum_dtype)
    update = adamw_update_ if donate else adamw_update

    def _shard_grads(g: Dict) -> Dict:
        """Pin gradients to the parameter shardings (reduce-scatters into
        the sharded layout instead of all-reduced replicas)."""
        if grad_shardings is None:
            return g
        return {k: grad_shardings[k].distribute(v)
                if k in grad_shardings and hasattr(v, "device_mesh") else v
                for k, v in g.items()}

    def grad_fn(params, mb):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss, metrics = model.loss(leaves, mb)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), dict(zip(leaves, grads))

    def train_step(params, opt_state: OptState, batch: Dict):
        if accum > 1:
            g_acc = _shard_grads({k: torch.zeros_like(p, dtype=acc_dt)
                                  for k, p in params.items()})
            loss_sum = 0.0
            ms = []
            for mb in _split_microbatches(batch, accum):
                (loss, metrics), g = grad_fn(params, mb)
                g = _shard_grads(g)
                g_acc = {k: a + g[k].to(a.dtype) for k, a in g_acc.items()}
                loss_sum = loss_sum + loss
                ms.append(metrics)
            grads = {k: g / accum for k, g in g_acc.items()}
            loss = loss_sum / accum
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0)
                       for k in ms[0]}
        else:
            (loss, metrics), grads = grad_fn(params, batch)
            grads = _shard_grads(grads)

        if train_cfg.compress_grads:
            grads = compress_decompress(grads)

        params, opt_state, opt_metrics = update(params, grads, opt_state,
                                                opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
