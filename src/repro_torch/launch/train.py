"""Trainer entry point: ``python -m repro_torch.launch.train --arch <id>
[options]``.

The port of ``repro.launch.train``: seeded parameters + AdamW train step +
checkpoint manager + straggler hook, on ``--device`` (``cuda`` unless the
caller asks for ``cpu``).  A tagger's forward and backward run on the
reference path (``kernels/ref.py``), as ``repro`` trains on its
``lax.scan`` reference; the trained parameters are served on the kernels
by ``RNNServingEngine``.  An LM trains on ``data.lm_token_stream`` batches
of ``--seq-len`` tokens (``tokens`` and ``labels`` only, as in ``repro``)
through ``Model.loss``, the sequence forward and ``lm_loss``.  An LM whose
forward needs a frontend's embeddings (whisper's frames, phi-3-vision's
image patches) is refused with a ``ValueError`` naming them: ``repro``'s
trainer sends no stub either.

``mesh_shape`` trains sharded, as ``repro``'s trainer does on its mesh:
a ``DeviceMesh`` of that shape with axes ("data", "model")[:len] (one
axis: "data") over the running process group, ``auto_overrides`` for the
arch, every parameter distributed by ``param_shardings`` (DTensors; each
rank draws the same seeded tensors and keeps its shard of each as soon as
it is drawn, so one whole tensor is held at a time), the batch split
along the data axes, and the train step's gradients pinned to the
parameters' placements (``grad_shardings``).  With ``prod(mesh_shape) ==
1`` and no process group the trainer starts a one-rank group itself
(``tcp://localhost``, a free port; it stays up for the DTensors it
returns); otherwise it needs a group of ``prod(mesh_shape)`` ranks, as
``torchrun --nproc-per-node N`` makes, and trains on ``cuda:{LOCAL_RANK}``
(a CPU device keeps the CPU: a gloo group).  Rank 0 alone prints and
writes checkpoints (every rank gathers the full tensors first).

As ``repro``'s launcher donates the step's parameters and optimizer
state to XLA, this one updates them in place (``make_train_step(...,
donate=True)``): the state is held once.

As in ``repro``, ``resume`` restores the parameters and the optimizer
state of the latest checkpoint and starts the batch stream again at its
first batch.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.data import (flavor_tagging_dataset, lm_token_stream,
                              quickdraw_dataset, top_tagging_dataset)
from repro_torch.device import require_device
from repro_torch.ft import StragglerPolicy
from repro_torch.models.init import param_shardings
from repro_torch.models.model import build_model
from repro_torch.models.transformer import required_inputs
from repro_torch.registry import get_config
from repro_torch.sharding.api import NamedSharding, sharding_context
from repro_torch.sharding.auto import auto_overrides
from repro_torch.testing import tiny_config
from repro_torch.training import adamw_init, make_train_step

RNN_DATA = {
    "top-tagging": top_tagging_dataset,
    "flavor-tagging": flavor_tagging_dataset,
    "quickdraw": quickdraw_dataset,
}


def _rnn_batches(cfg, batch, seed=0, device="cuda"):
    for key, fn in RNN_DATA.items():
        if key in cfg.name:
            x, y = fn(4096, seed=seed)
            step = 0
            while True:
                idx = np.random.RandomState(step).randint(0, len(x), batch)
                yield {"x": torch.from_numpy(x[idx]).to(device),
                       "y": torch.from_numpy(y[idx]).to(device)}
                step += 1
    raise KeyError(cfg.name)


def _lm_batches(cfg, batch, seq_len, device="cuda"):
    for b in lm_token_stream(cfg.vocab_size, batch, seq_len):
        yield {k: torch.from_numpy(b[k]).to(device)
               for k in ("tokens", "labels")}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _train_mesh(mesh_shape: tuple, device: torch.device):
    """(mesh, device) for ``mesh_shape``: the running group's, or a
    one-rank group of our own where the mesh has one device."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    n = math.prod(mesh_shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"train(mesh_shape={tuple(mesh_shape)}): needs a process "
                f"group of {n} ranks (torchrun --nproc-per-node {n})")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    axes = ("data", "model")[:len(mesh_shape)] if len(mesh_shape) > 1 \
        else ("data",)
    return make_mesh(mesh_shape, axes, device_type=device.type), device


def _gathered(tree: dict) -> dict:
    """Full tensors of a dict of DTensors (a collective: every rank)."""
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in tree.items()}


def train(arch: str, steps: int = 100, batch: int = 64, lr: float = 1e-3,
          seq_len: int = 128, mesh_shape: Optional[tuple] = None,
          checkpoint_dir: Optional[str] = None, resume: bool = False,
          tiny: bool = False, log_every: int = 10,
          device: Union[str, torch.device] = "cuda"):
    """Train ``arch`` for ``steps`` steps; returns (params, last logged
    loss), the parameters as tensors on ``device`` that need no gradient
    (DTensors with ``mesh_shape``)."""
    device = require_device(device, "train")
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_config(cfg)
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if required_inputs(cfg):
        raise ValueError(
            f"train({arch!r}): its forward needs {list(required_inputs(cfg))} "
            f"beside the tokens, and the LM batch stream has tokens and "
            f"labels only (as repro's trainer)")
    model = build_model(cfg)

    mesh = None
    if mesh_shape:
        mesh, device = _train_mesh(tuple(mesh_shape), torch.device(device))
    rank0 = mesh is None or mesh.get_rank() == 0

    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                              total_steps=steps, weight_decay=0.01)
    tc = TrainConfig(optimizer=opt_cfg)
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    straggler = StragglerPolicy()

    ov = auto_overrides(cfg, mesh) if mesh is not None else None
    with sharding_context(mesh, cfg.family, "train", ov) as ctx:
        # a tagger is drawn on a CPU generator (the same weights on every
        # device); an LM on ``device``'s own, as Model.init draws it
        # (billions of values take minutes on the CPU, under a second on
        # the card)
        gen = torch.Generator(device="cpu" if cfg.family == "rnn"
                              else device)
        shardings = (param_shardings(model.param_specs(), ctx)
                     if ctx is not None else None)
        gen.manual_seed(0)
        if shardings is None:
            params = model.init(gen, device=device)
        else:   # each tensor keeps its shard as soon as it is drawn
            params = model.init(gen, device=device, place=lambda k, v:
                                shardings[k].distribute(v))
        opt_state = adamw_init(params, opt_cfg)
        start = 0
        if ckpt and resume and ckpt.latest_step() is not None:
            start, params, opt = ckpt.restore(device=device,
                                              shardings=shardings)
            if opt:
                opt_state = opt_state._replace(
                    step=torch.tensor(opt["step"], dtype=torch.int32,
                                      device=device),
                    m=opt["m"], v=opt["v"])
            if rank0:
                print(f"[train] resumed from step {start}")

        step_fn = make_train_step(model, tc, grad_accum=1, donate=True,
                                  grad_shardings=shardings)
        batches = (_rnn_batches(cfg, batch, device=device)
                   if cfg.family == "rnn"
                   else _lm_batches(cfg, batch, seq_len, device=device))

        def save(step):
            if ctx is None:
                ckpt.save(step, params, opt_state)
                return
            full = (_gathered(params), opt_state._replace(
                m=_gathered(opt_state.m), v=_gathered(opt_state.v)))
            if rank0:
                ckpt.save(step, *full)

        t_last = time.time()
        loss = float("nan")
        for i in range(start, steps):
            t0 = time.time()
            b = next(batches)
            if ctx is not None:
                b = {k: NamedSharding.of(mesh, ctx.pspec(
                    ("batch",) + (None,) * (v.ndim - 1))).distribute(v)
                    for k, v in b.items()}
            with _replicated(ctx):
                params, opt_state, metrics = step_fn(params, opt_state, b)
            straggler.record_step(0, time.time() - t0)
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = _gathered(metrics)
                loss = float(m["loss"])
                dt = (time.time() - t_last) / log_every
                t_last = time.time()
                if rank0:
                    print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                          f"acc={float(m.get('accuracy', 0)):.3f} "
                          f"{dt*1e3:.0f}ms/step", flush=True)
            if ckpt and (i + 1) % tc.checkpoint_every == 0:
                save(i + 1)
        if ckpt:
            save(steps)
    return params, loss


def _replicated(ctx):
    """``implicit_replication`` under a sharding context (a plain tensor the
    step makes counts as replicated), else nothing."""
    import contextlib

    if ctx is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (testing.tiny_config; the taggers "
                    "are already small)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    train(args.arch, args.steps, args.batch, args.lr, args.seq_len,
          checkpoint_dir=args.checkpoint_dir, resume=args.resume,
          tiny=args.tiny, device=args.device)


if __name__ == "__main__":
    main()
