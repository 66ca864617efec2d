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
trainer sends no stub either.  A mesh is ROADMAP.md module item 12.

As ``repro``'s launcher donates the step's parameters and optimizer
state to XLA, this one updates them in place (``make_train_step(...,
donate=True)``): the state is held once.

As in ``repro``, ``resume`` restores the parameters and the optimizer
state of the latest checkpoint and starts the batch stream again at its
first batch.
"""

from __future__ import annotations

import argparse
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
from repro_torch.models.model import build_model
from repro_torch.models.transformer import required_inputs
from repro_torch.registry import get_config
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


def train(arch: str, steps: int = 100, batch: int = 64, lr: float = 1e-3,
          seq_len: int = 128, mesh_shape: Optional[tuple] = None,
          checkpoint_dir: Optional[str] = None, resume: bool = False,
          tiny: bool = False, log_every: int = 10,
          device: Union[str, torch.device] = "cuda"):
    """Train ``arch`` for ``steps`` steps; returns (params, last logged
    loss), the parameters as tensors on ``device`` that need no gradient."""
    device = require_device(device, "train")
    if mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={mesh_shape}: the port has no mesh yet (ROADMAP.md "
            f"module item 12)")
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

    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                              total_steps=steps, weight_decay=0.01)
    tc = TrainConfig(optimizer=opt_cfg)
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    straggler = StragglerPolicy()

    # a tagger is drawn on a CPU generator (the same weights on every
    # device); an LM on ``device``'s own, as Model.init draws it (billions
    # of values take minutes on the CPU, under a second on the card)
    gen = torch.Generator(device="cpu" if cfg.family == "rnn" else device)
    params = model.init(gen.manual_seed(0), device=device)
    opt_state = adamw_init(params, opt_cfg)
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start, params, opt = ckpt.restore(device=device)
        if opt:
            opt_state = opt_state._replace(
                step=torch.tensor(opt["step"], dtype=torch.int32,
                                  device=device),
                m=opt["m"], v=opt["v"])
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(model, tc, grad_accum=1, donate=True)
    batches = (_rnn_batches(cfg, batch, device=device) if cfg.family == "rnn"
               else _lm_batches(cfg, batch, seq_len, device=device))

    t_last = time.time()
    loss = float("nan")
    for i in range(start, steps):
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next(batches))
        straggler.record_step(0, time.time() - t0)
        if (i + 1) % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            dt = (time.time() - t_last) / log_every
            t_last = time.time()
            print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                  f"acc={float(metrics.get('accuracy', 0)):.3f} "
                  f"{dt*1e3:.0f}ms/step", flush=True)
        if ckpt and (i + 1) % tc.checkpoint_every == 0:
            ckpt.save(i + 1, params, opt_state)
    if ckpt:
        ckpt.save(steps, params, opt_state)
    return params, loss


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
