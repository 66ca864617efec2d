"""AdamW with warmup-cosine schedule and global-norm clipping, on plain
tensors.

The port of ``repro.training.optimizer``: the schedule, the bias
corrections and the clip are float32 tensors on the parameters' device, as
jnp computes them, not Python doubles.  ``torch.optim`` is not used: this
AdamW has its own clip, schedule and no-decay rule (``_NO_DECAY`` matches
substrings of the parameter path, so a tagger's ``dense0/b`` *is*
decayed, as in ``repro``).  Updates are functional: new tensors, no
in-place writes, no autograd.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.config import OptimizerConfig


class OptState(NamedTuple):
    step: torch.Tensor                  # scalar int32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def lr_schedule(opt: OptimizerConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = opt.lr * (s + 1.0) / max(opt.warmup_steps, 1)
    total = max(opt.total_steps - opt.warmup_steps, 1)
    t = torch.clamp((s - opt.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * opt.lr * (1.0 + torch.cos(math.pi * t))
    return torch.where(s < opt.warmup_steps, warm, cos)


def adamw_init(params: Dict[str, torch.Tensor],
               opt: OptimizerConfig) -> OptState:
    dt = getattr(torch, opt.state_dtype)
    device = next(iter(params.values())).device if params else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: zeros(p) for k, p in params.items()},
        v={k: zeros(p) for k, p in params.items()},
    )


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


_NO_DECAY = ("bias", "norm", "scale", "a_log", "dt_bias", "lambda", "d_skip")


@torch.no_grad()
def adamw_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: OptState,
    opt: OptimizerConfig,
) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    step = state.step + 1
    lr = lr_schedule(opt, state.step)

    gn = global_norm(grads)
    # a tensor divided by a tensor: a Python number over a tensor would be
    # its reciprocal times the number, two roundings where jnp takes one
    clip = (torch.clamp(torch.full_like(gn, opt.grad_clip)
                        / torch.clamp(gn, min=1e-9), max=1.0)
            if opt.grad_clip > 0 else torch.ones_like(gn))

    b1, b2, eps = opt.b1, opt.b2, opt.eps
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m = state.m[k].float() * b1 + (1 - b1) * g
        v = state.v[k].float() * b2 + (1 - b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if opt.weight_decay > 0 and not any(s in k for s in _NO_DECAY):
            update = update + opt.weight_decay * p.float()
        new_p[k] = (p.float() - lr * update).to(p.dtype)
        new_m[k] = m.to(state.m[k].dtype)
        new_v[k] = v.to(state.v[k].dtype)

    metrics = {"grad_norm": gn, "lr": lr}
    return new_p, OptState(step, new_m, new_v), metrics
