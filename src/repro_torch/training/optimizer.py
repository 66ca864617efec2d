"""AdamW with warmup-cosine schedule and global-norm clipping, on plain
tensors.

The port of ``repro.training.optimizer``: the schedule, the bias
corrections and the clip are float32 tensors on the parameters' device, as
jnp computes them, not Python doubles.  ``torch.optim`` is not used: this
AdamW has its own clip, schedule and no-decay rule (``_NO_DECAY`` matches
substrings of the parameter path, so a tagger's ``dense0/b`` *is*
decayed, as in ``repro``).  ``adamw_update`` is functional: new tensors,
no in-place writes, no autograd.  ``adamw_update_`` is its in-place
counterpart, the port of the buffer donation of ``repro``'s launcher
(``jax.jit(..., donate_argnums=(0, 1))``): the same ops in the same order,
each key's results copied into the parameter and moment tensors it was
given, so the state is held once, not twice.
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
    # zeros_like keeps a DTensor parameter's placements in its moments
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
    )


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


_NO_DECAY = ("bias", "norm", "scale", "a_log", "dt_bias", "lambda", "d_skip")


def _step_scalars(grads: Dict[str, torch.Tensor], state: OptState,
                  opt: OptimizerConfig):
    """The step's new counter, learning rate, gradient norm, clip factor
    and bias corrections, as float32 tensors."""
    step = state.step + 1
    lr = lr_schedule(opt, state.step)
    gn = global_norm(grads)
    # a tensor divided by a tensor: a Python number over a tensor would be
    # its reciprocal times the number, two roundings where jnp takes one
    clip = (torch.clamp(torch.full_like(gn, opt.grad_clip)
                        / torch.clamp(gn, min=1e-9), max=1.0)
            if opt.grad_clip > 0 else torch.ones_like(gn))
    bc1 = 1.0 - opt.b1 ** step.to(torch.float32)
    bc2 = 1.0 - opt.b2 ** step.to(torch.float32)
    return step, lr, gn, clip, bc1, bc2


def _update_one(k: str, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, opt: OptimizerConfig, lr, clip, bc1, bc2
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One key's new parameter, m and v in float32 (not yet cast)."""
    b1, b2 = opt.b1, opt.b2
    g = g.float() * clip
    m = m.float() * b1 + (1 - b1) * g
    v = v.float() * b2 + (1 - b2) * torch.square(g)
    update = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
    if opt.weight_decay > 0 and not any(s in k for s in _NO_DECAY):
        update = update + opt.weight_decay * p.float()
    return p.float() - lr * update, m, v


@torch.no_grad()
def adamw_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: OptState,
    opt: OptimizerConfig,
) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    step, lr, gn, clip, bc1, bc2 = _step_scalars(grads, state, opt)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        p1, m, v = _update_one(k, p, grads[k], state.m[k], state.v[k], opt,
                               lr, clip, bc1, bc2)
        new_p[k] = p1.to(p.dtype)
        new_m[k] = m.to(state.m[k].dtype)
        new_v[k] = v.to(state.v[k].dtype)

    metrics = {"grad_norm": gn, "lr": lr}
    return new_p, OptState(step, new_m, new_v), metrics


@torch.no_grad()
def adamw_update_(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: OptState,
    opt: OptimizerConfig,
) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    """``adamw_update`` in place: the same bits, written into ``params[k]``,
    ``state.m[k]`` and ``state.v[k]``; returns those very tensors (and a
    new step counter).  One key at a time, every result computed before
    its first ``copy_`` (an f32 ``p.float()`` is ``p`` itself) and its
    temporaries dropped before the next key, so the peak is the state plus
    one key's float32 temporaries.  Two keys that share memory (a tied
    weight) are refused: the functional update gives them two new
    tensors, which an update in place cannot."""
    seen: Dict[int, str] = {}
    for k, p in params.items():
        for what, t in (("", p), ("m of ", state.m[k]), ("v of ", state.v[k])):
            t = getattr(t, "_local_tensor", t)       # a DTensor's shard
            if t.numel() == 0 or t.device.type == "meta":
                continue                         # no memory to share
            other = seen.setdefault(t.data_ptr(), what + k)
            if other != what + k:
                raise ValueError(
                    f"adamw_update_: {what + k!r} shares memory with "
                    f"{other!r}; an update in place needs a tensor of its "
                    f"own for every parameter and moment (use adamw_update)")
    step, lr, gn, clip, bc1, bc2 = _step_scalars(grads, state, opt)
    for k, p in params.items():
        p1, m, v = _update_one(k, p, grads[k], state.m[k], state.v[k], opt,
                               lr, clip, bc1, bc2)
        p.copy_(p1)
        state.m[k].copy_(m)
        state.v[k].copy_(v)
        del p1, m, v

    metrics = {"grad_norm": gn, "lr": lr}
    return params, OptState(step, state.m, state.v), metrics
