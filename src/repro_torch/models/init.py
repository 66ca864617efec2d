"""Parameter specs and their seeded initialisation.

Every model declares a flat ``{path: ParamSpec}`` dict; parameters are drawn
from a ``torch.Generator`` on the generator's own device and then moved to
the requested device.  The taggers draw on a CPU generator (so a seed gives
the same weights on every device); an LM at full width draws on a CUDA
generator, on the card, where billions of values take well under a second.
The distributions are the JAX package's; the numbers differ, since the
generators differ (``models.decode.lm_params_from_jax`` carries the JAX
package's own values over).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | lecun | embed | rnn_ortho
    dtype: str = "float32"
    scale: float = 1.0


ParamSpecs = Dict[str, ParamSpec]
Params = Dict[str, torch.Tensor]


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # contraction dim is second-to-last by convention ([..., in, out])
    return math.prod(shape[:-1])


def init_param(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter on the generator's device, drawn from ``generator``
    (in float32, then cast to the spec's dtype)."""
    dtype = getattr(torch, spec.dtype)
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "embed":
        v = torch.randn(spec.shape, generator=generator, device=dev)
        return (v * spec.scale).to(dtype)
    if spec.init in ("normal", "lecun"):
        # truncated at +-2 standard deviations, as jax.random.truncated_normal
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        v = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        return v.to(dtype)
    if spec.init == "rnn_ortho":
        # orthogonal recurrent kernel (keras default for RNN recurrent weights)
        rows, cols = spec.shape[-2], spec.shape[-1]
        n = max(rows, cols)
        a = torch.randn(spec.shape[:-2] + (n, n), generator=generator,
                        device=dev)
        q, _ = torch.linalg.qr(a)
        return (q[..., :rows, :cols] * spec.scale).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs: ParamSpecs, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Every parameter of ``specs``, drawn in sorted path order."""
    return {path: init_param(spec, generator).to(device)
            for path, spec in sorted(specs.items())}
