"""Parameter specs and their seeded initialisation.

Every model declares a flat ``{path: ParamSpec}`` dict; parameters are drawn
from a ``torch.Generator`` on the generator's own device and then moved to
the requested device.  The taggers draw on a CPU generator (so a seed gives
the same weights on every device); an LM at full width draws on a CUDA
generator, on the card, where billions of values take well under a second.
The distributions are the JAX package's; the numbers differ, since the
generators differ (``models.decode.lm_params_from_jax`` carries the JAX
package's own values over).

The same specs give the dry run's stand-ins (``abstract_params``: tensors
on the ``meta`` device, DTensors under a context on a ``DeviceMesh``), the
pspecs and placements of a sharding context (``param_pspecs``,
``param_shardings``) and the bytes (``param_bytes``), all consistent
because they come from one source.

A tensor of rank 3 or more (the LMs' stacked layer weights) is drawn slice
by slice along its leading axis, each slice in float32 and cast into the
result, at the whole tensor's standard deviation: at full width a stacked
expert weight ([48, 128, 2048, 768] in qwen3-moe-30b-a3b) drawn whole in
float32 would take 38.6 GB beside its bf16 copy (and ``trunc_normal_``
redraws whole-size tensors while it rejects).  :func:`init_params` draws
those from a second generator, seeded from the first one's seed, so that
the first generator's stream is spent on the tensors of rank 2 or less
alone (every tagger weight, the embedding), each drawn whole in sorted
path order: their values do not depend on how the stacked tensors are
drawn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | lecun | embed | rnn_ortho
    dtype: str = "float32"
    scale: float = 1.0
    # one logical axis name (or None) per dim, repro's; () = all None
    logical_axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if self.logical_axes and len(self.logical_axes) != len(self.shape):
            raise ValueError(f"spec rank mismatch: {self.shape} vs "
                             f"{self.logical_axes}")

    @property
    def axes(self) -> Tuple[Optional[str], ...]:
        """The logical axes, ``None`` for every dim where none are given."""
        return self.logical_axes or (None,) * len(self.shape)


ParamSpecs = Dict[str, ParamSpec]
Params = Dict[str, torch.Tensor]


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # contraction dim is second-to-last by convention ([..., in, out])
    return math.prod(shape[:-1])


def init_param(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter on the generator's device, drawn from ``generator``
    (in float32, then cast to the spec's dtype); rank 3 or more slice by
    slice along the leading axis (module docstring)."""
    dtype = getattr(torch, spec.dtype)
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init not in ("embed", "normal", "lecun", "rnn_ortho"):
        raise ValueError(f"unknown init {spec.init!r}")
    # the spread of the whole tensor, whichever part is drawn
    std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
    if len(spec.shape) < 3:
        return _draw(spec, spec.shape, std, generator).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=dev)
    for i in range(spec.shape[0]):
        out[i] = _draw(spec, spec.shape[1:], std, generator)
    return out


def _draw(spec: ParamSpec, shape: Tuple[int, ...], std: float,
          generator: torch.Generator) -> torch.Tensor:
    """A float32 draw of ``shape`` by ``spec.init``."""
    dev = generator.device
    if spec.init == "embed":
        v = torch.randn(shape, generator=generator, device=dev)
        return v * spec.scale
    if spec.init == "rnn_ortho":
        # orthogonal recurrent kernel (keras default for RNN recurrent weights)
        rows, cols = shape[-2], shape[-1]
        n = max(rows, cols)
        a = torch.randn(shape[:-2] + (n, n), generator=generator, device=dev)
        q, _ = torch.linalg.qr(a)
        return q[..., :rows, :cols] * spec.scale
    # normal / lecun: truncated at +-2 standard deviations, as
    # jax.random.truncated_normal
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return v


def init_params(specs: ParamSpecs, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda",
                place: Optional[Callable] = None) -> Params:
    """Every parameter of ``specs``, drawn in sorted path order: tensors of
    rank 2 or less from ``generator``, those of rank 3 or more (slice by
    slice) from a second generator on the same device seeded with
    ``generator.initial_seed() + 1``.  ``place(path, tensor)``, where
    given, maps each tensor as soon as it is drawn (the sharded trainer
    keeps its shard), so one whole tensor is held at a time."""
    stacked = torch.Generator(device=generator.device).manual_seed(
        generator.initial_seed() + 1)
    place = place or (lambda path, t: t)
    return {path: place(path, init_param(spec, stacked if len(spec.shape) >= 3
                                         else generator).to(device))
            for path, spec in sorted(specs.items())}


# ---------------------------------------------------------------------------
# Abstract parameters, pspecs, placements, bytes
# ---------------------------------------------------------------------------


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def meta_tensor(shape: Tuple[int, ...], dtype: torch.dtype, ctx=None,
                axes: Optional[Tuple[Optional[str], ...]] = None
                ) -> torch.Tensor:
    """A stand-in of ``shape`` / ``dtype`` on the ``meta`` device (no
    storage is allocated).  Under a context on a ``DeviceMesh`` it is a
    DTensor with the placements of ``axes`` and this rank's local shard;
    otherwise a plain meta tensor."""
    if ctx is None or not _is_device_mesh(ctx.mesh):
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.sharding.api import placements

    axes = axes if axes is not None else (None,) * len(shape)
    pl = placements(ctx.mesh, ctx.pspec(axes))
    local, _ = compute_local_shape_and_global_offset(shape, ctx.mesh, pl)
    full = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              ctx.mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def abstract_params(specs: ParamSpecs, ctx=None) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins of every spec, in the spec's dtype (DTensors
    carrying the placements under a context on a ``DeviceMesh``): the dry
    run's parameters."""
    return {path: meta_tensor(spec.shape, getattr(torch, spec.dtype), ctx,
                              spec.axes)
            for path, spec in specs.items()}


def param_pspecs(specs: ParamSpecs, ctx) -> Dict[str, tuple]:
    return {path: ctx.pspec(spec.axes) for path, spec in specs.items()}


def param_shardings(specs: ParamSpecs, ctx) -> Dict[str, "NamedSharding"]:
    """Per path, the ``NamedSharding`` (mesh + DTensor placements) of its
    spec under ``ctx``, whose mesh is a ``DeviceMesh``."""
    from repro_torch.sharding.api import NamedSharding

    return {path: NamedSharding.of(ctx.mesh, ctx.pspec(spec.axes))
            for path, spec in specs.items()}


def param_bytes(specs: ParamSpecs) -> int:
    return sum(math.prod(s.shape) * getattr(torch, s.dtype).itemsize
               for s in specs.values())
