"""Sharding context: thread (mesh, rules, data axes) through model code.

The port of ``repro/sharding/api.py``.  Model code calls ``constrain(x,
'batch', 'seq', 'embed_act')``.  With no active context (unit tests,
single-device runs) it is the identity, so the model zoo runs unmodified
on one device; under a context it redistributes a ``DTensor`` to the
placements its logical axes resolve to, as ``repro`` pins a sharding with
``with_sharding_constraint``.

A pspec is a plain tuple, one entry per tensor dim: ``None``
(unsharded), a mesh axis name, or a tuple of mesh axis names (the dim is
split over all of them, the first outermost), as a JAX ``PartitionSpec``.
``placements`` maps it onto DTensor placements.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
with ``axis_names`` and a ``shape`` mapping (axis name -> size), as
``repro``'s tests' ``FakeMesh``; ``mesh_view`` gives either the second
form.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding.rules import MeshAxes, rules_for

_STATE = threading.local()

PSpec = Tuple[MeshAxes, ...]


def mesh_view(mesh: Any) -> Any:
    """``mesh`` as an object with ``axis_names`` (tuple) and ``shape``
    (dict axis -> size): a ``DeviceMesh`` is adapted from its
    ``mesh_dim_names`` and ``mesh.shape``, anything else is taken as it
    is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, mesh.mesh.shape)))


@dataclass
class ShardingContext:
    mesh: Any
    rules: Dict[str, MeshAxes]
    data_axes: Tuple[str, ...] = ("data",)
    overrides: Dict[str, MeshAxes] = field(default_factory=dict)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """Mesh axis name -> size."""
        return dict(mesh_view(self.mesh).shape)

    def resolve(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical in self.overrides:
            axis = self.overrides[logical]
        elif logical in self.rules:
            axis = self.rules[logical]
        else:
            raise KeyError(f"unknown logical axis {logical!r}")
        if axis == "__data__":
            return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
        return axis

    def pspec(self, logical_axes: Tuple[Optional[str], ...]) -> PSpec:
        used = set()
        out = []
        for name in logical_axes:
            axis = self.resolve(name)
            # a mesh axis may appear at most once in a pspec; on conflict
            # the later dim is left unsharded (repro's documented behaviour)
            flat = axis if isinstance(axis, tuple) else (axis,) if axis else ()
            if any(a in used for a in flat):
                out.append(None)
                continue
            used.update(flat)
            out.append(axis)
        return tuple(out)


#: the aten ops (``torch.ops.aten.<name>``) that the model zoo's steps send
#: through DTensor: the train step with its backward, prefill and decode of
#: every family (collected from the dry run's cells)
DTENSOR_OPS = (
    "_softmax.default", "_softmax_backward_data.default", "_to_copy.default",
    "_unsafe_view.default", "add.Scalar", "add.Tensor", "alias.default",
    "amax.default", "argmax.default", "bitwise_and.Tensor",
    "bitwise_not.default", "bmm.default", "cat.default", "clamp.default",
    "clone.default", "copy_.default", "cos.default", "cumsum.default",
    "detach.default", "div.Scalar", "div.Tensor", "empty_like.default",
    "eq.Tensor", "exp.default", "expand.default", "fill_.Scalar",
    "flip.default", "full_like.default", "gather.default", "ge.Scalar",
    "gelu.default", "gelu_backward.default", "gt.Scalar", "gt.Tensor",
    "index.Tensor", "index_put.default", "le.Tensor", "log.default",
    "logsumexp.default", "lt.Tensor", "masked_fill_.Scalar",
    "maximum.default", "mean.default", "mean.dim", "mul.Scalar",
    "mul.Tensor", "neg.default", "new_zeros.default", "ones_like.default",
    "permute.default", "pow.Tensor_Scalar", "reciprocal.default",
    "relu.default", "remainder.Scalar", "rsqrt.default", "rsub.Scalar",
    "scatter.src", "scatter.value", "select.int", "select_backward.default",
    "sigmoid.default", "sigmoid_backward.default", "silu.default",
    "sin.default", "slice.Tensor", "slice_backward.default",
    "softplus.default", "softplus_backward.default", "sort.stable",
    "split.Tensor", "split_with_sizes.default", "sqrt.default",
    "squeeze.dim", "stack.default", "sub.Tensor", "sub_.Tensor",
    "sum.default", "sum.dim_IntList", "tanh.default",
    "tanh_backward.default", "threshold_backward.default", "transpose.int",
    "unbind.int", "unsqueeze.default", "var.correction", "view.default",
    "where.self", "zeros_like.default",
)

_ENSURED: list = []


def ensure_strategies() -> tuple:
    """Give each op of ``DTENSOR_OPS`` that this torch's DTensor has no
    sharding strategy for a replicate-everything one (its DTensor inputs
    gathered, its outputs replicated), through
    ``torch.distributed.tensor.experimental.register_sharding``: a torch
    older than the one the port is tested with (2.11 has no strategy for
    ``flip``, which ``cumsum``'s backward calls) then runs the same steps
    with more collectives.  An op that a newer DTensor traces through its
    decomposition instead (2.13: ``softplus_backward``) takes the fallback
    too: such a trace can fail (it does for ``flip`` without its
    strategy).  Once a process; returns the ops given one."""
    if _ENSURED:
        return _ENSURED[0]
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding

    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    known = (prop.op_strategy_funcs, prop.op_to_rules,
             getattr(prop, "op_single_dim_strategy_funcs", {}),
             getattr(disp, "_custom_op_handlers", {}))
    added = []
    for name in DTENSOR_OPS:
        op, overload = name.split(".")
        ov = getattr(getattr(torch.ops.aten, op), overload)
        if any(ov in k for k in known):
            continue
        n_out = len(ov._schema.returns)

        def replicate(*args, n_out=n_out, **kwargs):
            return [([Replicate()] * n_out,
                     [Replicate() if isinstance(a, DTensorSpec) else None
                      for a in args])]

        register_sharding(ov)(replicate)
        added.append(name)
    _ENSURED.append(tuple(added))
    return _ENSURED[0]


def current_context() -> Optional[ShardingContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_context(
    mesh: Any,
    family: str = "dense",
    kind: str = "train",
    overrides: Optional[Dict[str, MeshAxes]] = None,
):
    """Activate sharding for model code. mesh=None -> no-op context."""
    if mesh is None:
        yield None
        return
    axis_names = mesh_view(mesh).axis_names
    if getattr(mesh, "mesh_dim_names", None) is not None:
        ensure_strategies()            # a DeviceMesh: DTensors will flow
    data_axes = tuple(a for a in axis_names if a in ("pod", "data"))
    ctx = ShardingContext(
        mesh=mesh,
        rules=dict(rules_for(family, kind)),
        data_axes=data_axes or (axis_names[0],),
        overrides=dict(overrides or {}),
    )
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def logical_to_pspec(logical_axes: Tuple[Optional[str], ...]) -> Optional[PSpec]:
    ctx = current_context()
    if ctx is None:
        return None
    return ctx.pspec(logical_axes)


def placements(mesh: Any, pspec: PSpec) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh`` (a ``DeviceMesh``): one
    per mesh dim, ``Shard(d)`` where tensor dim d is split over that mesh
    axis, else ``Replicate()``.  A dim split over several axes
    (``("pod", "data")``) shards on each of them, the first outermost, as
    a JAX ``PartitionSpec`` lays it out.  A mesh axis of size 1 splits
    nothing and stays ``Replicate()`` (the same layout; DTensor refuses
    some views of a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.mesh.shape)
    out = [Replicate()] * len(names)
    for d, axis in enumerate(pspec):
        for a in (axis if isinstance(axis, tuple) else (axis,) if axis else ()):
            i = names.index(a)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of one tensor on it: the port of
    ``jax.sharding.NamedSharding``."""

    mesh: Any
    placements: tuple

    @classmethod
    def of(cls, mesh: Any, pspec: PSpec) -> "NamedSharding":
        return cls(mesh, placements(mesh, pspec))

    def distribute(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (the whole tensor, the same on every rank) as a DTensor
        with these placements: each rank keeps its own shard, nothing is
        sent (a DTensor is redistributed instead)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements (the identity
    without a context or on a plain tensor)."""
    ctx = current_context()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: {len(logical_axes)} axes for rank-{x.ndim} array"
        )
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, ctx.pspec(tuple(logical_axes)))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
