"""Collective bytes of a step, from a ``CommDebugMode`` trace.

The counterpart of ``repro/launch/hlo_analysis.py``.  ``repro`` parses the
post-SPMD HLO text of a compiled step; the port has no HLO: it runs the
step eagerly on DTensors, whose redistributions issue functional
collectives (``_c10d_functional.all_gather_into_tensor`` and kin).
``CollectiveRecorder`` is a ``CommDebugMode`` that also notes, for every
collective it sees, its kind, its input and output bytes (one rank's
local tensors) and its group size; ``analyze_comm`` turns that trace
into per-device wire bytes with ``hlo_analysis``'s ring cost model,
unchanged:

  all-gather      : result   x (n-1)/n
  reduce-scatter  : in_shard x (n-1)/n
  all-reduce      : 2 x operand x (n-1)/n      (RS + AG)
  all-to-all      : operand x (n-1)/n
  collective-permute (and any other kind) : operand

Every layer runs in Python, so a collective inside a loop is seen once per
execution: no trip-count scaling is needed.  ``repro``'s bf16 correction
(``wire_bytes_bf16``) is not ported: it undoes XLA's CPU backend's f32
legalization, and the port's tensors carry their real dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.distributed.tensor.debug import CommDebugMode

#: functional collective op name (what DTensor's redistributions issue)
#: -> hlo_analysis's kind
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


@dataclass
class CollectiveOp:
    kind: str
    computation: str       # the functional op's name
    result_bytes: int
    operand_bytes: int
    group_size: int
    count: int = 1

    @property
    def wire_bytes(self) -> float:
        n = max(self.group_size, 2)
        if self.kind == "all-gather":
            return self.result_bytes * (n - 1) / n
        if self.kind == "all-reduce":
            return 2.0 * self.operand_bytes * (n - 1) / n
        if self.kind == "reduce-scatter":
            return self.operand_bytes * (n - 1) / n
        if self.kind == "all-to-all":
            return self.operand_bytes * (n - 1) / n
        return float(self.operand_bytes)  # collective-permute


@dataclass
class CommAnalysis:
    collectives: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(c.wire_bytes * c.count for c in self.collectives)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0.0) + c.wire_bytes * c.count
        return out

    def op_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.count
        return out


def _group_size(args, name: str) -> int:
    """The group size of a functional collective: its ``group_size``
    argument where it has one, else the size of the group it names."""
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class CollectiveRecorder(CommDebugMode):
    """``CommDebugMode`` that also records each collective's kind, bytes
    and group size (``ops``: (op name, operand bytes, result bytes, group
    size) in issue order)."""

    def __init__(self):
        super().__init__()
        self.ops: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        name = func._schema.name.split("::")[-1]
        if name in KINDS:
            self.ops.append((name, _nbytes(args[0]), _nbytes(out),
                             _group_size(args, name)))
        return out


def analyze_comm(rec: CollectiveRecorder) -> CommAnalysis:
    """Per-device wire bytes of every collective ``rec`` saw."""
    out = CommAnalysis()
    for name, operand, result, n in rec.ops:
        out.collectives.append(CollectiveOp(
            kind=KINDS[name], computation=name, result_bytes=result,
            operand_bytes=operand, group_size=max(n, 1)))
    return out
