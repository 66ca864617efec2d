"""Elastic restart planning: after losing nodes, pick the largest valid mesh
from the survivors, re-derive shardings, and resume from the last checkpoint.

The checkpoint format is mesh-agnostic (full arrays + manifest), so the only
work is choosing the new mesh shape and rebuilding shardings — which
``plan_elastic_restart`` does deterministically so every surviving worker
computes the SAME plan without coordination.  The port's copy of
``repro.ft.elastic``: like ``repro``'s, the module holds the plan only;
``launch.mesh.make_mesh`` builds the planned mesh and
``CheckpointManager.restore(shardings=)`` reshards onto it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dropped_chips: int
    global_batch_scale: float      # rescale batch to keep per-chip batch const


# preference order: keep the model axis intact (resharding TP weights is the
# expensive direction), shrink data parallelism first, then drop pods.
_CANDIDATE_MESHES: List[Tuple[Tuple[int, ...], Tuple[str, ...]]] = [
    ((2, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((8, 16), ("data", "model")),
    ((4, 16), ("data", "model")),
    ((2, 16), ("data", "model")),
    ((1, 16), ("data", "model")),
    ((8, 8), ("data", "model")),
    ((4, 8), ("data", "model")),
    ((4, 4), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((2, 2), ("data", "model")),
    ((1, 2), ("data", "model")),
    ((1, 1), ("data", "model")),
]


def plan_elastic_restart(healthy_chips: int,
                         original_chips: int = 512) -> Optional[ElasticPlan]:
    """Largest candidate mesh that fits the surviving chip count."""
    for shape, axes in _CANDIDATE_MESHES:
        n = 1
        for s in shape:
            n *= s
        if n <= healthy_chips:
            dp_old = original_chips // 16 if original_chips >= 16 else 1
            dp_new = n // shape[-1]
            return ElasticPlan(
                mesh_shape=shape, mesh_axes=axes,
                dropped_chips=original_chips - n,
                global_batch_scale=dp_new / max(dp_old, 1))
    return None
