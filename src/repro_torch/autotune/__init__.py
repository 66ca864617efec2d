"""Auto-scheduler: Pareto design-space exploration over KernelSchedule.

``explore(cfg, target)`` prices the legal schedule space and reduces it to
a Pareto frontier; ``select(cfg, target)`` returns the single point a
serving engine should run — the paper's hand-enumerated latency/resource
tables, turned into a solver.  The port's copy of the JAX package's
``autotune``; ``measure_points`` (and ``select(..., measure_top_k > 0)``)
time the port's kernels on the card.
"""

from repro_torch.autotune.explorer import (  # noqa: F401
    Exploration,
    InfeasibleTargetError,
    SpeculativePoint,
    degradation_ladder,
    explore,
    explore_decode,
    explore_speculative,
    is_feasible,
    measure_points,
    pareto,
    select,
    select_decode,
    select_speculative,
    suggest_replicas,
    violation,
)
from repro_torch.autotune.space import (  # noqa: F401
    SpaceSpec,
    decode_legal,
    divisors,
    enumerate_decode_space,
    enumerate_space,
    enumerate_speculative_space,
    lm_decode_schedules,
    speculative_draft_legal,
)
from repro_torch.autotune.target import OBJECTIVES, DesignTarget  # noqa: F401
