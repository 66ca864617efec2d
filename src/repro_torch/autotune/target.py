"""Design targets — WHAT the user wants, stated in paper units.

The paper's tables are hand-enumerated sweeps over reuse factor and
static/non-static mode, read backwards by a designer holding a latency
budget ("the L1 trigger gives you ~1 µs") or a resource budget ("this
algorithm gets 30% of the SLR's DSPs").  :class:`DesignTarget` states that
budget directly; the explorer (``autotune.explorer``) turns it into a
:class:`~repro_torch.core.hls.DesignPoint`, i.e. into the
``KernelSchedule`` the serving engine then executes.  The port's copy of
the JAX package's ``autotune/target.py``.

Frozen/hashable so engines can memoize target -> schedule resolution and
use targets as queue-policy keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config import FixedPointConfig

OBJECTIVES = ("latency", "resources", "throughput")


@dataclass(frozen=True)
class DesignTarget:
    """Constraints + objective for the design-space search.

    max_latency_us      end-to-end inference latency budget at ``clock_mhz``
                        (the trigger budget; None = unconstrained)
    min_throughput_eps  initiation-interval-derived events/s floor (the
                        coprocessor budget; None = unconstrained)
    max_dsp             parallel-multiplier (DSP) budget, kernel-level units
    max_bram_18k        weight-storage budget, 18 kb BRAM blocks
    fp                  fixed-point constraint: price AND serve with this
                        ap_fixed config (None = float datapath)
    part                when set, the table-calibrated design must fit this
                        FPGA part (``core.hls.FPGA_PARTS`` key)
    replicas            data-parallel replica count the throughput floor is
                        read against: K replicas of one design sustain K x
                        its priced events/s (``serving.ReplicaPool``
                        and ``serving.Router``),
                        so ``min_throughput_eps`` resolves to the design
                        whose throughput x replicas clears the floor
    clock_mhz           clock the latency/throughput constraints are read at
    objective           what to minimize among feasible points:
                        "latency"    latency_cycles, then DSP, then BRAM
                        "resources"  DSP, then BRAM, then latency
                        "throughput" II (max events/s), then latency, DSP
    """

    max_latency_us: Optional[float] = None
    min_throughput_eps: Optional[float] = None
    max_dsp: Optional[int] = None
    max_bram_18k: Optional[int] = None
    fp: Optional[FixedPointConfig] = None
    part: Optional[str] = None
    replicas: int = 1
    clock_mhz: float = 200.0
    objective: str = "latency"

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective {self.objective!r} not in {OBJECTIVES}")
        if self.clock_mhz <= 0:
            raise ValueError(f"clock_mhz must be > 0: {self.clock_mhz}")
        if not isinstance(self.replicas, int) or self.replicas < 1:
            raise ValueError(f"replicas must be an int >= 1: "
                             f"{self.replicas!r}")
        for name in ("max_latency_us", "min_throughput_eps", "max_dsp",
                     "max_bram_18k"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 when set: {v}")

    def describe(self) -> str:
        """Human-readable constraint list for reports and error messages."""
        parts = []
        if self.max_latency_us is not None:
            parts.append(f"latency <= {self.max_latency_us:g}us"
                         f"@{self.clock_mhz:g}MHz")
        if self.min_throughput_eps is not None:
            rep = f" over {self.replicas} replicas" if self.replicas > 1 \
                else ""
            parts.append(f"throughput >= {self.min_throughput_eps:g}ev/s"
                         f"{rep}")
        if self.max_dsp is not None:
            parts.append(f"dsp <= {self.max_dsp}")
        if self.max_bram_18k is not None:
            parts.append(f"bram <= {self.max_bram_18k}")
        if self.fp is not None:
            parts.append(f"ap_fixed<{self.fp.total_bits},"
                         f"{self.fp.integer_bits}>")
        if self.part is not None:
            parts.append(f"fits {self.part}")
        cons = ", ".join(parts) if parts else "unconstrained"
        goal = ("maximize throughput" if self.objective == "throughput"
                else f"minimize {self.objective}")
        return f"[{cons}; {goal}]"
