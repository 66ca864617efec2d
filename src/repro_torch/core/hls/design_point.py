"""Unified priced design point — ONE record shared by the kernel-level
estimator (resources.py), the table-calibrated FPGA model (design.py), and
the autotune explorer.

The port's copy of the JAX package's ``core/hls/design_point.py``;
``DesignPoint.key`` is the port's ``schedule_key``, byte-identical to that
package's.  ``price_point`` produces a single frozen
:class:`DesignPoint` that carries the schedule, the fixed-point config, the
kernel-level :class:`ScheduleEstimate` AND the table-calibrated
:class:`HLSDesign` — all derived from the SAME schedule object the kernels
execute, with the reuse axes resolved exactly once (``resolved_axes``).

The explorer's Pareto dominance is defined here so that "no returned point
is dominated" means the same thing everywhere: the paper's trade space is
(latency, DSP, BRAM) — Fig. 1's curve plus the Fig. 6 resource axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.core.hls.design import HLSDesign, estimate_design_for_schedule
from repro_torch.core.hls.resources import (ScheduleEstimate,
                                            estimate_decode_step,
                                            estimate_schedule)
from repro_torch.kernels.schedule import KernelSchedule, schedule_key

#: the Pareto axes — the paper's latency/resource trade space
PARETO_AXES = ("latency_cycles", "dsp", "bram_18k")


@dataclass(frozen=True)
class DesignPoint:
    """One fully priced (schedule, fixed-point) point of the design space.

    ``estimate`` is the kernel-level price (the structure the scan kernels
    execute: sequential steps, live weight tile); ``design`` is the
    table-calibrated FPGA price (Vivado-shaped FF/LUT, part fit).  Both are
    derived from ``schedule`` — never from parallel hand-kept knobs.
    """

    schedule: KernelSchedule
    fp: Optional[FixedPointConfig]
    estimate: ScheduleEstimate
    design: HLSDesign
    clock_mhz: float = 200.0

    # -- identity -----------------------------------------------------------

    @property
    def key(self) -> str:
        """The serving layer's co-batching key: the queue an auto-picked
        point lands on is exactly this string."""
        return schedule_key(self.schedule, self.fp)

    # -- the Pareto axes ----------------------------------------------------

    @property
    def latency_cycles(self) -> int:
        return self.estimate.latency_cycles

    @property
    def dsp(self) -> int:
        return self.estimate.dsp

    @property
    def bram_18k(self) -> int:
        return self.estimate.bram_18k

    @property
    def ii_cycles(self) -> int:
        return self.estimate.ii_cycles

    def latency_us(self, clock_mhz: Optional[float] = None) -> float:
        return self.estimate.latency_us(clock_mhz or self.clock_mhz)

    def throughput_eps(self, clock_mhz: Optional[float] = None) -> float:
        return self.estimate.throughput_eps(clock_mhz or self.clock_mhz)

    # -- dominance ----------------------------------------------------------

    def dominates(self, other: "DesignPoint") -> bool:
        """Weakly better on every Pareto axis, strictly better on one."""
        mine = (self.latency_cycles, self.dsp, self.bram_18k)
        theirs = (other.latency_cycles, other.dsp, other.bram_18k)
        return (all(a <= b for a, b in zip(mine, theirs))
                and any(a < b for a, b in zip(mine, theirs)))

    # -- reporting ----------------------------------------------------------

    def report_row(self) -> dict:
        row = self.estimate.report_row(self.clock_mhz)
        row.update(key=self.key,
                   fits=self.design.fits,
                   part=self.design.part,
                   design_latency_us=self.design.latency_min_us,
                   design_dsp=self.design.dsp)
        return row


def price_point(cfg: ModelConfig, schedule: KernelSchedule,
                fp: Optional[FixedPointConfig] = None, *,
                clock_mhz: float = 200.0,
                part: str = "xcku115") -> DesignPoint:
    """Price one (schedule, fp) point through BOTH models at once."""
    assert cfg.rnn is not None, "design points apply to the RNN tagger family"
    return DesignPoint(
        schedule=schedule,
        fp=fp,
        estimate=estimate_schedule(schedule, cfg.rnn, fp),
        design=estimate_design_for_schedule(cfg, schedule, fp, part=part,
                                            clock_mhz=clock_mhz),
        clock_mhz=clock_mhz)


def price_decode_point(cfg: ModelConfig, schedule: KernelSchedule,
                       fp: Optional[FixedPointConfig] = None, *,
                       clock_mhz: float = 200.0,
                       part: str = "xcku115") -> DesignPoint:
    """Price one decode-legal point for the SINGLE-STEP path.

    ``estimate`` is :func:`~repro_torch.core.hls.resources.estimate_decode_step`
    — one state update, II ~ R, full weight resident — the structure the
    ``kernels/decode_step.py`` kernel executes.  ``design`` keeps the
    table-calibrated full-model fit (the Vivado tables are calibrated on
    whole-sequence designs; a part that fits the scan fits its single-step
    engine), so part-fit feasibility stays meaningful while the Pareto
    axes price the decode step itself.
    """
    assert cfg.rnn is not None, "design points apply to the RNN tagger family"
    return DesignPoint(
        schedule=schedule,
        fp=fp,
        estimate=estimate_decode_step(schedule, cfg.rnn, fp),
        design=estimate_design_for_schedule(cfg, schedule, fp, part=part,
                                            clock_mhz=clock_mhz),
        clock_mhz=clock_mhz)
