"""Pareto design-space explorer over KernelSchedule — the component that
*chooses* a point on the paper's latency/resource curve.

The paper's tables are hand-enumerated sweeps; this module closes the loop:

  1. ``enumerate_space`` yields every legal schedule (space.py);
  2. every point is priced analytically through the unified
     ``core.hls.price_point`` bridge — the SAME object the kernels execute;
  3. the space reduces to a Pareto frontier over (latency_cycles, dsp,
     bram_18k) — no returned point is dominated by any legal point;
  4. a :class:`~repro_torch.autotune.target.DesignTarget` filters the
     space to the feasible region and ``select`` picks the
     objective-optimal point — optionally re-ranked by the measured
     wall-clock of the top-k candidates' scans on the card
     (``measure_points``).

An infeasible target raises :class:`InfeasibleTargetError` naming the
nearest-to-feasible point (smallest summed relative constraint violation), so
the error message tells the designer exactly how far their budget is from
the achievable curve.

The port's copy of the JAX package's ``autotune/explorer.py``: the same
pricing, frontiers, selections and errors; ``measure_points`` times the
port's kernels on ``device`` ("cuda" unless the caller asks for "cpu").
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.autotune.space import (SpaceSpec, enumerate_decode_space,
                                        enumerate_space,
                                        enumerate_speculative_space,
                                        native_int_legal)
from repro_torch.autotune.target import DesignTarget
from repro_torch.config import ModelConfig
from repro_torch.core.hls.design_point import (DesignPoint,
                                               price_decode_point,
                                               price_point)
from repro_torch.core.hls.resources import (estimate_decode_step,
                                            estimate_lm_decode,
                                            estimate_speculative, gate_count)
from repro_torch.core.quant.fixed_point import is_native_int
from repro_torch.device import require_device
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Feasibility
# ---------------------------------------------------------------------------


def violation(point: DesignPoint, target: DesignTarget) -> float:
    """Summed relative constraint violation; 0.0 iff feasible.

    Each violated constraint contributes its fractional excess (e.g. a point
    at 12 µs against a 10 µs budget adds 0.2), so "nearest to feasible" is
    scale-free across latency/DSP/BRAM/throughput axes.
    """
    v = 0.0
    c = target.clock_mhz
    if target.max_latency_us is not None:
        v += max(0.0, point.latency_us(c) / target.max_latency_us - 1.0)
    if target.min_throughput_eps is not None:
        # the throughput floor is read against the target's data-parallel
        # replica count: K replicas of one design sustain K x its events/s
        v += max(0.0,
                 target.min_throughput_eps
                 / (point.throughput_eps(c) * target.replicas) - 1.0)
    if target.max_dsp is not None:
        v += max(0.0, point.dsp / target.max_dsp - 1.0)
    if target.max_bram_18k is not None:
        v += max(0.0, point.bram_18k / target.max_bram_18k - 1.0)
    if target.part is not None and not point.design.fits:
        v += 1.0
    return v


def is_feasible(point: DesignPoint, target: DesignTarget) -> bool:
    return violation(point, target) == 0.0


def suggest_replicas(points: Sequence[DesignPoint], target: DesignTarget
                     ) -> Optional[Tuple[int, DesignPoint]]:
    """Smallest data-parallel replica count that would clear the target's
    throughput floor, and the point to replicate.

    Only an aggregate-throughput shortfall is fixable by replication:
    among points feasible on every NON-throughput constraint, take the
    highest-throughput one and size the pool as
    ``ceil(min_throughput_eps / point_eps)``.  None when no throughput
    floor is set, when no point clears the other constraints (replication
    cannot fix a latency or resource bust), or when the suggestion would
    not exceed the replicas the target already has."""
    if target.min_throughput_eps is None or not points:
        return None
    relaxed = dataclasses.replace(target, min_throughput_eps=None)
    ok = [p for p in points if is_feasible(p, relaxed)]
    if not ok:
        return None
    c = target.clock_mhz
    best = max(ok, key=lambda p: (p.throughput_eps(c), -p.dsp, p.key))
    k = max(1, math.ceil(target.min_throughput_eps / best.throughput_eps(c)
                         - 1e-9))
    if k <= target.replicas:
        return None
    return k, best


class InfeasibleTargetError(ValueError):
    """No enumerated schedule meets the target; carries the nearest point
    and, when the shortfall is pure throughput, the smallest replica count
    that would clear it (``suggested_replicas`` / ``suggested_point``)."""

    def __init__(self, target: DesignTarget, nearest: DesignPoint,
                 n_points: int,
                 replica_hint: Optional[Tuple[int, DesignPoint]] = None):
        self.target = target
        self.nearest = nearest
        self.suggested_replicas = (replica_hint[0] if replica_hint
                                   else None)
        self.suggested_point = replica_hint[1] if replica_hint else None
        c = target.clock_mhz
        msg = (
            f"no schedule among {n_points} legal points meets target "
            f"{target.describe()}; nearest-to-feasible point is "
            f"{nearest.key} (latency {nearest.latency_us(c):.2f}us, "
            f"dsp {nearest.dsp}, bram {nearest.bram_18k}, "
            f"throughput {nearest.throughput_eps(c):.0f}ev/s, "
            f"violation {violation(nearest, target):.1%}) — relax the "
            f"budget at least that far or widen the space spec")
        if replica_hint is not None:
            k, pt = replica_hint
            msg += (
                f"; or scale out: {k} data-parallel replicas of {pt.key} "
                f"({pt.throughput_eps(c):.0f}ev/s each, "
                f"{k * pt.throughput_eps(c):.0f}ev/s aggregate) clear the "
                f"throughput floor — set replicas={k} on the target and "
                f"serve through a ReplicaPool/Router of that size")
        super().__init__(msg)


# ---------------------------------------------------------------------------
# Pareto reduction
# ---------------------------------------------------------------------------


def pareto(points: Sequence[DesignPoint]) -> Tuple[DesignPoint, ...]:
    """Non-dominated subset under DesignPoint.dominates, sorted by latency
    (ties by DSP then BRAM then key, for determinism).

    Sort-then-scan: after sorting by (latency, dsp, bram), any dominator of
    a point precedes it, so one pass keeping the running non-dominated set
    is O(n·k) with k = frontier size.
    """
    ordered = sorted(points, key=lambda p: (p.latency_cycles, p.dsp,
                                            p.bram_18k, p.key))
    front: List[DesignPoint] = []
    for p in ordered:
        if not any(q.dominates(p) for q in front):
            front.append(p)
    return tuple(front)


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


_OBJECTIVE_RANK = {
    "latency": lambda p: (p.latency_cycles, p.dsp, p.bram_18k, p.key),
    "resources": lambda p: (p.dsp, p.bram_18k, p.latency_cycles, p.key),
    "throughput": lambda p: (p.ii_cycles, p.latency_cycles, p.dsp, p.key),
}


@dataclass(frozen=True)
class Exploration:
    """Everything ``explore`` learned about one (config, target) pair."""

    cfg: ModelConfig
    target: Optional[DesignTarget]
    points: Tuple[DesignPoint, ...]      # every legal priced point
    frontier: Tuple[DesignPoint, ...]    # Pareto over (latency, dsp, bram)
    feasible: Tuple[DesignPoint, ...]    # target-feasible, objective-ranked

    @property
    def best(self) -> Optional[DesignPoint]:
        return self.feasible[0] if self.feasible else None

    def frontier_table(self) -> List[dict]:
        return [p.report_row() for p in self.frontier]

    def prewarm(self, engine, k: Optional[int] = None) -> Dict[str, dict]:
        """Zero-warmup hook: ready the engine's serving executors for the
        top-``k`` feasible points (the whole Pareto frontier when the
        exploration had no target, or ``k=None`` for all of them).

        An engine started over a warm ``cache_dir`` loads every frontier
        entry instead of building: the first request on ANY frontier queue
        then builds nothing, which is what makes a target re-resolve (new
        tenant, redeploy) a routing decision instead of a latency cliff.
        Returns the engine's per-key ``{"status", "compile_s"}`` prewarm
        report."""
        pts = list(self.feasible if self.feasible else self.frontier)
        if k is not None:
            pts = pts[:k]
        return engine.prewarm(schedules=[p.schedule for p in pts],
                              fps=[p.fp for p in pts])


def _finish(cfg: ModelConfig, target: Optional[DesignTarget],
            points: Tuple[DesignPoint, ...]) -> Exploration:
    """Pareto-reduce priced points and rank the target-feasible region —
    shared by the scan-path and decode-path explorations."""
    front = pareto(points)
    if target is None:
        feas = tuple(sorted(points, key=_OBJECTIVE_RANK["latency"]))
    else:
        feas = tuple(sorted((p for p in points if is_feasible(p, target)),
                            key=_OBJECTIVE_RANK[target.objective]))
    return Exploration(cfg=cfg, target=target, points=points,
                       frontier=front, feasible=feas)


def _pricing_axes(target: Optional[DesignTarget]):
    fp = target.fp if target is not None else None
    clock = target.clock_mhz if target is not None else 200.0
    part = (target.part if target is not None and target.part is not None
            else "xcku115")
    return fp, clock, part


def explore(cfg: ModelConfig, target: Optional[DesignTarget] = None,
            spec: Optional[SpaceSpec] = None) -> Exploration:
    """Enumerate, price, and Pareto-reduce the legal schedule space.

    The fixed-point axis comes from the target (``target.fp``); pricing and
    the eventual serving queue both use that config, so the explored curve
    is the one the engine will execute.
    """
    schedules = enumerate_space(cfg, spec)
    fp, clock, part = _pricing_axes(target)
    if is_native_int(fp):
        # the native int bodies cannot hoist/pipeline — prune the points
        # the quantized kernels would refuse to execute
        schedules = tuple(s for s in schedules if native_int_legal(s))
    points = tuple(price_point(cfg, s, fp, clock_mhz=clock, part=part)
                   for s in schedules)
    return _finish(cfg, target, points)


def explore_decode(cfg: ModelConfig, target: Optional[DesignTarget] = None,
                   spec: Optional[SpaceSpec] = None) -> Exploration:
    """The decode-path exploration: the DECODE-LEGAL slice of the space
    (static, un-hoisted — see ``space.decode_legal``), every point priced
    with the single-step estimate (``price_decode_point``: II ~ R, full
    weight resident) instead of the whole-sequence scan estimate.  The
    same DesignTarget constraints and objectives apply — a latency budget
    now reads "per state update" rather than "per sequence"."""
    schedules = enumerate_decode_space(cfg, spec)
    fp, clock, part = _pricing_axes(target)
    points = tuple(price_decode_point(cfg, s, fp, clock_mhz=clock, part=part)
                   for s in schedules)
    return _finish(cfg, target, points)


def select(cfg: ModelConfig, target: DesignTarget,
           spec: Optional[SpaceSpec] = None, *,
           measure_top_k: int = 0,
           measure_batch: int = 32,
           device: Union[str, torch.device] = "cuda") -> DesignPoint:
    """The auto-scheduler entry point: target -> the schedule to serve.

    Raises :class:`InfeasibleTargetError` (naming the nearest-to-feasible
    point) when nothing in the space meets the target, and a plain
    ``ValueError`` when the spec pruned the space to nothing (there is no
    nearest point to name).  With ``measure_top_k > 0`` the top-k feasible
    candidates (by predicted objective) are re-ranked by measured
    steady-state wall-clock — analytic pricing proposes, measurement
    disposes.  Measurement carries no resource information, so the
    ``"resources"`` objective keeps the analytic ranking (its optimum is a
    DSP count, not a wall-clock).  ``device`` is where ``measure_points``
    times the candidates: "cuda" unless the caller asks for "cpu".
    """
    ex = explore(cfg, target, spec)
    _check_selectable(ex, target)
    if measure_top_k <= 0 or target.objective == "resources":
        return ex.feasible[0]
    top = list(ex.feasible[:measure_top_k])
    walls = measure_points(cfg, top, batch=measure_batch, device=device)
    return min(top, key=lambda p: (walls[p.key], p.dsp, p.key))


def _check_selectable(ex: Exploration, target: DesignTarget) -> None:
    if not ex.points:
        raise ValueError(
            f"enumerated schedule space is empty for target "
            f"{target.describe()}: the space spec pruned every point "
            f"(e.g. a launch layout the card refuses: scan_layout's "
            f"cluster layouts or decode_layout, or reuse factors that do "
            f"not divide the gate dimension) — widen the SpaceSpec")
    if not ex.feasible:
        nearest = min(ex.points, key=lambda p: (violation(p, target),
                                                p.latency_cycles, p.key))
        raise InfeasibleTargetError(target, nearest, len(ex.points),
                                    replica_hint=suggest_replicas(ex.points,
                                                                  target))


def select_decode(cfg: ModelConfig, target: DesignTarget,
                  spec: Optional[SpaceSpec] = None) -> DesignPoint:
    """Target -> the schedule the single-step decode path should run.

    Decode counterpart of :func:`select`: same constraint/objective
    machinery over the decode-legal space priced per state update.
    Analytic-only: the decode wall clock is not re-measured here.
    """
    ex = explore_decode(cfg, target, spec)
    _check_selectable(ex, target)
    return ex.feasible[0]


# ---------------------------------------------------------------------------
# Degradation ladder (overload control's pre-warmed fallback schedules)
# ---------------------------------------------------------------------------


def degradation_ladder(cfg: ModelConfig, base: DesignPoint, *,
                       spec: Optional[SpaceSpec] = None,
                       fp=None,
                       max_rungs: int = 4,
                       min_gain: float = 1.5) -> Tuple[DesignPoint, ...]:
    """Pre-warmable fallback schedules for graceful degradation under
    overload — rung 0 is the resolved ``base`` point, every later rung
    buys at least ``min_gain``x more priced throughput than the rung
    before it.

    When a streaming pipeline's sustained queue depth crosses its
    high-water mark it steps DOWN this ladder (and back up on low water):
    each step raises the admission rate (``admission_rate_eps`` of the
    rung's estimate) the same way the paper trades ``reuse_factor`` —
    giving up latency/resource headroom for initiation-interval
    throughput, accuracy-neutral because every rung executes the same
    trained weights, just under a different schedule.

    Candidates come from the Pareto frontier of the float space, plus —
    when ``fp`` is a native-int config — the native-legal quantized slice
    (``space.native_int_legal``), priced WITH that fp, so an int8 rung can
    appear where float pricing has no headroom left.  The result is
    deterministic: throughput strictly ascends along the ladder, ties
    broken toward fewer resources, deduped by serving key.
    """
    if max_rungs < 1:
        raise ValueError(f"max_rungs must be >= 1: {max_rungs}")
    if min_gain <= 1.0:
        raise ValueError(f"min_gain must be > 1.0: {min_gain}")
    clock = base.clock_mhz
    candidates: List[DesignPoint] = list(explore(cfg, None, spec).frontier)
    if is_native_int(fp):
        qt = DesignTarget(fp=fp, objective="throughput", clock_mhz=clock)
        candidates.extend(explore(cfg, qt, spec).frontier)
    ladder: List[DesignPoint] = [base]
    seen = {base.key}
    # descending ii = ascending throughput: each accepted rung is the
    # SMALLEST gain >= min_gain, keeping later rungs available for later
    pool = sorted((p for p in candidates if p.key not in seen),
                  key=lambda p: (-p.ii_cycles, p.dsp, p.bram_18k, p.key))
    for p in pool:                       # ascending throughput order
        if len(ladder) >= max_rungs:
            break
        if p.key in seen:
            continue
        if p.throughput_eps(clock) >= min_gain * ladder[-1].throughput_eps(
                clock):
            ladder.append(p)
            seen.add(p.key)
    return tuple(ladder)


# ---------------------------------------------------------------------------
# Measured refinement (steady-state timing on the device)
# ---------------------------------------------------------------------------


def measure_points(cfg: ModelConfig, points: Sequence[DesignPoint], *,
                   batch: int = 32, iters: int = 3, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, float]:
    """Steady-state seconds/call of the scan kernel under each point's
    schedule (min over iters; the first, untimed call builds the kernels
    and fills the layout and residency caches) — keyed by point.key.

    Inputs come from ``numpy.random.RandomState(seed)`` (the JAX package's
    draws) as tensors on ``device``: "cuda" (the default) launches the
    CUDA kernels and raises where no CUDA device is available; on a CUDA
    device every stop of the clock follows ``torch.cuda.synchronize()``.
    On ``device="cpu"`` the kernel path runs the kernels' plain PyTorch
    versions, whose times say nothing about the card, so a ranking taken
    there means nothing.

    Measures the float kernel datapath (the quantizer wraps it uniformly,
    so fixed-point configs do not reorder schedules).
    """
    device = require_device(device, "measure_points")
    rnn = cfg.rnn
    assert rnn is not None
    g = gate_count(rnn.cell)
    rng = np.random.RandomState(seed)

    def draw(*shape, scale=1.0):
        a = rng.randn(*shape).astype(np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device)

    xs = draw(batch, rnn.seq_len, rnn.input_size)
    W = draw(rnn.input_size, g * rnn.hidden, scale=.3)
    U = draw(rnn.hidden, g * rnn.hidden, scale=.3)
    bshape = (g * rnn.hidden,) if rnn.cell == "lstm" else (2, g * rnn.hidden)
    b = draw(*bshape, scale=.1)
    op = ops.SCHEDULED_KERNELS["lstm" if rnn.cell == "lstm" else "gru"][0]

    def run(schedule) -> None:
        op(xs, W, U, b, schedule=schedule)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    walls: Dict[str, float] = {}
    with torch.inference_mode():
        for p in points:
            run(p.schedule)                          # builds, untimed
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                run(p.schedule)
                best = min(best, time.perf_counter() - t0)
            walls[p.key] = best
    return walls


# ---------------------------------------------------------------------------
# Speculative exploration: price (draft, verify, K) triples analytically
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpeculativePoint:
    """One priced (draft, verify, K) speculative triple."""

    draft: Optional[object]              # KernelSchedule | None (n-gram)
    verify: object                       # KernelSchedule
    k: int
    estimate: object                     # core.hls.SpeculativeEstimate

    @property
    def key(self) -> str:
        d = "ngram" if self.draft is None else self.draft.key()
        return f"spec(k={self.k}, draft={d}, verify={self.verify.key()})"

    def report_row(self, clock_mhz: float = 200.0) -> dict:
        return {"key": self.key, **self.estimate.report_row(clock_mhz)}


def _estimate_for(cfg: ModelConfig, schedule, fp):
    """Single-step estimate of one schedule on this config's decode path:
    the RNN step for recurrent families, the dense-stack LM step
    otherwise — the same split the serving engines execute."""
    if cfg.rnn is not None:
        return estimate_decode_step(schedule, cfg.rnn, fp)
    return estimate_lm_decode(schedule, cfg, fp)


def _spec_feasible(est, target: Optional[DesignTarget]) -> bool:
    """Target feasibility for a speculative estimate: resource caps apply
    to the SUM of both resident datapaths, the latency budget to the
    expected per-token latency of the round, the throughput floor to the
    expected tokens/s."""
    if target is None:
        return True
    c = target.clock_mhz
    if target.max_dsp is not None and est.dsp > target.max_dsp:
        return False
    if target.max_bram_18k is not None and est.bram_18k > target.max_bram_18k:
        return False
    if (target.max_latency_us is not None
            and est.latency_us_per_token(c) > target.max_latency_us):
        return False
    if (target.min_throughput_eps is not None
            and est.tokens_per_s(c) < target.min_throughput_eps):
        return False
    return True


def explore_speculative(cfg: ModelConfig,
                        target: Optional[DesignTarget] = None,
                        spec: Optional[SpaceSpec] = None, *,
                        ks: Sequence[int] = (1, 2, 4, 8),
                        accept_rate: float = 0.75,
                        include_ngram: bool = True
                        ) -> Tuple[SpeculativePoint, ...]:
    """Price every legal (draft, verify, K) triple and rank by expected
    tokens/cycle (ties toward fewer DSPs, then key — deterministic).

    ``accept_rate`` is the ASSUMED per-draft acceptance probability; the
    bench harness records the measured rate next to it, the same
    predicted-vs-measured discipline as every other estimator here.
    Target constraints prune on the summed-resource / per-token-latency
    axes (``_spec_feasible``)."""
    triples = enumerate_speculative_space(cfg, spec, ks=tuple(ks),
                                          include_ngram=include_ngram)
    fp, _clock, _part = _pricing_axes(target)
    cache: Dict[str, object] = {}

    def est_of(schedule):
        key = schedule.key()
        if key not in cache:
            cache[key] = _estimate_for(cfg, schedule, fp)
        return cache[key]

    points = []
    for draft, verify, k in triples:
        est = estimate_speculative(
            None if draft is None else est_of(draft), est_of(verify), k,
            accept_rate)
        if _spec_feasible(est, target):
            points.append(SpeculativePoint(draft=draft, verify=verify, k=k,
                                           estimate=est))
    points.sort(key=lambda p: (-p.estimate.tokens_per_cycle,
                               p.estimate.dsp, p.key))
    return tuple(points)


def select_speculative(cfg: ModelConfig,
                       target: Optional[DesignTarget] = None,
                       spec: Optional[SpaceSpec] = None, *,
                       ks: Sequence[int] = (1, 2, 4, 8),
                       accept_rate: float = 0.75,
                       include_ngram: bool = True,
                       measure_fn=None,
                       measure_top_k: int = 3) -> SpeculativePoint:
    """Pick the speculative triple to serve: the analytically best point,
    optionally re-ranked by measurement — ``measure_fn(point) ->
    tokens/s`` runs the top-k predicted candidates through the real
    engine and the HIGHEST measured rate wins (ties toward fewer DSPs).
    Raises ValueError when the target prunes the space to nothing."""
    points = explore_speculative(cfg, target, spec, ks=ks,
                                 accept_rate=accept_rate,
                                 include_ngram=include_ngram)
    if not points:
        raise ValueError(
            "no speculative (draft, verify, K) triple is feasible: the "
            "target pruned every point — relax the resource/latency "
            "budget, widen the SpaceSpec, or allow the n-gram draft")
    if measure_fn is None or measure_top_k <= 0:
        return points[0]
    top = list(points[:measure_top_k])
    walls = {p.key: float(measure_fn(p)) for p in top}
    return max(top, key=lambda p: (walls[p.key], -p.estimate.dsp))
