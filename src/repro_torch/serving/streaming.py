"""Trigger-grade streaming: admission control, load shedding, degradation.

The paper's L1T scenario is a hard-real-time stream: a new collision every
25 ns, a fixed decision deadline, and NO elastic buffer — an event that
cannot be decided in time is not slowed down, it is *dropped*, and the
trigger menu is *degraded* (coarser algorithms) before the farm is allowed
to fall over.  This module brings that discipline to the serving layer:

  ingest -> feature-prep -> admission -> queue -> infer -> decision-sink

with a monotonic timestamp at every stage boundary and three explicit
overload mechanisms, all accounted per schedule key — a request is always
exactly one of ``answered | shed | failed`` (plus transient
``pending | queued``), never silently lost:

  * **Admission control** — a token bucket refilled at the *priced*
    throughput of the current rung's :class:`DesignPoint`
    (``core.hls.admission_rate_eps``): traffic beyond what the resolved
    design can sustain is shed at ingest, before it costs anything.
  * **Deadline-aware shedding** — at enqueue, the projected completion
    (single-server queue model: current backlog x per-event occupancy
    ``ii_s`` + service latency) is checked against the request's absolute
    deadline; a request that cannot make it is shed NOW, not after wasting
    a server slot.  The check repeats at dispatch, so injected stalls
    convert would-be deadline misses into late sheds — an ANSWERED
    request's result is available within its deadline.
  * **Graceful degradation** — a ladder of pre-warmed cheaper design
    points (higher reuse factor, or native-int when legal) from the
    autotuned frontier (``autotune.degradation_ladder``).  Sustained queue
    depth above ``high_water`` downgrades one rung (admission rate rises
    with the rung's priced throughput); sustained depth at or below
    ``low_water`` recovers one rung.  Every rung is compiled at pipeline
    construction — a downgrade never pays a compile.

Two clock domains, deliberately separate: *stage timestamps* live in the
pipeline clock (injectable — :class:`~repro_torch.serving.faults.VirtualClock`
for deterministic replay, ``time.perf_counter`` live), while *service
times* come from the analytical model (``service_model="analytical"``:
``estimate.service_s`` / ``ii_s`` of the rung actually executed) or from
an EWMA of measured flush wall-clock (``"measured"``).  Analytical replay
is exactly reproducible: same arrival trace in, same sheds, same
downgrades, same per-stage percentiles out.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hls import DesignPoint, admission_rate_eps, price_point
from repro_torch.serving.batcher import KeyStats
from repro_torch.serving.faults import FaultInjector, InjectedFault

#: pipeline stages, in order; every boundary gets a monotonic stamp
STAGES = ("ingest", "prep", "queue", "infer", "sink")

#: why a request can be shed (each has its own per-key counter)
SHED_REASONS = ("admission", "deadline", "queue_full")

SERVICE_MODELS = ("analytical", "measured")
EXEC_MODES = ("batch", "one")


@dataclass
class StreamRequest:
    """One event moving through the pipeline.

    ``stamps`` maps stage name -> the pipeline-clock time at which the
    stage COMPLETED for this request; stamps are monotone non-decreasing
    in stage order.  ``deadline_s`` is absolute (arrival + deadline);
    the pipeline guarantees an answered request's ``infer`` stamp is
    within it whenever the service model is analytical.
    """

    payload: Any
    arrival_s: float
    deadline_s: float
    req_id: int
    key: str                      # schedule key of the rung at admission
    rung: int                     # ladder index at admission
    stamps: Dict[str, float] = field(default_factory=dict)
    status: str = "pending"       # pending|queued|answered|shed|failed
    shed_reason: Optional[str] = None
    error: Optional[BaseException] = None
    features: Any = None
    result: Any = None

    @property
    def latency_s(self) -> Optional[float]:
        """Arrival -> decision-sink, the end-to-end number."""
        t = self.stamps.get("sink")
        return None if t is None else t - self.arrival_s

    @property
    def infer_latency_s(self) -> Optional[float]:
        """Arrival -> inference result available (the deadline governs
        THIS stamp; the sink may legitimately run after it)."""
        t = self.stamps.get("infer")
        return None if t is None else t - self.arrival_s

    @property
    def remaining_s(self) -> float:
        """Budget left at the latest stamped point."""
        t = max(self.stamps.values()) if self.stamps else self.arrival_s
        return self.deadline_s - t


@dataclass
class TokenBucket:
    """Classic token bucket: ``rate_eps`` tokens/s, capacity ``burst``.

    The burst absorbs float rounding at exactly-priced arrival rates (a
    1.0x replay must not shed) and lets a short backlog form under real
    overload so the watermark machinery can see it.
    """

    rate_eps: float
    burst: float = 16.0
    tokens: float = field(init=False)
    t_last: Optional[float] = None

    def __post_init__(self):
        if self.rate_eps <= 0:
            raise ValueError(f"rate_eps must be > 0: {self.rate_eps}")
        self.tokens = float(self.burst)

    def set_rate(self, rate_eps: float) -> None:
        if rate_eps <= 0:
            raise ValueError(f"rate_eps must be > 0: {rate_eps}")
        self.rate_eps = rate_eps

    def try_take(self, now: float) -> bool:
        if self.t_last is None:
            self.t_last = now
        self.tokens = min(float(self.burst),
                          self.tokens + (now - self.t_last) * self.rate_eps)
        self.t_last = now
        if self.tokens >= 1.0 - 1e-9:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class KeyCounts:
    """Per-schedule-key request accounting — the exactness invariant
    ``submitted == answered + failed + shed + in_flight`` is checked by
    :meth:`StreamingPipeline.verify_accounting`."""

    submitted: int = 0
    admitted: int = 0
    answered: int = 0
    failed: int = 0
    shed_admission: int = 0
    shed_deadline: int = 0
    shed_queue_full: int = 0
    deadline_miss: int = 0        # answered but infer stamp past deadline
                                  # (possible only under the measured model)

    @property
    def shed(self) -> int:
        return self.shed_admission + self.shed_deadline + self.shed_queue_full

    def as_dict(self) -> Dict[str, int]:
        return {"submitted": self.submitted, "admitted": self.admitted,
                "answered": self.answered, "failed": self.failed,
                "shed": self.shed, "shed_admission": self.shed_admission,
                "shed_deadline": self.shed_deadline,
                "shed_queue_full": self.shed_queue_full,
                "deadline_miss": self.deadline_miss}


class StreamingPipeline:
    """Deadline-aware streaming front end over an :class:`RNNServingEngine`.

    ``ladder`` is a sequence of :class:`DesignPoint` rungs with strictly
    ascending priced throughput — rung 0 is the quality point, later rungs
    are the degraded (cheaper, faster) fallbacks (see
    ``autotune.degradation_ladder``).  ``None`` builds a one-rung ladder
    from the engine's resolved schedule.

    ``push(payload, now=...)`` runs ingest + feature prep + the admission
    and shed gates; ``pump(now=...)`` dispatches every queued request whose
    simulated service start has arrived; ``drain()`` force-runs the queue
    dry (end of stream).  All three accept an explicit ``now`` for
    deterministic replay and fall back to the pipeline clock.
    """

    def __init__(self, engine=None,
                 ladder: Optional[Sequence[DesignPoint]] = None,
                 *,
                 router=None,
                 deadline_us: float,
                 clock_mhz: float = 200.0,
                 utilization: float = 1.0,
                 burst: float = 16.0,
                 max_queue: int = 64,
                 high_water: int = 8,
                 low_water: int = 1,
                 sustain: int = 3,
                 recovery_sustain: Optional[int] = None,
                 feature_fn: Optional[Callable[[Any], Any]] = None,
                 decision_fn: Optional[Callable[[np.ndarray], Any]] = None,
                 exec_mode: str = "batch",
                 service_model: str = "analytical",
                 stage_budgets_us: Optional[Dict[str, float]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 faults: Optional[FaultInjector] = None,
                 prewarm: bool = True):
        if deadline_us <= 0:
            raise ValueError(f"deadline_us must be > 0: {deadline_us}")
        if exec_mode not in EXEC_MODES:
            raise ValueError(f"exec_mode {exec_mode!r} not in {EXEC_MODES}")
        if service_model not in SERVICE_MODELS:
            raise ValueError(
                f"service_model {service_model!r} not in {SERVICE_MODELS}")
        if not 0 <= low_water < high_water:
            raise ValueError(f"need 0 <= low_water < high_water: "
                             f"{low_water}, {high_water}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1: {max_queue}")

        # replicated serving: a Router replaces the single engine for the
        # infer stage; admission and the occupancy model scale with the
        # pool's HEALTHY replica count (re-rated live as replicas retire /
        # re-admit), while schedule resolution and prewarm go through the
        # pool's reference engine
        self.router = router
        if router is not None:
            if engine is not None:
                raise ValueError(
                    "pass either engine= or router=, not both: the router's "
                    "pool supplies the engines")
            engine = router.reference_engine
        elif engine is None:
            raise ValueError("StreamingPipeline needs an engine or a router")
        self.engine = engine
        if ladder is None:
            sched, fp = engine.resolve()
            ladder = (price_point(engine.cfg, sched, fp,
                                  clock_mhz=clock_mhz),)
        self.ladder: Tuple[DesignPoint, ...] = tuple(ladder)
        if not self.ladder:
            raise ValueError("ladder must have at least one rung")
        for a, b in zip(self.ladder, self.ladder[1:]):
            if b.throughput_eps(clock_mhz) <= a.throughput_eps(clock_mhz):
                raise ValueError(
                    f"ladder throughput must be strictly ascending: "
                    f"{a.key} ({a.throughput_eps(clock_mhz):.0f} eps) -> "
                    f"{b.key} ({b.throughput_eps(clock_mhz):.0f} eps)")

        self.deadline_s = deadline_us * 1e-6
        self.clock_mhz = clock_mhz
        self.utilization = utilization
        self.max_queue = max_queue
        self.high_water = high_water
        self.low_water = low_water
        self.sustain = sustain
        # recovery is deliberately stickier than downgrade: a drained queue
        # right after a downgrade is the downgrade WORKING, not the
        # overload ending — recovering on the same streak would oscillate
        self.recovery_sustain = (recovery_sustain if recovery_sustain
                                 is not None else 4 * sustain)
        self.feature_fn = feature_fn
        self.decision_fn = decision_fn
        self.exec_mode = exec_mode
        self.service_model = service_model
        self.stage_budgets_us = dict(stage_budgets_us or {})
        self.faults = faults if faults is not None else FaultInjector()
        self._clock = clock if clock is not None else time.perf_counter

        self.rung = 0
        self._capacity_seen = self.capacity()
        self._bucket = TokenBucket(self._rung_rate(0) * self._capacity_seen,
                                   burst=burst)
        self._queue: List[StreamRequest] = []
        self._server_free_s = float("-inf")
        self._last_now = float("-inf")
        self._ids = itertools.count()
        self._ewma_s: Optional[float] = None   # measured service model
        self._hi_streak = 0
        self._lo_streak = 0

        self.counts: Dict[str, KeyCounts] = {}
        self.downgrades = 0
        self.recoveries = 0
        self.rerates = 0              # admission re-rates on capacity change
        self.clock_steps = 0          # backwards clock steps absorbed
        self._stage_sim: Dict[str, KeyStats] = {s: KeyStats() for s in STAGES}
        self._stage_wall: Dict[str, KeyStats] = {s: KeyStats()
                                                 for s in ("prep", "infer",
                                                           "sink")}
        self._stage_over: Dict[str, int] = {s: 0 for s in STAGES}

        # every rung's executable exists before traffic: a downgrade under
        # overload must never pay a compile (with a router, on EVERY
        # replica — failover must be zero-warmup too)
        engines = ([rep.engine for rep in router.pool]
                   if router is not None else [engine])
        for eng in engines:
            for pt in self.ladder:
                eng._ensure_key(pt.schedule, pt.fp)
            if prewarm:
                eng.prewarm(schedules=[pt.schedule for pt in self.ladder],
                            fps=[pt.fp for pt in self.ladder])

    # -- clocks & rates ------------------------------------------------------

    def _now(self, now: Optional[float] = None) -> float:
        """Read the pipeline clock, clamped monotone.  A backwards step
        (misbehaving host clock) is absorbed — time holds still rather than
        running backwards — and counted in ``clock_steps``.

        Only CLOCK READS move the monotone floor.  Per-request stage stamps
        routinely lie in the future of the driving clock (the server
        finishes an event at ``start + service`` while the next arrival is
        already being pushed) — they are projections, not observations, and
        must never clamp subsequent clock reads upward."""
        t = self._clock() if now is None else now
        if t < self._last_now:
            self.clock_steps += 1
            t = self._last_now
        self._last_now = t
        return t

    def _rung_rate(self, rung: int) -> float:
        return admission_rate_eps(self.ladder[rung].estimate, self.clock_mhz,
                                  utilization=self.utilization)

    def capacity(self) -> int:
        """Healthy replicas backing the infer stage (1 without a router;
        floored at 1 — a fully dark pool still drains at single-replica
        pace rather than dividing by zero, and sheds on failure instead)."""
        if self.router is None:
            return 1
        return max(self.router.healthy_count(), 1)

    def _rerate(self) -> None:
        """Scale admission to the CURRENT healthy capacity: K healthy
        replicas sustain K x the rung's priced throughput, and a retirement
        mid-stream tightens admission instead of letting the queue grow
        into deadline sheds.  Called from push/pump; counted when the
        capacity actually changed."""
        cap = self.capacity()
        if cap == self._capacity_seen:
            return
        self._capacity_seen = cap
        self.rerates += 1
        self._bucket.set_rate(self._rung_rate(self.rung) * cap)

    @property
    def current_point(self) -> DesignPoint:
        return self.ladder[self.rung]

    def admission_rate(self) -> float:
        """Current token-bucket refill rate (events/s)."""
        return self._bucket.rate_eps

    def _service_s(self, rung: int) -> Optional[float]:
        """Per-event service latency; None = no estimate yet (measured
        model before the first flush) — such events are admitted."""
        if self.service_model == "analytical":
            return self.ladder[rung].estimate.service_s(self.clock_mhz)
        return self._ewma_s

    def _occupancy_s(self, rung: int) -> float:
        """Seconds of server the event occupies (II for a pipelined
        design — later events overlap the latency tail).  With a router,
        K healthy replicas drain K events per interval, so the
        single-server free pointer becomes a K-server fluid model."""
        if self.service_model == "analytical":
            occ = self.ladder[rung].estimate.ii_s(self.clock_mhz)
        else:
            occ = self._ewma_s or 0.0
        return occ / self.capacity()

    # -- accounting ----------------------------------------------------------

    def _count(self, key: str) -> KeyCounts:
        return self.counts.setdefault(key, KeyCounts())

    def _record_stage(self, stage: str, dt: float, wall: Optional[float] = None
                      ) -> None:
        self._stage_sim[stage].record_one(dt)
        if wall is not None:
            self._stage_wall[stage].record_one(wall)
        budget = self.stage_budgets_us.get(stage)
        if budget is not None and dt > budget * 1e-6:
            self._stage_over[stage] += 1

    def _shed(self, r: StreamRequest, reason: str, t: float) -> StreamRequest:
        r.status = "shed"
        r.shed_reason = reason
        r.stamps.setdefault("shed", t)
        setattr(self._count(r.key), f"shed_{reason}",
                getattr(self._count(r.key), f"shed_{reason}") + 1)
        return r

    def _fail(self, r: StreamRequest, e: BaseException, t: float
              ) -> StreamRequest:
        r.status = "failed"
        r.error = e
        r.stamps.setdefault("failed", t)
        self._count(r.key).failed += 1
        return r

    # -- the single-server queue projection ----------------------------------

    def _projected_free_s(self) -> float:
        """When the server frees up after the current backlog (each queued
        event occupies ``ii_s`` of its rung)."""
        free = self._server_free_s
        for q in self._queue:
            start = max(q.stamps["prep"], free)
            free = start + self._occupancy_s(q.rung)
        return free

    # -- ingest + admission (per event) --------------------------------------

    def push(self, payload: Any, now: Optional[float] = None) -> StreamRequest:
        """Run one event through ingest, feature prep, and the admission /
        shed gates.  Returns the request with its fate already decided
        (``queued``, ``shed``, or ``failed``) — an admitted request is
        answered by a later :meth:`pump` / :meth:`drain`."""
        t = self._now(now)
        self._rerate()
        r = StreamRequest(payload=payload, arrival_s=t,
                          deadline_s=t + self.deadline_s,
                          req_id=next(self._ids),
                          key=self.current_point.key, rung=self.rung)
        self._count(r.key).submitted += 1

        # ingest: the hand-off from the detector/feed into the pipeline
        try:
            t += self.faults.stall_s("ingest")
            self.faults.check("ingest")
        except Exception as e:
            return self._fail(r, e, t)
        r.stamps["ingest"] = t
        self._record_stage("ingest", t - r.arrival_s)

        # admission: token bucket at the rung's priced throughput
        if not self._bucket.try_take(t):
            return self._shed(r, "admission", t)

        # feature prep: real compute (wall-clocked) + simulated stall
        w0 = time.perf_counter()
        try:
            self.faults.check("prep")
            r.features = (payload if self.feature_fn is None
                          else self.feature_fn(payload))
        except Exception as e:
            return self._fail(r, e, t)
        wall = time.perf_counter() - w0
        t += self.faults.stall_s("prep")
        r.stamps["prep"] = t
        self._record_stage("prep", t - r.stamps["ingest"], wall=wall)

        # bounded queue: an overfull queue is an explicit shed, not growth
        if len(self._queue) >= self.max_queue:
            self._shed(r, "queue_full", t)
            self._watermark()
            return r

        # deadline-aware shed: projected completion behind the backlog
        svc = self._service_s(r.rung)
        if svc is not None:
            start = max(t, self._projected_free_s())
            if start + svc > r.deadline_s + 1e-12:
                self._shed(r, "deadline", t)
                self._watermark()
                return r

        self._queue.append(r)
        r.status = "queued"
        self._count(r.key).admitted += 1
        self._watermark()
        return r

    # -- dispatch ------------------------------------------------------------

    def pump(self, now: Optional[float] = None, force: bool = False
             ) -> List[StreamRequest]:
        """Dispatch every queued request whose service start has arrived
        (``force`` ignores the clock — the end-of-stream drain).  Returns
        the requests completed this call (answered or failed) plus any
        late sheds."""
        t = self._now(now)
        self._rerate()
        done: List[StreamRequest] = []

        # an infer-stage stall holds the server itself: it pushes the free
        # pointer BEFORE the dispatch-time deadline re-check, so requests
        # the stall pushed past their deadline shed late instead of being
        # answered late
        stall = self.faults.stall_s("infer")
        if stall > 0:
            self._server_free_s = max(self._server_free_s, t) + stall

        dispatch: List[StreamRequest] = []
        while self._queue:
            q = self._queue[0]
            start = max(q.stamps["prep"], self._server_free_s)
            svc = self._service_s(q.rung)
            # a doomed request sheds NOW even if the server isn't free yet:
            # its projected start only ever grows, so waiting for the clock
            # to reach it would just hold a dead entry in the queue (and
            # inflate the watermark depth with work that will never run)
            if svc is not None and start + svc > q.deadline_s + 1e-12:
                self._queue.pop(0)
                done.append(self._shed(q, "deadline", start))
                continue
            if not force and start > t:
                break
            self._queue.pop(0)
            q.stamps["queue"] = start
            self._record_stage("queue", start - q.stamps["prep"])
            self._server_free_s = start + self._occupancy_s(q.rung)
            dispatch.append(q)

        done.extend(self._execute(dispatch))
        self._watermark()
        return done

    def drain(self, now: Optional[float] = None) -> List[StreamRequest]:
        """Force-run the queue dry (end of stream / shutdown).  Bounded:
        every iteration strictly shrinks the queue, so this cannot spin."""
        done: List[StreamRequest] = []
        while self._queue:
            before = len(self._queue)
            done.extend(self.pump(now=now, force=True))
            assert len(self._queue) < before, "drain made no progress"
        return done

    # -- execution -----------------------------------------------------------

    def _execute(self, dispatch: List[StreamRequest]) -> List[StreamRequest]:
        if not dispatch:
            return []
        # group by rung so co-batching lands each request on its admitted
        # rung's queue (a request is NEVER silently re-scheduled after
        # admission: its deadline projection priced THIS rung)
        groups: Dict[int, List[StreamRequest]] = {}
        for q in dispatch:
            groups.setdefault(q.rung, []).append(q)

        if self.router is not None:
            # replicated infer: each event runs the router's full ladder
            # (timeout -> retry -> hedge -> failover); a routed request
            # that still ends failed/shed surfaces as THIS request's
            # failure, others unaffected
            for rung, qs in groups.items():
                pt = self.ladder[rung]
                for q in qs:
                    w0 = time.perf_counter()
                    rr = self.router.submit(q.features, schedule=pt.schedule,
                                            fp=pt.fp, now=q.stamps["queue"])
                    if rr.status != "answered":
                        err = rr.error if rr.error is not None else \
                            RuntimeError(f"routed request shed: "
                                         f"{rr.shed_reason}")
                        self._fail(q, err, q.stamps["queue"])
                        continue
                    self._finish(q, rr.result, time.perf_counter() - w0)
        elif self.exec_mode == "one":
            for rung, qs in groups.items():
                pt = self.ladder[rung]
                for q in qs:
                    w0 = time.perf_counter()
                    try:
                        out = self.engine.predict_one(q.features,
                                                      schedule=pt.schedule,
                                                      fp=pt.fp)
                    except Exception as e:
                        self._fail(q, e, q.stamps["queue"])
                        continue
                    self._finish(q, out, time.perf_counter() - w0)
        else:
            pairs = []
            for rung, qs in groups.items():
                pt = self.ladder[rung]
                for q in qs:
                    pairs.append((q, self.engine.submit(q.features,
                                                        schedule=pt.schedule,
                                                        fp=pt.fp)))
            w0 = time.perf_counter()
            self.engine.flush(force=True)
            wall = (time.perf_counter() - w0) / max(len(pairs), 1)
            for q, ereq in pairs:
                if ereq.error is not None:
                    # the engine's per-key flush isolation attached the
                    # error; surface it on THIS request, others unaffected
                    self._fail(q, ereq.error, q.stamps["queue"])
                else:
                    self._finish(q, ereq.result, wall)
        return dispatch

    def _finish(self, q: StreamRequest, out: np.ndarray, wall_s: float
                ) -> None:
        svc = self._service_s(q.rung)
        if self.service_model == "measured":
            # EWMA of measured per-event wall-clock feeds the next
            # projections (the live-traffic mode, where there is no
            # analytical clock domain to trust)
            self._ewma_s = (wall_s if self._ewma_s is None
                            else 0.7 * self._ewma_s + 0.3 * wall_s)
            t_infer = q.stamps["queue"] + wall_s
        else:
            t_infer = q.stamps["queue"] + (svc or 0.0)
        q.stamps["infer"] = t_infer
        self._record_stage("infer", t_infer - q.stamps["queue"], wall=wall_s)
        if t_infer > q.deadline_s + 1e-12:
            self._count(q.key).deadline_miss += 1

        # decision sink: the trigger decision leaves the pipeline
        w0 = time.perf_counter()
        try:
            self.faults.check("sink")
            q.result = (out if self.decision_fn is None
                        else self.decision_fn(out))
        except Exception as e:
            self._fail(q, e, t_infer)
            return
        wall = time.perf_counter() - w0
        t_sink = t_infer + self.faults.stall_s("sink")
        q.stamps["sink"] = t_sink
        self._record_stage("sink", t_sink - t_infer, wall=wall)
        q.status = "answered"
        self._count(q.key).answered += 1

    # -- degradation ladder --------------------------------------------------

    def _watermark(self) -> None:
        """Hysteresis over queue depth: sustained ``high_water`` depth
        downgrades one rung, sustained ``low_water`` depth recovers one."""
        depth = len(self._queue)
        if depth >= self.high_water:
            self._hi_streak += 1
            self._lo_streak = 0
            if self._hi_streak >= self.sustain \
                    and self.rung + 1 < len(self.ladder):
                self.rung += 1
                self.downgrades += 1
                self._hi_streak = 0
                self._bucket.set_rate(self._rung_rate(self.rung)
                                      * self.capacity())
        elif depth <= self.low_water:
            self._lo_streak += 1
            self._hi_streak = 0
            if self._lo_streak >= self.recovery_sustain and self.rung > 0:
                self.rung -= 1
                self.recoveries += 1
                self._lo_streak = 0
                self._bucket.set_rate(self._rung_rate(self.rung)
                                      * self.capacity())
        else:
            self._hi_streak = 0
            self._lo_streak = 0

    # -- invariants & reporting ----------------------------------------------

    def in_flight(self, key: Optional[str] = None) -> int:
        if key is None:
            return len(self._queue)
        return sum(1 for q in self._queue if q.key == key)

    def verify_accounting(self) -> Dict[str, Dict[str, int]]:
        """Assert the exactness invariant per key:
        ``submitted == answered + failed + shed + in_flight`` — every
        submitted request is accounted for, none lost, none double-counted.
        Returns the per-key counters on success."""
        out: Dict[str, Dict[str, int]] = {}
        for key, c in self.counts.items():
            accounted = c.answered + c.failed + c.shed + self.in_flight(key)
            if accounted != c.submitted:
                raise AssertionError(
                    f"accounting broken for {key!r}: submitted="
                    f"{c.submitted} but answered={c.answered} + failed="
                    f"{c.failed} + shed={c.shed} + in_flight="
                    f"{self.in_flight(key)} = {accounted}")
            out[key] = c.as_dict()
        return out

    def stage_report(self) -> Dict[str, Dict]:
        """Per-stage budget report: simulated-clock percentiles (the
        replay-honest column), wall-clock percentiles where the stage does
        real compute, the stage budget, and the over-budget count."""
        out: Dict[str, Dict] = {}
        for stage in STAGES:
            sim = self._stage_sim[stage]
            row: Dict[str, Any] = {"sim": sim.summary()}
            if stage in self._stage_wall and self._stage_wall[stage].served:
                row["wall"] = self._stage_wall[stage].summary()
            row["budget_us"] = self.stage_budgets_us.get(stage)
            row["over_budget"] = self._stage_over[stage]
            out[stage] = row
        return out

    def report(self) -> Dict[str, Any]:
        """Everything the overload acceptance criteria look at."""
        return {
            "stages": self.stage_report(),
            "keys": {k: c.as_dict() for k, c in self.counts.items()},
            "ladder": [{"key": pt.key,
                        "throughput_eps": pt.throughput_eps(self.clock_mhz),
                        "latency_us": pt.latency_us(self.clock_mhz),
                        "dsp": pt.dsp}
                       for pt in self.ladder],
            "rung": self.rung,
            "downgrades": self.downgrades,
            "recoveries": self.recoveries,
            "rerates": self.rerates,
            "capacity": self.capacity(),
            "clock_steps": self.clock_steps,
            "admission_rate_eps": self.admission_rate(),
            "in_flight": self.in_flight(),
            "deadline_us": self.deadline_s * 1e6,
        }


def format_stream_report(pipe: StreamingPipeline, *,
                         include_serve: bool = True) -> str:
    """Render the per-stage budget table + per-key accounting + ladder
    state, with the engine's measured-vs-analytical ``serve_report`` table
    beside it (the two reports share the schedule keys)."""
    from repro_torch.serving.engine import format_serve_report

    rep = pipe.report()
    lines = [f"stream: deadline {rep['deadline_us']:.2f}us, admission "
             f"{rep['admission_rate_eps']:.0f} eps, rung {rep['rung']}, "
             f"downgrades {rep['downgrades']}, recoveries "
             f"{rep['recoveries']}, clock steps {rep['clock_steps']}",
             "",
             f"{'stage':8s} {'events':>7s} {'sim p50':>10s} {'sim p99':>10s} "
             f"{'sim max':>10s} {'budget':>9s} {'over':>5s}"]
    for stage, row in rep["stages"].items():
        s = row["sim"]
        budget = row["budget_us"]
        lines.append(
            f"{stage:8s} {int(s['served']):7d} "
            f"{s['latency_p50_s'] * 1e6:8.2f}us "
            f"{s['latency_p99_s'] * 1e6:8.2f}us "
            f"{s['latency_max_s'] * 1e6:8.2f}us "
            f"{'' if budget is None else f'{budget:7.2f}us':>9s} "
            f"{row['over_budget']:5d}")
    lines += ["", f"{'schedule key':38s} {'subm':>6s} {'ans':>6s} "
                  f"{'shed':>6s} {'fail':>5s} {'adm/dl/qf':>11s} "
                  f"{'miss':>5s}"]
    for key, c in rep["keys"].items():
        lines.append(
            f"{key:38s} {c['submitted']:6d} {c['answered']:6d} "
            f"{c['shed']:6d} {c['failed']:5d} "
            f"{c['shed_admission']}/{c['shed_deadline']}"
            f"/{c['shed_queue_full']:>3d} {c['deadline_miss']:5d}")
    lines += ["", "ladder (rung: key, priced throughput, latency):"]
    for i, row in enumerate(rep["ladder"]):
        mark = " <- current" if i == rep["rung"] else ""
        lines.append(f"  [{i}] {row['key']:38s} "
                     f"{row['throughput_eps']:10.0f} eps "
                     f"{row['latency_us']:7.2f}us  dsp {row['dsp']}{mark}")
    if include_serve:
        lines += ["", format_serve_report(pipe.engine.serve_report(
            pipe.clock_mhz))]
    return "\n".join(lines)
