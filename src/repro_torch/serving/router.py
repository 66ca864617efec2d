"""Schedule-hash-aware router: health checks, retry/hedge/failover, and
exactly-once accounting over a :class:`~repro_torch.serving.replica.ReplicaPool`.

The paper's designs run inside trigger farms where throughput comes from
many identical boards behind a dispatcher and the system must keep
answering when one of them stalls or dies.  This module is that dispatcher:

  * **Placement** — requests land on a replica by consistent hash of their
    ``schedule_key`` (a hash ring with virtual nodes): same key, same
    replica — the co-batching/executor-residency locality the schedule-keyed
    engines are built on — and when a replica dies its keys re-place to
    the next ring node while every other key stays put.
  * **Health** — per-replica sliding-window error rate + consecutive-
    failure streak + latency EWMA; heartbeat probes re-admit a retired
    replica after ``probe_successes`` consecutive successes.
  * **The robustness ladder** — per-request timeout (a straggler's answer
    is discarded, never surfaced) -> retry with exponential backoff +
    deterministic jitter on a DIFFERENT replica -> optional hedged
    duplicate for tail latency (first answer wins, the loser is cancelled
    and de-duplicated by request id) -> mark-unhealthy + drain + re-place
    keys -> re-admit after probe successes.
  * **Exactly-once accounting** — every submitted request reaches exactly
    one terminal state (``answered | failed | shed``) across any
    interleaving of crashes, retries and hedges;
    :meth:`Router.verify_router_accounting` asserts the exact sum
    ``submitted == answered + failed + shed + in_flight`` per key, that
    the counters agree with the request objects themselves, that hedges
    reconcile (``hedges == hedge_wins + hedge_cancelled``) and that an
    answered request surfaced exactly ONE result.

Outputs stay bit-identical to a single-replica engine for every surviving
request: replicas are identically configured engines over the same params,
and the serving call is the conformance-enforced batch-1 fast path — which
replica answers never changes WHAT is answered.

Two clock domains, as in :mod:`~repro_torch.serving.streaming`: real inference
executes on the host, while service times (and injected straggler stalls)
live in the simulated clock — timeouts, hedges and the per-replica
occupancy model are projections over analytical service times, so a chaos
replay over a :class:`~repro_torch.serving.faults.VirtualClock` is exactly
reproducible.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import FixedPointConfig
from repro_torch.core.hls import estimate_schedule
from repro_torch.kernels.schedule import KernelSchedule, schedule_key
from repro_torch.serving.engine import EngineClosedError, RNNServingEngine
from repro_torch.serving.replica import EngineReplica, ReplicaPool

#: request terminal states (pending is the only transient one)
TERMINAL_STATES = ("answered", "failed", "shed")

#: attempt outcomes; "cancelled" marks a hedged duplicate whose (identical)
#: answer was discarded during de-duplication
ATTEMPT_OUTCOMES = ("ok", "error", "timeout", "cancelled")


class ReplicaTimeout(RuntimeError):
    """An attempt whose simulated service exceeded the per-request timeout;
    its answer (if any) is discarded and the request retried elsewhere."""


def _stable_hash(s: str) -> int:
    """Platform/process-stable 64-bit hash (Python's ``hash`` is salted;
    placement must not move between runs)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hash ring with virtual nodes.

    ``ordered(key)`` returns every replica id exactly once, in ring order
    starting from the key's position — index 0 is the primary placement,
    the rest are the failover order.  Removing a node (skipping it while
    walking) re-places only the keys that mapped to it; every other key's
    placement is untouched — the property that makes failover cheap for
    schedule-keyed executor/residency state.
    """

    def __init__(self, ids: Sequence[str], vnodes: int = 32):
        if not ids:
            raise ValueError("hash ring needs at least one node")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1: {vnodes}")
        self.vnodes = vnodes
        pts = []
        for rid in ids:
            for v in range(vnodes):
                pts.append((_stable_hash(f"{rid}#{v}"), rid))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._ids = [rid for _, rid in pts]

    def ordered(self, key: str) -> List[str]:
        start = bisect.bisect_left(self._points, _stable_hash(key))
        seen: List[str] = []
        n = len(self._ids)
        for off in range(n):
            rid = self._ids[(start + off) % n]
            if rid not in seen:
                seen.append(rid)
        return seen


@dataclass(frozen=True)
class RouterPolicy:
    """Every knob of the robustness ladder, in one frozen record.

    timeout_s            per-attempt budget in the SIMULATED clock domain:
                         an attempt whose (analytical + injected-stall)
                         service exceeds it is a timeout — answer
                         discarded, retried elsewhere
    max_retries          extra attempts after the primary (each on a
                         different replica while one is available)
    backoff_base_s       first retry delay; grows by ``backoff_mult`` per
                         attempt, +/- ``jitter`` fraction (seeded PRNG —
                         deterministic replay)
    hedge_after_s        None = hedging off; else a successful primary
                         slower than this fires ONE duplicate on another
                         replica — first answer wins, loser cancelled
    detect_s             how long a crashed call takes to detect (refused
                         connection ~ 0; timeouts detect at ``timeout_s``)
    window               sliding-window size for the error-rate score
    min_window           samples required before the rate can retire
    max_error_rate       window error rate beyond which a replica retires
    consecutive_failures retire immediately after this many in a row
    probe_successes      consecutive heartbeat OKs to re-admit
    probe_interval_s     simulated seconds between automatic probe sweeps
    vnodes               virtual nodes per replica on the hash ring
    seed                 jitter PRNG seed
    """

    timeout_s: float = 0.050
    max_retries: int = 2
    backoff_base_s: float = 1e-4
    backoff_mult: float = 2.0
    jitter: float = 0.25
    hedge_after_s: Optional[float] = None
    detect_s: float = 0.0
    window: int = 32
    min_window: int = 4
    max_error_rate: float = 0.5
    consecutive_failures: int = 3
    probe_successes: int = 2
    probe_interval_s: float = 0.010
    vnodes: int = 32
    seed: int = 0

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0: {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"jitter must be in [0, 1): {self.jitter}")
        if self.consecutive_failures < 1:
            raise ValueError("consecutive_failures must be >= 1")
        if self.probe_successes < 1:
            raise ValueError("probe_successes must be >= 1")
        if not 0 < self.max_error_rate <= 1:
            raise ValueError(
                f"max_error_rate must be in (0, 1]: {self.max_error_rate}")


@dataclass
class Attempt:
    """One try of one request on one replica (primary, retry, or hedge)."""

    replica_id: str
    kind: str                      # primary | retry | hedge
    t_start_s: float
    service_s: float = 0.0         # simulated service incl. injected stall
    done_s: float = 0.0            # completion (ok) or detection (error)
    outcome: str = "ok"
    error: Optional[BaseException] = None
    result: Any = None             # surfaced only on the winning attempt


@dataclass
class RoutedRequest:
    """One request moving through the router; ends in exactly one of
    ``answered | failed | shed`` (``attempts`` is the full audit trail —
    every replica it touched, every timeout, the cancelled hedge loser)."""

    payload: Any
    req_id: int
    key: str
    schedule: Optional[KernelSchedule]
    fp: Optional[FixedPointConfig]
    arrival_s: float
    status: str = "pending"
    result: Any = None
    error: Optional[BaseException] = None
    shed_reason: Optional[str] = None
    done_s: Optional[float] = None
    winner: Optional[str] = None   # replica id that answered
    hedged: bool = False
    attempts: List[Attempt] = field(default_factory=list)

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s

    @property
    def retries(self) -> int:
        return sum(1 for a in self.attempts if a.kind == "retry")


@dataclass
class RouterCounts:
    """Per-schedule-key exact-sum counters (the accounting invariant)."""

    submitted: int = 0
    answered: int = 0
    failed: int = 0
    shed: int = 0
    retries: int = 0
    timeouts: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    hedge_cancelled: int = 0
    duplicates: int = 0            # discarded duplicate OK answers
    re_placements: int = 0         # primary placement moved (failover)

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in (
            "submitted", "answered", "failed", "shed", "retries", "timeouts",
            "hedges", "hedge_wins", "hedge_cancelled", "duplicates",
            "re_placements")}


@dataclass
class ReplicaHealth:
    """Sliding-window health state the router keeps per replica."""

    window: Deque[bool] = field(default_factory=lambda: deque(maxlen=32))
    healthy: bool = True
    consecutive_errors: int = 0
    probe_oks: int = 0
    latency_ewma_s: Optional[float] = None
    retired: int = 0               # times marked unhealthy
    readmitted: int = 0

    def record(self, ok: bool, latency_s: Optional[float] = None) -> None:
        self.window.append(ok)
        if ok:
            self.consecutive_errors = 0
            if latency_s is not None:
                self.latency_ewma_s = (
                    latency_s if self.latency_ewma_s is None
                    else 0.7 * self.latency_ewma_s + 0.3 * latency_s)
        else:
            self.consecutive_errors += 1

    def error_rate(self) -> float:
        if not self.window:
            return 0.0
        return 1.0 - sum(self.window) / len(self.window)

    def report_row(self) -> Dict:
        return {"healthy": self.healthy,
                "error_rate": self.error_rate(),
                "consecutive_errors": self.consecutive_errors,
                "latency_ewma_s": self.latency_ewma_s,
                "window": len(self.window),
                "probe_oks": self.probe_oks,
                "retired": self.retired,
                "readmitted": self.readmitted}


class Router:
    """The dispatcher over a :class:`ReplicaPool` — see the module doc.

    ``submit(x, schedule=..., now=...)`` runs one request through the full
    ladder synchronously and returns it in a terminal state;
    ``submit(..., defer=True)`` queues it (``in_flight``) for a later
    :meth:`flush` — the window in which a replica can die with requests
    pending, which the chaos suite exploits.  All timing accepts an
    explicit ``now`` (simulated seconds) for deterministic replay.
    """

    def __init__(self, pool: ReplicaPool, *,
                 policy: Optional[RouterPolicy] = None,
                 clock=None, clock_mhz: float = 200.0):
        self.pool = pool
        self.policy = policy if policy is not None else RouterPolicy()
        self.clock_mhz = clock_mhz
        self._clock = clock if clock is not None else time.perf_counter
        self._rng = random.Random(self.policy.seed)
        self._ring = HashRing(pool.ids(), vnodes=self.policy.vnodes)
        self._health: Dict[str, ReplicaHealth] = {
            rid: ReplicaHealth(window=deque(maxlen=self.policy.window))
            for rid in pool.ids()}
        self._server_free: Dict[str, float] = {rid: float("-inf")
                                               for rid in pool.ids()}
        self._placements: Dict[str, str] = {}     # key -> last primary id
        self._service_cache: Dict[str, Tuple[float, float]] = {}
        self._ids = itertools.count()
        self._last_now = float("-inf")
        self._last_probe_s = float("-inf")
        self._pending: List[RoutedRequest] = []
        self._requests: List[RoutedRequest] = []
        self.counts: Dict[str, RouterCounts] = {}
        self.events: List[str] = []               # retire/readmit audit log
        self._closed = False

    # -- clocks & pricing ----------------------------------------------------

    def _now(self, now: Optional[float] = None) -> float:
        t = self._clock() if now is None else now
        if t < self._last_now:
            t = self._last_now
        self._last_now = t
        return t

    def _price(self, key: str, schedule: KernelSchedule,
               fp: Optional[FixedPointConfig]) -> Tuple[float, float]:
        """(service_s, occupancy_s) of one event under this key's schedule
        — the analytical clock domain, memoized per key."""
        pair = self._service_cache.get(key)
        if pair is None:
            est = estimate_schedule(schedule, self.reference_engine.cfg.rnn,
                                    fp)
            pair = (est.service_s(self.clock_mhz), est.ii_s(self.clock_mhz))
            self._service_cache[key] = pair
        return pair

    @property
    def reference_engine(self) -> RNNServingEngine:
        return self.pool.reference.engine

    # -- health & placement --------------------------------------------------

    def healthy_ids(self) -> List[str]:
        return [rid for rid in self.pool.ids() if self._health[rid].healthy]

    def healthy_count(self) -> int:
        return len(self.healthy_ids())

    def place(self, key: str, exclude: Sequence[str] = ()
              ) -> Optional[EngineReplica]:
        """The first healthy, non-excluded replica in the key's ring
        order; None when nothing qualifies."""
        for rid in self._ring.ordered(key):
            if rid in exclude or not self._health[rid].healthy:
                continue
            return self.pool.get(rid)
        return None

    def _note_primary_placement(self, key: str, rid: str) -> None:
        prev = self._placements.get(key)
        if prev is not None and prev != rid:
            self._count(key).re_placements += 1
        self._placements[key] = rid

    def _retire(self, rep: EngineReplica) -> None:
        """Mark unhealthy, quiesce (drain — every queued request on that
        engine reaches a terminal state), and let the ring re-place its
        keys.  The replica stays OPEN: a later probe streak re-admits it."""
        h = self._health[rep.replica_id]
        if not h.healthy:
            return
        h.healthy = False
        h.probe_oks = 0
        h.retired += 1
        self.events.append(f"retire:{rep.replica_id}")
        rep.drain()

    def _note_outcome(self, rep: EngineReplica, ok: bool,
                      latency_s: Optional[float] = None) -> None:
        h = self._health[rep.replica_id]
        h.record(ok, latency_s)
        if ok:
            return
        if (h.consecutive_errors >= self.policy.consecutive_failures
                or (len(h.window) >= self.policy.min_window
                    and h.error_rate() > self.policy.max_error_rate)):
            self._retire(rep)

    def probe(self, now: Optional[float] = None) -> Dict[str, bool]:
        """Heartbeat every UNHEALTHY replica once; ``probe_successes``
        consecutive OKs re-admit it to the ring (keys flow back via
        consistent hashing — no state to rebuild, the shared compile
        cache keeps it zero-warmup)."""
        t = self._now(now)
        self._last_probe_s = t
        out: Dict[str, bool] = {}
        for rep in self.pool:
            h = self._health[rep.replica_id]
            if h.healthy:
                continue
            try:
                stall = rep.heartbeat()
                ok = stall <= self.policy.timeout_s
            except Exception:
                ok = False
            out[rep.replica_id] = ok
            if not ok:
                h.probe_oks = 0
                continue
            h.probe_oks += 1
            if h.probe_oks >= self.policy.probe_successes:
                h.healthy = True
                h.probe_oks = 0
                h.consecutive_errors = 0
                h.window.clear()
                h.readmitted += 1
                self.events.append(f"readmit:{rep.replica_id}")
        return out

    def _maybe_probe(self, t: float) -> None:
        if t - self._last_probe_s >= self.policy.probe_interval_s:
            self.probe(now=t)

    # -- accounting ----------------------------------------------------------

    def _count(self, key: str) -> RouterCounts:
        return self.counts.setdefault(key, RouterCounts())

    def in_flight(self, key: Optional[str] = None) -> int:
        if key is None:
            return len(self._pending)
        return sum(1 for r in self._pending if r.key == key)

    def _answer(self, r: RoutedRequest, att: Attempt) -> None:
        if r.status != "pending":       # de-dup by request id: first wins
            self._count(r.key).duplicates += 1
            att.result = None
            att.outcome = "cancelled"
            return
        r.status = "answered"
        r.result = att.result
        r.winner = att.replica_id
        r.done_s = att.done_s
        self._count(r.key).answered += 1

    def _fail(self, r: RoutedRequest, e: BaseException, t: float) -> None:
        r.status = "failed"
        r.error = e
        r.done_s = t
        self._count(r.key).failed += 1

    def _shed(self, r: RoutedRequest, reason: str, t: float) -> None:
        r.status = "shed"
        r.shed_reason = reason
        r.done_s = t
        self._count(r.key).shed += 1

    # -- the attempt (one try on one replica) --------------------------------

    def _attempt(self, rep: EngineReplica, r: RoutedRequest,
                 t_queue: float, kind: str) -> Attempt:
        start = max(t_queue, self._server_free[rep.replica_id])
        att = Attempt(replica_id=rep.replica_id, kind=kind, t_start_s=start)
        r.attempts.append(att)
        try:
            out, stall = rep.predict(r.payload, schedule=r.schedule, fp=r.fp)
        except Exception as e:
            # crash-grade failure: detected ~immediately (refused call),
            # no server time occupied — the board is gone, not busy
            att.outcome = "error"
            att.error = e
            att.done_s = start + self.policy.detect_s
            self._note_outcome(rep, False)
            return att
        service, occupancy = self._price(r.key, *self._spec_of(r))
        att.service_s = service + stall
        self._server_free[rep.replica_id] = start + occupancy + stall
        if att.service_s > self.policy.timeout_s:
            # the answer exists but arrived past the budget: discard it —
            # surfacing it AND the retry's answer would double-answer
            att.outcome = "timeout"
            att.error = ReplicaTimeout(
                f"attempt on {rep.replica_id!r} took "
                f"{att.service_s * 1e6:.1f}us > timeout "
                f"{self.policy.timeout_s * 1e6:.1f}us")
            att.done_s = start + self.policy.timeout_s
            self._count(r.key).timeouts += 1
            self._note_outcome(rep, False)
        else:
            att.outcome = "ok"
            att.result = out
            att.done_s = start + att.service_s
            self._note_outcome(rep, True, att.service_s)
        return att

    def _spec_of(self, r: RoutedRequest
                 ) -> Tuple[KernelSchedule, Optional[FixedPointConfig]]:
        return self.reference_engine.resolve(r.schedule, r.fp)

    # -- the ladder (timeout -> retry -> hedge -> failover) ------------------

    def _serve_one(self, r: RoutedRequest, t: float) -> None:
        tried: List[str] = []
        t_cursor = t
        last_err: Optional[BaseException] = None
        for i in range(self.policy.max_retries + 1):
            rep = self.place(r.key, exclude=tried)
            if rep is None:
                # every untried replica is down; fall back to retrying an
                # already-tried one (it may have recovered) before giving up
                rep = self.place(r.key)
            if rep is None:
                self._shed(r, "no_healthy_replica", t_cursor)
                return
            if i == 0:
                self._note_primary_placement(r.key, rep.replica_id)
            else:
                self._count(r.key).retries += 1
            att = self._attempt(rep, r, t_cursor, "primary" if i == 0
                                else "retry")
            if att.outcome == "ok":
                win = self._maybe_hedge(r, att, tried)
                self._answer(r, win)
                return
            last_err = att.error
            tried.append(rep.replica_id)
            backoff = (self.policy.backoff_base_s
                       * self.policy.backoff_mult ** i)
            backoff *= 1.0 + self.policy.jitter * (2 * self._rng.random() - 1)
            t_cursor = att.done_s + backoff
        self._fail(r, last_err if last_err is not None else RuntimeError(
            "all attempts failed"), t_cursor)

    def _maybe_hedge(self, r: RoutedRequest, att: Attempt,
                     tried: List[str]) -> Attempt:
        """A successful-but-slow primary fires one duplicate on a different
        replica; the earlier simulated completion wins, the loser is
        cancelled and its (identical) answer discarded — de-duplicated by
        request id, counted in ``duplicates``."""
        p = self.policy
        if p.hedge_after_s is None or att.service_s <= p.hedge_after_s:
            return att
        other = self.place(r.key, exclude=list(tried) + [att.replica_id])
        if other is None:
            return att
        c = self._count(r.key)
        c.hedges += 1
        r.hedged = True
        hatt = self._attempt(other, r, att.t_start_s + p.hedge_after_s,
                             "hedge")
        if hatt.outcome == "ok" and hatt.done_s < att.done_s:
            c.hedge_wins += 1
            c.duplicates += 1
            att.outcome = "cancelled"
            att.result = None
            return hatt
        c.hedge_cancelled += 1
        if hatt.outcome == "ok":
            c.duplicates += 1
            hatt.outcome = "cancelled"
            hatt.result = None
        return att

    # -- the serving surface -------------------------------------------------

    def submit(self, x: np.ndarray,
               schedule: Optional[KernelSchedule] = None,
               fp: Optional[FixedPointConfig] = None,
               now: Optional[float] = None,
               defer: bool = False) -> RoutedRequest:
        """Route one request.  Immediate mode (default) runs the full
        ladder and returns the request in a terminal state; ``defer=True``
        leaves it pending (``in_flight``) until :meth:`flush`."""
        if self._closed:
            raise EngineClosedError("Router")
        t = self._now(now)
        self._maybe_probe(t)
        sched, fpr = self.reference_engine.resolve(schedule, fp)
        key = schedule_key(sched, fpr)
        r = RoutedRequest(payload=x, req_id=next(self._ids), key=key,
                          schedule=sched, fp=fpr, arrival_s=t)
        self._requests.append(r)
        self._count(key).submitted += 1
        if defer:
            self._pending.append(r)
            return r
        self._serve_one(r, t)
        return r

    def flush(self, now: Optional[float] = None) -> List[RoutedRequest]:
        """Serve every deferred request (FIFO).  Replicas that died since
        ``submit`` are simply failed over — the pending window is exactly
        where the chaos suite kills them."""
        t = self._now(now)
        batch, self._pending = self._pending, []
        for r in batch:
            self._serve_one(r, max(t, r.arrival_s))
        return batch

    def serve(self, payloads, schedules=None, fps=None,
              now: Optional[float] = None) -> List[RoutedRequest]:
        """Convenience: submit a stream (parallel lists) immediately."""
        n = len(payloads)
        schedules = schedules if schedules is not None else [None] * n
        fps = fps if fps is not None else [None] * n
        return [self.submit(x, schedule=s, fp=f, now=now)
                for x, s, f in zip(payloads, schedules, fps)]

    # -- lifecycle -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self, now: Optional[float] = None) -> List[RoutedRequest]:
        """Flush deferred requests and quiesce every replica engine."""
        done = self.flush(now=now)
        self.pool.drain_all()
        return done

    def close(self, now: Optional[float] = None) -> List[RoutedRequest]:
        """Drain, close every replica, refuse new submits.  Idempotent."""
        if self._closed:
            return []
        done = self.drain(now=now)
        self.pool.close_all()
        self._closed = True
        return done

    # -- invariants & reporting ----------------------------------------------

    def verify_router_accounting(self) -> Dict[str, Dict[str, int]]:
        """Assert the exact-sum invariant per key AND that the counters
        agree with the request objects: ``submitted == answered + failed +
        shed + in_flight``; terminal states are exclusive; an answered
        request surfaced exactly one result (hedged duplicates cancelled
        and counted); hedges reconcile.  Raises ``AssertionError`` naming
        the broken key; returns the per-key counters on success."""
        by_key: Dict[str, Dict[str, int]] = {}
        for r in self._requests:
            d = by_key.setdefault(r.key, {"answered": 0, "failed": 0,
                                          "shed": 0, "pending": 0})
            d[r.status if r.status in TERMINAL_STATES else "pending"] += 1
            ok_surfaced = sum(1 for a in r.attempts if a.outcome == "ok")
            want = 1 if r.status == "answered" else 0
            if ok_surfaced != want:
                raise AssertionError(
                    f"request {r.req_id} ({r.status}) surfaced "
                    f"{ok_surfaced} results, expected {want} — duplicate "
                    f"or lost answer")
            if r.status == "answered" and (r.result is None
                                           or r.error is not None):
                raise AssertionError(
                    f"request {r.req_id} answered without a clean result")
            if r.status == "failed" and r.error is None:
                raise AssertionError(
                    f"request {r.req_id} failed without an error attached")
            if r.status == "shed" and r.shed_reason is None:
                raise AssertionError(
                    f"request {r.req_id} shed without a reason")
        out: Dict[str, Dict[str, int]] = {}
        for key, c in self.counts.items():
            infl = self.in_flight(key)
            accounted = c.answered + c.failed + c.shed + infl
            if accounted != c.submitted:
                raise AssertionError(
                    f"router accounting broken for {key!r}: submitted="
                    f"{c.submitted} but answered={c.answered} + failed="
                    f"{c.failed} + shed={c.shed} + in_flight={infl} = "
                    f"{accounted}")
            obj = by_key.get(key, {"answered": 0, "failed": 0, "shed": 0,
                                   "pending": 0})
            for st in ("answered", "failed", "shed"):
                if obj[st] != getattr(c, st):
                    raise AssertionError(
                        f"counter/object disagreement for {key!r}: "
                        f"{st} counter={getattr(c, st)} but "
                        f"{obj[st]} request objects")
            if obj["pending"] != infl:
                raise AssertionError(
                    f"in_flight disagreement for {key!r}: {infl} pending "
                    f"in the queue, {obj['pending']} request objects")
            if c.hedges != c.hedge_wins + c.hedge_cancelled:
                raise AssertionError(
                    f"hedge reconciliation broken for {key!r}: hedges="
                    f"{c.hedges} != wins={c.hedge_wins} + cancelled="
                    f"{c.hedge_cancelled}")
            out[key] = {**c.as_dict(), "in_flight": infl}
        return out

    def router_report(self) -> Dict[str, Dict]:
        """Per-replica health + serving rows (each replica's own
        ``serve_report`` aggregated underneath) and per-key routing
        counters with current placement — the farm-level two-column
        table."""
        replicas: Dict[str, Dict] = {}
        for rep in self.pool:
            row = {**rep.report_row(),
                   **self._health[rep.replica_id].report_row()}
            served = 0.0
            for key, srow in rep.engine.serve_report(self.clock_mhz).items():
                served += srow["measured"]["served"]
                fast = srow.get("fast_path")
                if fast is not None:
                    served += fast["served"]
            row["engine_served"] = served
            replicas[rep.replica_id] = row
        keys = {key: {**c.as_dict(), "in_flight": self.in_flight(key),
                      "placement": self._placements.get(key)}
                for key, c in self.counts.items()}
        return {"replicas": replicas, "keys": keys,
                "pool": {"n": len(self.pool),
                         "healthy": self.healthy_count(),
                         "events": list(self.events)}}


def format_router_report(router: Router) -> str:
    """Render router_report() as the per-replica / per-key tables."""
    rep = router.router_report()
    lines = [f"router: {rep['pool']['healthy']}/{rep['pool']['n']} healthy, "
             f"events: {', '.join(rep['pool']['events']) or 'none'}",
             "",
             f"{'replica':10s} {'ok':>3s} {'calls':>6s} {'errs':>5s} "
             f"{'err%':>5s} {'ewma':>9s} {'ret/adm':>7s}"]
    for rid, row in rep["replicas"].items():
        ewma = row["latency_ewma_s"]
        lines.append(
            f"{rid:10s} {'y' if row['healthy'] else 'N':>3s} "
            f"{row['calls']:6d} {row['errors']:5d} "
            f"{row['error_rate']:4.0%} "
            f"{'' if ewma is None else f'{ewma * 1e6:7.2f}us':>9s} "
            f"{row['retired']}/{row['readmitted']:>3d}")
    lines += ["", f"{'schedule key':38s} {'subm':>5s} {'ans':>5s} "
                  f"{'fail':>4s} {'shed':>4s} {'rtry':>4s} {'hdg':>4s} "
                  f"{'dup':>4s} {'repl':>4s} {'at':>4s}"]
    for key, c in rep["keys"].items():
        lines.append(
            f"{key:38s} {c['submitted']:5d} {c['answered']:5d} "
            f"{c['failed']:4d} {c['shed']:4d} {c['retries']:4d} "
            f"{c['hedges']:4d} {c['duplicates']:4d} "
            f"{c['re_placements']:4d} {str(c['placement']):>4s}")
    return "\n".join(lines)
