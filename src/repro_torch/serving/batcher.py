"""Schedule-keyed micro-batching request queues — the serving front end.

The paper's L1T scenario is a hard-real-time stream (one inference per
collision, 40 MHz); the coprocessor scenario (QuickDraw on Alveo) is a
batched service.  MicroBatcher implements the latter, generalized to the
multi-tenant case the scheduling layer creates: every kernel variant — a
(KernelSchedule, FixedPointConfig) pair — gets its OWN queue, keyed by the
stable ``schedule_key`` hash.  Requests for the same key stack into one
batch (they execute the same kernel); requests for different keys never
mix.  Each key has an independent ``max_batch`` / ``max_wait_s`` flush
policy, keys are drained fairly (round-robin), and per-key
latency/throughput counters feed the engine's ``serve_report``.

The module is the JAX package's batcher, kept as the port's own copy.

Ragged payloads (variable seq_len jet streams) within one queue are legal:
``run`` pads them to the per-batch max, hands the true lengths to the infer
function when it accepts a ``lengths`` keyword, and un-pads per-request
results shaped exactly like the padded payload (element-wise transforms).
"""

from __future__ import annotations

import inspect
import itertools
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.schedule import DEFAULT_SCHEDULE_KEY, schedule_key


def _now() -> float:
    """Monotonic clock for every arrival/done stamp.

    ``time.time()`` is wall-clock: an NTP step between submit and flush
    produced negative (or wildly wrong) latencies in KeyStats.  All batcher
    timing now uses ``time.perf_counter`` — the same clock domain the
    engines' steady-state measurements already use — and the ``now=``
    injection hooks stay, so tests drive a logical clock as before."""
    return time.perf_counter()


@dataclass
class Request:
    payload: Any
    arrival_s: float
    req_id: int
    key: str = DEFAULT_SCHEDULE_KEY
    schedule: Any = None               # Optional[KernelSchedule]
    fp: Any = None                     # Optional[FixedPointConfig]
    result: Any = None
    done_s: Optional[float] = None
    error: Optional[BaseException] = None   # the flush failure, attached —
                                            # a failed request is REPORTED,
                                            # never silently dropped

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s

    @property
    def status(self) -> str:
        """Exactly one of pending | answered | failed."""
        if self.error is not None:
            return "failed"
        return "pending" if self.done_s is None else "answered"


class QueueFullError(RuntimeError):
    """Explicit bounded-queue reject: the submitter is told, counted per
    key, and may shed / retry / downgrade — never a silent drop."""

    def __init__(self, key: str, bound: int):
        self.key = key
        self.bound = bound
        super().__init__(
            f"queue {key!r} is full ({bound} pending): the admission layer "
            f"must shed or downgrade instead of queueing unboundedly")


# percentile window: enough samples for stable p99, bounded memory for
# long-running engines (totals stay exact via the scalar counters)
_MAX_LATENCY_SAMPLES = 4096


@dataclass
class KeyStats:
    """Per-schedule-key serving counters (the measured column).

    ``served`` / ``latency_sum_s`` / ``latency_max_s`` are exact lifetime
    totals; ``latencies_s`` is a bounded window of the most recent samples,
    used only for the percentile columns.
    """

    served: int = 0
    batches: int = 0
    failed: int = 0                    # flush-fn exceptions, per request
    rejected: int = 0                  # bounded-queue explicit rejects
    latency_sum_s: float = 0.0
    latency_max_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)

    def record_one(self, latency_s: float) -> None:
        self.served += 1
        self.latency_sum_s += latency_s
        self.latency_max_s = max(self.latency_max_s, latency_s)
        self.latencies_s.append(latency_s)
        if len(self.latencies_s) > 2 * _MAX_LATENCY_SAMPLES:
            del self.latencies_s[:-_MAX_LATENCY_SAMPLES]

    def record(self, batch: List[Request]) -> None:
        self.batches += 1
        for r in batch:
            self.record_one(r.latency_s or 0.0)

    def record_failed(self, n: int) -> None:
        self.failed += n

    def record_rejected(self) -> None:
        self.rejected += 1

    def summary(self) -> Dict[str, float]:
        n = max(self.served, 1)
        lat = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        return {
            "served": float(self.served),
            "batches": float(self.batches),
            "failed": float(self.failed),
            "rejected": float(self.rejected),
            "mean_batch": float(self.served) / max(self.batches, 1),
            "latency_mean_s": self.latency_sum_s / n,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "latency_max_s": self.latency_max_s,
        }


def _pad_stack(payloads: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Stack payloads, padding axis 0 (time) to the per-batch max.

    Returns (stacked, lengths, ragged).  Equal-shape payloads take the
    plain ``np.stack`` path and report ragged=False.
    """
    arrs = [np.asarray(p) for p in payloads]
    dtypes = {a.dtype for a in arrs}
    if len(dtypes) != 1:
        # padding with arrs[0].dtype would silently down/up-cast the other
        # payloads; mixed-dtype requests cannot share a compiled trace
        # anyway, so this is a routing bug at the submitter — say so
        raise ValueError(
            f"mixed payload dtypes in one batch: {sorted(map(str, dtypes))} "
            f"— requests with different dtypes cannot share a trace; route "
            f"them to different schedule keys")
    lengths = np.asarray([a.shape[0] if a.ndim else 1 for a in arrs], np.int32)
    shapes = {a.shape for a in arrs}
    if len(shapes) == 1:
        return np.stack(arrs), lengths, False
    tails = {a.shape[1:] for a in arrs}
    if len(tails) != 1:
        raise ValueError(f"payloads differ beyond the sequence axis: {shapes}")
    t_max = int(lengths.max())
    out = np.zeros((len(arrs), t_max) + arrs[0].shape[1:], arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out, lengths, True


def _accepts_lengths(fn: Callable) -> bool:
    try:
        return "lengths" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@dataclass
class MicroBatcher:
    """Multi-queue batcher: one FIFO per schedule key, fair round-robin drain.

    ``max_batch`` / ``max_wait_s`` are the default flush policy; individual
    keys override via :meth:`set_policy`.  The single-queue API of the
    original batcher (submit/ready/drain/run with no key) still works — it
    operates on the ``default`` key, or on the fair-next key when several
    queues are live.
    """

    max_batch: int = 64
    max_wait_s: float = 0.002
    max_queue: Optional[int] = None    # default per-key pending bound;
                                       # None = unbounded
    _queues: Dict[str, List[Request]] = field(default_factory=dict)
    _policy: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    _bounds: Dict[str, Optional[int]] = field(default_factory=dict)
    _stats: Dict[str, KeyStats] = field(default_factory=dict)
    _ids: "itertools.count" = field(default_factory=itertools.count)
    _rr: int = 0                       # round-robin cursor over key order

    # -- policy / introspection ---------------------------------------------

    def set_policy(self, key: str, *, max_batch: Optional[int] = None,
                   max_wait_s: Optional[float] = None,
                   max_queue: Optional[int] = ...) -> None:  # type: ignore
        mb, mw = self.policy(key)
        self._policy[key] = (max_batch if max_batch is not None else mb,
                             max_wait_s if max_wait_s is not None else mw)
        if max_queue is not ...:       # ... = leave the bound untouched
            self._bounds[key] = max_queue

    def policy(self, key: str) -> Tuple[int, float]:
        return self._policy.get(key, (self.max_batch, self.max_wait_s))

    def queue_bound(self, key: str) -> Optional[int]:
        """Pending-request cap for one key (None = unbounded)."""
        return self._bounds.get(key, self.max_queue)

    def keys(self) -> List[str]:
        """Keys in first-seen order (the round-robin order)."""
        return list(self._queues)

    def pending(self, key: Optional[str] = None) -> int:
        if key is not None:
            return len(self._queues.get(key, ()))
        return sum(len(q) for q in self._queues.values())

    def key_stats(self, key: str) -> KeyStats:
        return self._stats.setdefault(key, KeyStats())

    @property
    def stats(self) -> Dict[str, KeyStats]:
        return self._stats

    # -- submission ----------------------------------------------------------

    def submit(self, payload: Any, now: Optional[float] = None,
               key: Optional[str] = None, schedule: Any = None,
               fp: Any = None) -> Request:
        """Enqueue one request.  The queue key is, in priority order: the
        explicit ``key``, ``schedule_key(schedule, fp)`` when either is
        given, else the default queue.

        A bounded queue (``max_queue`` / ``set_policy(max_queue=...)``) that
        is already full raises :class:`QueueFullError` — an EXPLICIT reject,
        counted in the key's stats, so overload backpressure reaches the
        submitter instead of growing the queue without limit."""
        if key is None:
            key = (schedule_key(schedule, fp)
                   if schedule is not None or fp is not None
                   else DEFAULT_SCHEDULE_KEY)
        bound = self.queue_bound(key)
        if bound is not None and len(self._queues.get(key, ())) >= bound:
            self.key_stats(key).record_rejected()
            raise QueueFullError(key, bound)
        r = Request(payload, _now() if now is None else now,
                    next(self._ids), key=key, schedule=schedule, fp=fp)
        self._queues.setdefault(key, []).append(r)
        return r

    # -- readiness -----------------------------------------------------------

    def ready_key(self, key: str, now: Optional[float] = None) -> bool:
        q = self._queues.get(key)
        if not q:
            return False
        mb, mw = self.policy(key)
        if len(q) >= mb:
            return True
        now = _now() if now is None else now
        return now - q[0].arrival_s >= mw

    def ready_keys(self, now: Optional[float] = None) -> List[str]:
        now = _now() if now is None else now
        return [k for k in self._queues if self.ready_key(k, now)]

    def ready(self, now: Optional[float] = None) -> bool:
        return bool(self.ready_keys(now))

    def _next_key(self, now: Optional[float], ready_only: bool
                  ) -> Optional[str]:
        """Fair key selection: scan keys round-robin from the cursor."""
        keys = self.keys()
        if not keys:
            return None
        n = len(keys)
        for off in range(n):
            k = keys[(self._rr + off) % n]
            if ready_only and not self.ready_key(k, now):
                continue
            if not ready_only and not self._queues.get(k):
                continue
            self._rr = (keys.index(k) + 1) % n
            return k
        return None

    # -- draining ------------------------------------------------------------

    def drain(self, key: Optional[str] = None) -> List[Request]:
        """Dequeue up to the key's max_batch requests (FIFO).  With no key,
        the fair-next non-empty queue is drained (ready or not — this is the
        shutdown / leftovers path)."""
        if key is None:
            key = self._next_key(None, ready_only=False)
            if key is None:
                return []
        q = self._queues.get(key, [])
        mb, _ = self.policy(key)
        batch, self._queues[key] = q[:mb], q[mb:]
        return batch

    def run(self, infer_fn: Callable, now: Optional[float] = None,
            key: Optional[str] = None, force: bool = False) -> List[Request]:
        """Flush ONE batch from one queue through infer_fn; stamps results,
        latencies, and per-key counters.

        With no ``key``, the fair-next ready queue flushes (round-robin
        across schedule keys).  ``force`` flushes even below the policy
        thresholds — the end-of-stream path.

        Ragged batches are zero-padded to the per-batch max sequence length.
        An infer function whose output depends on sequence length (any
        recurrent model) must accept a ``lengths`` keyword to see the true
        lengths — the engine's flush functions do; a plain function gets the
        padded batch (and a RuntimeWarning), and per-request results whose
        shape equals the padded payload shape are un-padded on the way out.

        An exception raised BY the infer function fails exactly this batch:
        every drained request comes back with the error attached
        (``status == "failed"``, counted in the key's stats) instead of the
        exception propagating with the batch lost — so one key's broken
        kernel can never drop another key's queued requests in
        :meth:`run_all`.  (Payload-shape errors from padding still raise:
        they are routing bugs at the submitter, and the existing contract.)
        """
        if key is None:
            key = self._next_key(now, ready_only=not force)
            if key is None:
                return []
        elif not force and not self.ready_key(key, now):
            return []
        batch = self.drain(key)
        if not batch:
            return []
        x, lengths, ragged = _pad_stack([r.payload for r in batch])
        try:
            if ragged and _accepts_lengths(infer_fn):
                out = np.asarray(infer_fn(x, lengths=lengths))
            else:
                if ragged:
                    warnings.warn(
                        "ragged batch padded for an infer function without a "
                        "'lengths' parameter: sequence-dependent models will "
                        "compute on the zero padding", RuntimeWarning,
                        stacklevel=2)
                out = np.asarray(infer_fn(x))
        except Exception as e:
            t = _now() if now is None else now
            for r in batch:
                r.error = e
                r.done_s = t
            self.key_stats(key).record_failed(len(batch))
            warnings.warn(
                f"flush of queue {key!r} failed ({type(e).__name__}: {e}); "
                f"{len(batch)} request(s) failed with the error attached, "
                f"other queues unaffected", RuntimeWarning, stacklevel=2)
            return batch
        t = _now() if now is None else now
        for i, r in enumerate(batch):
            res = out[i]
            # un-pad only outputs shaped exactly like the padded payload
            # (element-wise transforms); anything else is returned as-is
            if ragged and res.shape == x.shape[1:]:
                res = res[: lengths[i]]
            r.result = res
            r.done_s = t
        self.key_stats(key).record(batch)
        return batch

    def run_all(self, infer_for_key: Callable[[str], Callable],
                now: Optional[float] = None, force: bool = False
                ) -> List[Request]:
        """Flush every ready (or, with force, every non-empty) queue once
        round-robin until nothing is left to flush.  ``infer_for_key`` maps a
        schedule key to that key's compiled infer function."""
        done: List[Request] = []
        while True:
            key = self._next_key(now, ready_only=not force)
            if key is None:
                return done
            done.extend(self.run(infer_for_key(key), now=now, key=key,
                                 force=force))
