"""Fault-injection harness for the streaming pipeline — chaos, on purpose.

A hard-real-time trigger path is judged by how it fails, not how it runs:
when a stage hiccups, a kernel throws, a cache entry rots, or the clock
steps backwards, the pipeline must degrade predictably — shed, downgrade,
or fail THAT request with the error attached — never deadlock, never lose a
request silently, never corrupt another tenant's results.  This module
provides the controlled faults the chaos test suite drives through
:class:`~repro_torch.serving.streaming.StreamingPipeline`:

  * :class:`FaultInjector` — armable per-stage *stalls* (extra seconds
    charged at a stage boundary, visible to the deadline projections) and
    *failures* (exceptions raised inside a stage, caught per request);
  * :func:`break_engine_key` — replaces ONE schedule key's compiled infer
    fn with one that raises N times then recovers: the flush-exception
    fault the batcher's per-key isolation must contain;
  * :func:`corrupt_cache_entries` — truncates/garbles persistent compile
    cache entries on disk: the quarantine path's trigger;
  * :class:`VirtualClock` — a drivable clock for deterministic replay,
    with :meth:`VirtualClock.step_back` as the misbehaving-clock fault
    (the pipeline's monotonic clamp must absorb it);
  * **replica-grade faults** for the replicated-serving router
    (:mod:`repro_torch.serving.router`): :func:`crash_replica` (every call on
    that replica raises — the dead-board fault), :func:`slow_replica`
    (injected per-call stall, the straggler fault the timeout/hedge
    machinery must beat) and :func:`flapping` (alternating healthy /
    unhealthy calls — the worst case for health scoring, which must not
    thrash the ring on every blip).  All three arm a
    :class:`ReplicaFaultSet` with the same ``after``/``times`` counters
    and ``fired`` audit log as the stage faults.

Faults are one-shot by default (``times=1``) and consumed in arm order, so
a chaos scenario reads as a script: arm, run, assert the degradation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from repro_torch.serving.compile_cache import CACHE_SUFFIX


class InjectedFault(RuntimeError):
    """The exception a ``fail`` arm raises inside a pipeline stage."""


@dataclass
class _Arm:
    kind: str                   # "stall" | "fail"
    stage: str
    seconds: float = 0.0        # stall only
    exc: Optional[BaseException] = None   # fail only
    after: int = 0              # skip this many matching checks first
    remaining: int = 1          # then fire this many times


@dataclass
class FaultInjector:
    """Scriptable per-stage faults; a default (empty) injector is inert.

    ``stall(stage, seconds)`` charges extra seconds at that stage boundary
    — in a replay the stall lands in the simulated clock domain, so
    deadline projections and the per-stage budget report see it honestly.
    ``fail(stage)`` raises :class:`InjectedFault` (or a supplied exception)
    when the pipeline enters that stage; the pipeline converts it into a
    per-request failure with the error attached.
    """

    _arms: List[_Arm] = field(default_factory=list)
    fired: List[str] = field(default_factory=list)   # audit log

    # -- arming --------------------------------------------------------------

    def stall(self, stage: str, seconds: float, *, times: int = 1,
              after: int = 0) -> "FaultInjector":
        if seconds < 0:
            raise ValueError(f"stall seconds must be >= 0: {seconds}")
        self._arms.append(_Arm("stall", stage, seconds=seconds,
                               after=after, remaining=times))
        return self

    def fail(self, stage: str, exc: Optional[BaseException] = None, *,
             times: int = 1, after: int = 0) -> "FaultInjector":
        self._arms.append(_Arm("fail", stage, exc=exc, after=after,
                               remaining=times))
        return self

    # -- consumption (the pipeline calls these at stage boundaries) ----------

    def _take(self, kind: str, stage: str) -> Optional[_Arm]:
        for arm in self._arms:
            if arm.kind != kind or arm.stage != stage or arm.remaining <= 0:
                continue
            if arm.after > 0:
                arm.after -= 1
                continue
            arm.remaining -= 1
            self.fired.append(f"{kind}:{stage}")
            return arm
        return None

    def stall_s(self, stage: str) -> float:
        """Seconds of injected stall at this stage boundary (0.0 = none)."""
        arm = self._take("stall", stage)
        return arm.seconds if arm is not None else 0.0

    def check(self, stage: str) -> None:
        """Raise the armed failure for this stage, if any."""
        arm = self._take("fail", stage)
        if arm is not None:
            raise arm.exc if arm.exc is not None else InjectedFault(
                f"injected fault at stage {stage!r}")

    def armed(self) -> int:
        """Arms that have not fully fired yet."""
        return sum(1 for a in self._arms if a.remaining > 0)


# ---------------------------------------------------------------------------
# Replica-level faults (the router's chaos surface)
# ---------------------------------------------------------------------------


class ReplicaCrashed(RuntimeError):
    """The exception a crashed (or flapping-down) replica raises on every
    call — predict AND heartbeat, so health probes see the crash too."""


@dataclass
class _ReplicaArm:
    kind: str                   # "crash" | "stall" | "flap"
    seconds: float = 0.0        # stall only
    after: int = 0              # skip this many calls before arming
    remaining: Optional[int] = None   # fired-call budget; None = forever
    period: int = 1             # flap only: calls per healthy/unhealthy phase
    calls: int = 0              # flap phase counter (post-``after`` calls)

    @property
    def live(self) -> bool:
        return self.remaining is None or self.remaining > 0


@dataclass
class ReplicaFaultSet:
    """Armable per-replica faults, consumed on every replica call.

    The router talks to a replica only through calls (predict, heartbeat);
    a replica fault is therefore a per-call transformation: raise
    (:class:`ReplicaCrashed`) or stall (seconds added to the call's
    simulated service time).  Arms carry the same ``after``/``times``
    counters as :class:`FaultInjector` and every firing lands in the
    ``fired`` audit log as ``"<kind>:<replica_id>"``.
    """

    replica_id: str = "?"
    _arms: List[_ReplicaArm] = field(default_factory=list)
    fired: List[str] = field(default_factory=list)

    def on_call(self) -> float:
        """Consume one call: returns the injected stall seconds and/or
        raises :class:`ReplicaCrashed`.  Stalls accumulate across arms;
        the first crash-grade arm to fire raises (after charging any
        stall already accumulated is pointless — the caller sees the
        exception, not the duration)."""
        stall = 0.0
        for arm in self._arms:
            if not arm.live:
                continue
            if arm.after > 0:
                arm.after -= 1
                continue
            if arm.kind == "stall":
                if arm.remaining is not None:
                    arm.remaining -= 1
                stall += arm.seconds
                self.fired.append(f"stall:{self.replica_id}")
            elif arm.kind == "crash":
                if arm.remaining is not None:
                    arm.remaining -= 1
                self.fired.append(f"crash:{self.replica_id}")
                raise ReplicaCrashed(
                    f"replica {self.replica_id!r} crashed (injected)")
            elif arm.kind == "flap":
                phase = arm.calls
                arm.calls += 1
                # phases of ``period`` calls: healthy first, then down, ...
                if (phase // arm.period) % 2 == 1:
                    if arm.remaining is not None:
                        arm.remaining -= 1
                    self.fired.append(f"flap:{self.replica_id}")
                    raise ReplicaCrashed(
                        f"replica {self.replica_id!r} is flapping "
                        f"(down phase, injected)")
        return stall

    def armed(self) -> int:
        return sum(1 for a in self._arms if a.live)

    def clear(self) -> None:
        """Heal the replica: drop every arm (the repair-crew hook the
        re-admission tests use)."""
        self._arms.clear()


def _replica_faults(replica) -> ReplicaFaultSet:
    fs = getattr(replica, "faults", None)
    if not isinstance(fs, ReplicaFaultSet):
        raise TypeError(
            f"{replica!r} has no ReplicaFaultSet — replica faults arm an "
            f"EngineReplica (repro.serving.replica), not a bare engine")
    return fs


def crash_replica(replica, *, after: int = 0,
                  times: Optional[int] = None) -> _ReplicaArm:
    """Arm a crash: every call (predict and heartbeat) raises
    :class:`ReplicaCrashed`.  ``times=None`` crashes forever (the
    dead-board fault); a finite ``times`` models a transient outage that
    the router's probe loop should re-admit."""
    arm = _ReplicaArm("crash", after=after, remaining=times)
    _replica_faults(replica)._arms.append(arm)
    return arm


def slow_replica(replica, seconds: float, *, after: int = 0,
                 times: Optional[int] = None) -> _ReplicaArm:
    """Arm a straggler: every call is charged ``seconds`` of simulated
    stall.  A stall beyond the router's per-request timeout turns the
    attempt into a timeout (retried elsewhere); a stall beyond the hedge
    threshold lets the hedged duplicate win."""
    if seconds < 0:
        raise ValueError(f"stall seconds must be >= 0: {seconds}")
    arm = _ReplicaArm("stall", seconds=seconds, after=after, remaining=times)
    _replica_faults(replica)._arms.append(arm)
    return arm


def flapping(replica, *, period: int = 1, after: int = 0,
             times: Optional[int] = None) -> _ReplicaArm:
    """Arm alternating healthy/unhealthy phases of ``period`` calls each
    (healthy phase first).  ``times`` bounds the number of FAILED calls,
    so ``times=k`` means exactly k crashes interleaved with successes —
    the pattern that punishes naive last-call health scoring."""
    if period < 1:
        raise ValueError(f"flap period must be >= 1: {period}")
    arm = _ReplicaArm("flap", period=period, after=after, remaining=times)
    _replica_faults(replica)._arms.append(arm)
    return arm


# ---------------------------------------------------------------------------
# Engine-level faults
# ---------------------------------------------------------------------------


class _FlakyInfer:
    """Wraps one compiled infer fn: raises ``times`` times, then delegates.

    Replacing the engine's ``_infer_cache`` entry (looked up per call by
    ``_predict_key``) exercises the REAL failure path: the exception
    surfaces inside the batcher's flush, which must fail only that key's
    batch and keep serving every other queue.
    """

    def __init__(self, real: Callable, exc: BaseException, times: int):
        self.real = real
        self.exc = exc
        self.times = times
        self.raised = 0

    def __call__(self, *args, **kwargs):
        if self.times > 0:
            self.times -= 1
            self.raised += 1
            raise self.exc
        return self.real(*args, **kwargs)


def break_engine_key(engine, key: str, exc: Optional[BaseException] = None,
                     *, times: int = 1) -> _FlakyInfer:
    """Arm a flush exception on one schedule key of an RNNServingEngine.

    The key's compiled infer fn is swapped for a raiser that fails the
    next ``times`` flushes of THAT key only, then recovers.  Returns the
    wrapper (``.raised`` counts firings) — the original fn is preserved
    inside it, so recovery needs no re-compile.
    """
    if key not in engine._infer_cache:
        raise KeyError(f"engine has no compiled key {key!r}; serve or "
                       f"prewarm it first")
    flaky = _FlakyInfer(engine._infer_cache[key],
                        exc if exc is not None
                        else InjectedFault(f"injected flush fault on {key}"),
                        times)
    engine._infer_cache[key] = flaky
    return flaky


# ---------------------------------------------------------------------------
# Persistent-cache faults
# ---------------------------------------------------------------------------


def corrupt_cache_entries(cache_dir, *, pattern: str = f"*{CACHE_SUFFIX}",
                          payload: bytes = b"\x00corrupt\x00") -> int:
    """Overwrite every matching compile-cache artifact with garbage bytes.

    Models bit rot / torn writes from outside the process (the atomic
    tmp-then-rename writer can't produce these itself).  Returns the number
    of entries corrupted; the CompileCache must warn once, quarantine, and
    fall back to a cold build — never crash, never serve garbage.
    """
    n = 0
    for p in Path(cache_dir).glob(pattern):
        p.write_bytes(payload)
        n += 1
    return n


# ---------------------------------------------------------------------------
# Clock faults
# ---------------------------------------------------------------------------


class VirtualClock:
    """Drivable clock for deterministic replay: ``clock()`` -> seconds.

    ``advance`` moves time forward (the replay driver's tick);
    ``step_back`` is the FAULT — a clock that jumps backwards (NTP step,
    TSC skew).  The pipeline's monotonic clamp must absorb backwards steps
    without negative latencies or corrupted accounting.
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("advance must be >= 0; use step_back for the "
                             "backwards-clock fault")
        self.t += dt
        return self.t

    def step_back(self, dt: float) -> float:
        self.t -= dt
        return self.t
