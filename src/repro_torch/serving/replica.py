"""Replica pool: N independent engine instances behind one router.

Trigger-grade DAQ deployments of hls4ml-style networks put many identical
boards behind a dispatcher — throughput comes from replication, and the
system keeps answering when one board stalls or dies.  This module is that
layer in software: an :class:`EngineReplica` wraps ONE
:class:`~repro_torch.serving.engine.RNNServingEngine` (its own ``MicroBatcher``,
its own executors) plus the replica-grade fault surface
(:class:`~repro_torch.serving.faults.ReplicaFaultSet`), and a
:class:`ReplicaPool` builds N of them from one (config, params) pair —
sharing ONE persistent compile-cache directory, so a replica that takes
over a failed peer's keys starts zero-warmup (the cache's atomic
temp-then-rename writes make concurrent replicas safe).  All replicas of
a pool may run on one card: each is an engine with its own batcher and
executors over the same kernels.

The router (:mod:`repro_torch.serving.router`) talks to replicas only through
:meth:`EngineReplica.predict` / :meth:`EngineReplica.heartbeat`; both
consume the fault set, so an injected crash is indistinguishable from a
dead board at the call boundary — which is the point.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.kernels.schedule import KernelSchedule
from repro_torch.serving.engine import RNNServingEngine
from repro_torch.serving.faults import ReplicaFaultSet


class EngineReplica:
    """One engine instance with an identity, a fault surface, and counters.

    ``predict`` is the single-event serving call (the engine's batch-1
    fast path — row-wise bit-identical to the batched path, conformance-
    enforced, so ANY replica's answer equals a single-replica engine's).
    It returns ``(result, stall_s)``: the injected straggler stall is
    reported in the SIMULATED clock domain for the router's timeout /
    hedge projections, never slept.
    """

    def __init__(self, replica_id: str, engine: RNNServingEngine):
        self.replica_id = replica_id
        self.engine = engine
        self.faults = ReplicaFaultSet(replica_id=replica_id)
        self.calls = 0                 # predict calls attempted
        self.served = 0                # predict calls that returned
        self.errors = 0                # predict calls that raised
        self.heartbeats = 0
        self.stalled_s = 0.0           # total injected stall charged

    def __repr__(self) -> str:
        return (f"EngineReplica({self.replica_id!r}, calls={self.calls}, "
                f"errors={self.errors})")

    # -- the router-facing call surface --------------------------------------

    def heartbeat(self) -> float:
        """Liveness probe: consumes one fault-set call like any other —
        a crashed replica fails its heartbeats, a straggler's heartbeat
        reports its stall — and returns the stall seconds (0.0 healthy)."""
        self.heartbeats += 1
        return self.faults.on_call()

    def predict(self, x: np.ndarray,
                schedule: Optional[KernelSchedule] = None,
                fp: Optional[FixedPointConfig] = None
                ) -> Tuple[np.ndarray, float]:
        """One single-event inference on this replica: ``[T, in] ->
        ([n_outputs], injected_stall_s)``.  Raises whatever the fault set
        (or the engine) raises — the router converts that into the
        retry/failover ladder."""
        self.calls += 1
        try:
            stall = self.faults.on_call()
            out = self.engine.predict_one(x, schedule=schedule, fp=fp)
        except Exception:
            self.errors += 1
            raise
        self.served += 1
        self.stalled_s += stall
        return out, stall

    # -- lifecycle (delegated to the engine's drain / close hooks) -----------

    @property
    def closed(self) -> bool:
        return self.engine.closed

    def drain(self):
        """Flush every queued request on this replica's engine to a
        terminal state (the retirement quiesce step)."""
        return self.engine.drain()

    def close(self):
        return self.engine.close()

    # -- reporting -----------------------------------------------------------

    def report_row(self) -> Dict:
        return {"calls": self.calls, "served": self.served,
                "errors": self.errors, "heartbeats": self.heartbeats,
                "stalled_s": self.stalled_s,
                "faults_armed": self.faults.armed(),
                "faults_fired": len(self.faults.fired),
                "closed": self.closed}


class ReplicaPool:
    """N identically configured replicas sharing one compile-cache dir.

    ``build`` is the canonical constructor: one (cfg, params) pair, N
    fresh :class:`RNNServingEngine` instances (each with its own batcher
    and executors — replicas share NO mutable serving state), all pointed
    at the same ``cache_dir`` so the first replica to build a schedule
    key stores its entry (kernel libraries and launch layouts) and every
    other replica (and every failover) loads it — zero-warmup failover.
    """

    def __init__(self, replicas: List[EngineReplica]):
        if not replicas:
            raise ValueError("a ReplicaPool needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self._by_id = {r.replica_id: r for r in self.replicas}

    @classmethod
    def build(cls, cfg: ModelConfig, params: Dict, n: int, *,
              cache_dir: Optional[str] = None,
              make_engine: Optional[Callable[[int], RNNServingEngine]] = None,
              **engine_kw) -> "ReplicaPool":
        """N replicas of one model.  ``make_engine(i)`` overrides engine
        construction (tests inject pre-warmed or oddly configured
        engines); the default builds ``RNNServingEngine(cfg, params,
        cache_dir=cache_dir, **engine_kw)`` per replica."""
        if n < 1:
            raise ValueError(f"replica count must be >= 1: {n}")
        reps = []
        for i in range(n):
            eng = (make_engine(i) if make_engine is not None
                   else RNNServingEngine(cfg, params, cache_dir=cache_dir,
                                         **engine_kw))
            reps.append(EngineReplica(f"r{i}", eng))
        return cls(reps)

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self) -> Iterator[EngineReplica]:
        return iter(self.replicas)

    def ids(self) -> List[str]:
        return [r.replica_id for r in self.replicas]

    def get(self, replica_id: str) -> EngineReplica:
        return self._by_id[replica_id]

    @property
    def reference(self) -> EngineReplica:
        """The schedule-resolution reference (replicas are identically
        configured, so any one resolves requests for the whole pool)."""
        return self.replicas[0]

    # -- pool-wide operations ------------------------------------------------

    def prewarm(self, schedules=None, fps=None) -> Dict[str, Dict]:
        """Warm every replica's executables for the given schedules; over
        a shared ``cache_dir`` the first replica builds-and-stores and
        the rest load its entries (warm)."""
        out: Dict[str, Dict] = {}
        for rep in self.replicas:
            out[rep.replica_id] = rep.engine.prewarm(schedules=schedules,
                                                     fps=fps)
        return out

    def drain_all(self) -> Dict[str, List]:
        return {r.replica_id: r.drain() for r in self.replicas}

    def close_all(self) -> Dict[str, List]:
        return {r.replica_id: r.close() for r in self.replicas}
