"""Heartbeat + straggler machinery for 1000-node runs.

Single-process container: the transport is injectable (tests feed synthetic
heartbeats); in production the send/recv hooks bind to the cluster fabric
(heartbeat files on shared storage, etcd, or the runtime's own health
API).  The port's copy of ``repro.ft.monitor``: the same decisions on the
same event sequences.

Policies implemented:
  * HeartbeatMonitor — declares a worker dead after `timeout_s` of silence;
    surviving workers converge on the same dead-set (it is a pure function
    of the shared heartbeat table) and trigger an elastic restart (ft.elastic).
  * StragglerPolicy — tracks per-step durations; a worker is a straggler if
    its step time exceeds median x threshold for `patience` consecutive
    steps.  Response at scale: evict (treat as failure) or rebalance
    (shrink its grad-accum share) — returned as an action string.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 60.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None):
        self.last_seen[worker] = time.time() if now is None else now

    def dead_workers(self, now: Optional[float] = None) -> Set[int]:
        now = time.time() if now is None else now
        dead = set()
        for w in range(self.n_workers):
            seen = self.last_seen.get(w)
            if seen is None or now - seen > self.timeout_s:
                dead.add(w)
        return dead

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_workers(now)


@dataclass
class StragglerPolicy:
    threshold: float = 1.5          # x median step time
    patience: int = 3
    history: Dict[int, List[float]] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=dict)

    def record_step(self, worker: int, duration_s: float):
        self.history.setdefault(worker, []).append(duration_s)

    def _medians(self) -> Optional[float]:
        last = [v[-1] for v in self.history.values() if v]
        if not last:
            return None
        s = sorted(last)
        return s[len(s) // 2]

    def evaluate(self) -> Dict[int, str]:
        """worker -> action in {'ok', 'warn', 'evict'}."""
        med = self._medians()
        out: Dict[int, str] = {}
        if med is None:
            return out
        for w, v in self.history.items():
            if not v:
                continue
            if v[-1] > self.threshold * med:
                self.strikes[w] = self.strikes.get(w, 0) + 1
            else:
                self.strikes[w] = 0
            n = self.strikes[w]
            out[w] = "evict" if n >= self.patience else (
                "warn" if n > 0 else "ok")
        return out
