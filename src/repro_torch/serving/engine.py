"""RNN serving engine: the paper's deliverable as a multi-tenant service.

Wraps a tagger with schedule-aware serving: every request optionally
carries a :class:`KernelSchedule`, and the engine

  * co-batches requests by the stable ``schedule_key`` hash: requests that
    run the same kernel share a batch, requests that differ never mix;
  * builds ONE executor per schedule key; flushed batches are padded to the
    key's ``max_batch`` (zero rows are row-wise inert), so every flush of a
    key runs at one shape;
  * shares batches across ragged (variable seq_len) streams, either by
    length-bucketing sub-batches or by a pad-and-mask scan;
  * reports, per schedule key, the measured latency and batch counters.

One difference from the JAX package's engine: ``impl`` defaults to
``"pallas"``, so the normal entry point runs the CUDA kernels; the JAX
engine defaults to ``"xla"``, its golden reference.  Every float schedule
(static, nonstatic and pipeline mode, any reuse factor, hoisted or not)
runs on the CUDA kernels.  ``fp`` (the engine's, or a request's) selects a
fixed-point datapath: the native int8/int4 configs run every gate product
on the ``quant_matmul`` kernel, every other config the ap_fixed emulation
cells; the key of a request names its (schedule, fp) pair.  The engine
runs on ``device`` ("cuda" unless the caller asks for "cpu") and holds its
float32 weights there from construction on.

Not in this slice of the port: design targets and auto-scheduling, HLS
pricing (the ``analytical`` column of ``serve_report``) and the persistent
compile cache (ROADMAP.md, modules to port).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.kernels.schedule import (DEFAULT_SCHEDULE_KEY, KernelSchedule,
                                          schedule_key)
from repro_torch.models.rnn_tagger import RNNTagger
from repro_torch.serving.batcher import (KeyStats, MicroBatcher, Request,
                                         _pad_stack)

RAGGED_POLICIES = ("bucket", "mask")


class EngineClosedError(RuntimeError):
    """Submit/predict on a closed engine: it was drained and retired and
    must never accept new work."""

    def __init__(self, what: str = "engine"):
        super().__init__(
            f"{what} is closed: it was drained and retired, so new requests "
            f"must be routed to a live replica (close() flushed every "
            f"queued request to a terminal state first)")


@dataclass
class RNNServingEngine:
    cfg: ModelConfig
    params: Mapping[str, object]
    mode: Optional[str] = None            # static | nonstatic | pipeline |
                                          # None: from the schedule / config
    impl: str = "pallas"                  # pallas (kernels) | xla (reference)
    fp: Optional[FixedPointConfig] = None  # default-request fixed point
    max_batch: int = 256
    schedule: Optional[KernelSchedule] = None   # default-request schedule
    ragged: str = "bucket"                # bucket | mask (one padded batch)
    pad_batches: bool = True              # pad flushes to max_batch
    device: Union[str, torch.device] = "cuda"
    _infer_cache: Dict[str, Callable] = field(default_factory=dict, repr=False)
    _key_specs: Dict[str, Tuple[KernelSchedule, Optional[FixedPointConfig]]] \
        = field(default_factory=dict, repr=False)
    _traces: Dict[str, int] = field(default_factory=dict, repr=False)
    # batch-1 fast path: its own executors + counters
    _one_cache: Dict[str, Callable] = field(default_factory=dict, repr=False)
    _one_traces: Dict[str, int] = field(default_factory=dict, repr=False)
    _one_stats: Dict[str, KeyStats] = field(default_factory=dict, repr=False)
    _closed: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.ragged not in RAGGED_POLICIES:
            raise ValueError(f"ragged {self.ragged!r} not in {RAGGED_POLICIES}")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RNNServingEngine(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to serve on the CPU")
        self.model = RNNTagger(self.cfg, self.params, device=self.device)
        self.params = dict(self.model.weights)
        self.batcher = MicroBatcher(max_batch=self.max_batch)

    # -- schedule resolution -------------------------------------------------

    @property
    def resolved_schedule(self) -> KernelSchedule:
        """The schedule executed for requests that don't carry one, with
        the engine's ``mode`` / ``impl`` folded in so the key names what
        runs."""
        s = self.schedule if self.schedule is not None \
            else self.cfg.rnn.kernel_schedule()
        if self.mode is not None and s.mode != self.mode:
            s = s.replace(mode=self.mode)
        if self.impl == "xla" and s.backend != "xla":
            s = s.replace(backend="xla")
        return s

    @property
    def resolved_mode(self) -> str:
        return self.resolved_schedule.mode

    def resolve(self, schedule: Optional[KernelSchedule] = None,
                fp: Optional[FixedPointConfig] = None
                ) -> Tuple[KernelSchedule, Optional[FixedPointConfig]]:
        """(schedule, fp) a request with these overrides actually executes."""
        return (schedule if schedule is not None else self.resolved_schedule,
                fp if fp is not None else self.fp)

    def _ensure_key(self, sched: KernelSchedule,
                    fp: Optional[FixedPointConfig]) -> str:
        key = schedule_key(sched, fp)
        if key not in self._infer_cache:
            self._key_specs[key] = (sched, fp)
            self._infer_cache[key] = self._make_infer(key, sched, fp,
                                                      "_traces")
        return key

    def _make_infer(self, key: str, sched: KernelSchedule,
                    fp: Optional[FixedPointConfig], counter: str) -> Callable:
        """The executor of one schedule key; building it is counted in
        ``counter`` (one build per key)."""
        traces = getattr(self, counter)
        traces[key] = traces.get(key, 0) + 1
        impl = "pallas" if sched.use_pallas else "xla"
        model = self.model

        def infer(x: np.ndarray, lengths=None) -> np.ndarray:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                self.device)
            if lengths is not None:
                lengths = torch.from_numpy(
                    np.asarray(lengths, np.int64)).to(self.device)
            with torch.inference_mode():
                out = model(xt, fp=fp, impl=impl, schedule=sched,
                            lengths=lengths)
            return out.cpu().numpy()

        return infer

    def trace_count(self, key: str) -> int:
        return self._traces.get(key, 0)

    # -- direct batched inference -------------------------------------------

    def _resolve_default_key(self, key: str) -> str:
        """Requests on the bare DEFAULT_SCHEDULE_KEY queue execute the
        engine's resolved schedule."""
        if key == DEFAULT_SCHEDULE_KEY:
            return self._ensure_key(*self.resolve())
        return key

    def _predict_key(self, key: str, x: np.ndarray,
                     lengths: Optional[np.ndarray] = None) -> np.ndarray:
        return self._infer_cache[self._resolve_default_key(key)](x, lengths)

    def predict(self, x: np.ndarray,
                schedule: Optional[KernelSchedule] = None,
                fp: Optional[FixedPointConfig] = None) -> np.ndarray:
        """[b, T, in] -> [b, n_outputs] under the request's schedule and
        fixed-point config."""
        self._check_open()
        key = self._ensure_key(*self.resolve(schedule, fp))
        return self._predict_key(key, x)

    def predict_ragged(self, xs: List[np.ndarray],
                       schedule: Optional[KernelSchedule] = None,
                       fp=None) -> List[np.ndarray]:
        """Variable-length requests sharing one logical batch.  ``bucket``
        groups by seq_len; ``mask`` pads to the max length and freezes each
        row's state past its true length (one batch, cell datapath)."""
        self._check_open()
        key = self._ensure_key(*self.resolve(schedule, fp))
        pad, lengths, _ = _pad_stack(list(xs))
        if self.ragged == "mask":
            out = self._predict_padded(key, pad, lengths)
            return [out[i] for i in range(len(xs))]
        return self._bucket_predict(key, xs, lengths)

    def _bucket_predict(self, key: str, xs: List[np.ndarray],
                        lengths: np.ndarray) -> List[np.ndarray]:
        out: List[Optional[np.ndarray]] = [None] * len(xs)
        for t in sorted({int(n) for n in lengths}):
            idx = [i for i, n in enumerate(lengths) if int(n) == t]
            sub = np.stack([np.asarray(xs[i])[:t] for i in idx])
            res = self._predict_padded(key, sub)
            for j, i in enumerate(idx):
                out[i] = res[j]
        return out                           # type: ignore[return-value]

    # -- batch-1 latency fast path ------------------------------------------

    def predict_one(self, x: np.ndarray,
                    schedule: Optional[KernelSchedule] = None,
                    fp=None) -> np.ndarray:
        """Single-event inference: ``[T, in] -> [n_outputs]``, skipping the
        batcher (no queueing, no pad to ``max_batch``).  Steady-state
        wall-clock is recorded per key and reported by ``serve_report`` as
        the ``fast_path`` column."""
        self._check_open()
        sched, fpr = self.resolve(schedule, fp)
        key = self._ensure_key(sched, fpr)   # registers specs for reporting
        fn = self._one_cache.get(key)
        first = fn is None
        if first:
            fn = self._one_cache[key] = self._make_infer(key, sched, fpr,
                                                         "_one_traces")
        t0 = time.perf_counter()
        out = fn(np.asarray(x)[None])[0]
        if not first:                        # steady state
            self._one_stats.setdefault(key, KeyStats()).record_one(
                time.perf_counter() - t0)
        return out

    def one_trace_count(self, key: str) -> int:
        return self._one_traces.get(key, 0)

    # -- lifecycle -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        if self._closed:
            raise EngineClosedError("RNNServingEngine")

    def drain(self, now: Optional[float] = None) -> List[Request]:
        """Flush EVERY per-key queue to completion and return the flushed
        requests; the engine stays open."""
        return self.flush(now=now, force=True)

    def close(self, now: Optional[float] = None) -> List[Request]:
        """Drain, then refuse all new work (idempotent)."""
        if self._closed:
            return []
        flushed = self.drain(now=now)
        self._closed = True
        return flushed

    # -- schedule-keyed serving ---------------------------------------------

    def submit(self, x: np.ndarray,
               schedule: Optional[KernelSchedule] = None,
               fp=None, now: Optional[float] = None) -> Request:
        """Enqueue one request ([T, in] payload) on its schedule's queue."""
        self._check_open()
        sched, fpr = self.resolve(schedule, fp)
        key = self._ensure_key(sched, fpr)
        return self.batcher.submit(x, now=now, key=key, schedule=sched,
                                   fp=fpr)

    def _pad_rows(self, x: np.ndarray, key: str) -> Tuple[np.ndarray, int]:
        b = x.shape[0]
        mb, _ = self.batcher.policy(key)
        if not self.pad_batches or b >= mb:
            return x, b
        pad = np.zeros((mb - b,) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0), b

    def _predict_padded(self, key: str, x: np.ndarray,
                        lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """Key-cached inference with the batch padded to the key's
        max_batch: one shape per schedule key."""
        xp, b = self._pad_rows(np.asarray(x), key)
        if lengths is not None and xp.shape[0] != len(lengths):
            lp = np.zeros((xp.shape[0],), np.int32)
            lp[:b] = lengths
            lengths = lp
        return self._predict_key(key, xp, lengths)[:b]

    def _flush_fn(self, key: str) -> Callable:
        """The infer function handed to the batcher for one queue."""
        def fn(x, lengths=None):
            if lengths is None:
                return self._predict_padded(key, x)
            if self.ragged == "mask":
                return self._predict_padded(key, x, lengths=lengths)
            res = self._bucket_predict(
                key, [np.asarray(x[i]) for i in range(x.shape[0])],
                np.asarray(lengths))
            return np.stack(res)
        return fn

    def flush(self, now: Optional[float] = None,
              force: bool = False) -> List[Request]:
        """Flush every ready queue (fair round-robin across schedule keys);
        ``force`` also flushes below-threshold leftovers (end of stream)."""
        return self.batcher.run_all(self._flush_fn, now=now, force=force)

    def serve(self, payloads, schedules=None, fps=None,
              now: Optional[float] = None) -> List[Request]:
        """Submit a whole stream (parallel lists), then flush to completion.
        Returns the requests in submission order."""
        n = len(payloads)
        schedules = schedules if schedules is not None else [None] * n
        fps = fps if fps is not None else [None] * n
        reqs = [self.submit(x, schedule=s, fp=f, now=now)
                for x, s, f in zip(payloads, schedules, fps)]
        self.flush(now=now, force=True)
        return reqs

    # -- measured serving, per schedule key ---------------------------------

    def serve_report(self) -> Dict[str, Dict]:
        """Per schedule key: the schedule, the executor builds and the
        measured serving counters of the batcher (plus the batch-1 fast
        path's, where it ran).  Requests served on the bare
        DEFAULT_SCHEDULE_KEY queue report the resolved schedule and point at
        its ``resolved_key``, which owns the build count."""
        specs = dict(self._key_specs)
        resolved_from: Dict[str, str] = {}
        if (DEFAULT_SCHEDULE_KEY in self.batcher.stats
                and DEFAULT_SCHEDULE_KEY not in specs):
            sched, fpr = self.resolve()
            specs[DEFAULT_SCHEDULE_KEY] = (sched, fpr)
            resolved_from[DEFAULT_SCHEDULE_KEY] = schedule_key(sched, fpr)
        report: Dict[str, Dict] = {}
        for key, (sched, fpr) in specs.items():
            report[key] = {
                "schedule": sched,
                "fp": fpr,
                "traces": 0 if key in resolved_from else self.trace_count(key),
                "measured": self.batcher.key_stats(key).summary(),
            }
            if key in resolved_from:
                report[key]["resolved_key"] = resolved_from[key]
            if key in self._one_stats:
                report[key]["fast_path"] = self._one_stats[key].summary()
        return report
