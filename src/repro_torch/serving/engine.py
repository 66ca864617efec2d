"""RNN serving engine: the paper's deliverable as a multi-tenant service.

Wraps a tagger with schedule-aware serving: every request optionally
carries a :class:`KernelSchedule`, and the engine

  * co-batches requests by the stable ``schedule_key`` hash: requests that
    run the same kernel share a batch, requests that differ never mix;
  * builds ONE executor per schedule key; flushed batches are padded to the
    key's ``max_batch`` (zero rows are row-wise inert), so every flush of a
    key runs at one shape;
  * keeps a row's answer the same bits in every batch shape:
    ``predict_one(x) == predict(x[None])[0] == predict(X)[i]`` == the
    flushed result (every product of the path sums each output in one
    fixed order: kernels/ref.py, csrc/rnn_scan.cu);
  * readies each (key, batch shape) through a persistent compile cache
    (``cache_dir``; serving/compile_cache.py): a warm directory serves the
    first request of a FRESH engine with no ``nvcc``, no residency query
    of the card and no executor build, and ``warmup`` / ``prewarm`` ready
    keys before traffic arrives, launching nothing;
  * shares batches across ragged (variable seq_len) streams, either by
    length-bucketing sub-batches or by a pad-and-mask scan;
  * reports, per schedule key, the measured latency and batch counters
    next to ``core.hls.estimate_schedule`` of the SAME schedule object
    (the ``analytical`` column: the paper's FPGA model at ``clock_mhz``,
    not a time on the card);
  * resolves :class:`~repro_torch.autotune.DesignTarget`\\ s to schedules
    through the Pareto explorer (``auto_schedule`` /
    ``submit(target=...)``): a queue can be opened with a latency /
    resource budget instead of an explicit ``KernelSchedule``, and
    ``measure_top_k`` re-ranks the top candidates by their scans' time on
    the engine's device.

One difference from the JAX package's engine: ``impl`` defaults to
``"pallas"``, so the normal entry point runs the CUDA kernels; the JAX
engine defaults to ``"xla"``, its golden reference.  Every float schedule
(static, nonstatic and pipeline mode, any reuse factor, hoisted or not)
runs on the CUDA kernels.  ``fp`` (the engine's, or a request's) selects a
fixed-point datapath: the native int8/int4 configs run every gate product
on the ``quant_matmul`` kernel, every other config the ap_fixed emulation
cells; the key of a request names its (schedule, fp) pair.  The engine
runs on ``device`` ("cuda" unless the caller asks for "cpu") and holds its
float32 weights there from construction on.  ``benchmark`` times one key's
padded serving shape on that device beside the FPGA model of the same
schedule (``launch/serve.py`` and the examples are its drivers).
Inside a ``repro_torch.tracing.recording()``, ``predict`` and
``predict_one`` record a request's spans (the root and, in its executor,
staging, the copy in, the forward and the copy back) and its counters.
On a CUDA device each executor of the float kernel datapath replays its
warmed calls as CUDA graphs (serving/graphs.py): a signature's first call
runs eagerly, its second is captured, and later ones copy the input onto
the card and replay one graph.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.autotune import DesignTarget, SpaceSpec
from repro_torch.autotune import select as autotune_select
from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.core.hls import (DesignPoint, HLSDesign, RNNDesignPoint,
                                  estimate_design, estimate_schedule)
from repro_torch.device import require_device
from repro_torch.kernels.schedule import (DEFAULT_SCHEDULE_KEY, KernelSchedule,
                                          cache_meta, schedule_key)
from repro_torch.models.rnn_tagger import RNNTagger
from repro_torch.serving import graphs
from repro_torch.serving.batcher import (KeyStats, MicroBatcher, Request,
                                         _pad_stack)
from repro_torch.serving.compile_cache import (ArgSpec, CachedExecutor,
                                               CompileCache)

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
    cache_dir: Optional[str] = None       # persistent compile cache; a warm
                                          # dir serves the first request of
                                          # a FRESH engine with no build (N
                                          # replicas may share it)
    _infer_cache: Dict[str, Callable] = field(default_factory=dict, repr=False)
    _key_specs: Dict[str, Tuple[KernelSchedule, Optional[FixedPointConfig]]] \
        = field(default_factory=dict, repr=False)
    _traces: Dict[str, int] = field(default_factory=dict, repr=False)
    _target_points: Dict[Tuple, DesignPoint] \
        = field(default_factory=dict, repr=False)
    # batch-1 fast path: its own executors + counters
    _one_cache: Dict[str, Callable] = field(default_factory=dict, repr=False)
    _one_traces: Dict[str, int] = field(default_factory=dict, repr=False)
    _one_stats: Dict[str, KeyStats] = field(default_factory=dict, repr=False)
    _closed: bool = field(default=False, repr=False)
    # the executors that replay CUDA graphs (serving/graphs.py)
    _replays: List[graphs.GraphReplay] = field(default_factory=list,
                                               repr=False)

    def __post_init__(self):
        if self.ragged not in RAGGED_POLICIES:
            raise ValueError(f"ragged {self.ragged!r} not in {RAGGED_POLICIES}")
        self.device = require_device(self.device, "RNNServingEngine")
        self.model = RNNTagger(self.cfg, self.params, device=self.device)
        self.params = dict(self.model.weights)
        self.batcher = MicroBatcher(max_batch=self.max_batch)
        self.compile_cache = CompileCache(self.cache_dir, self.device)

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

    # -- target-driven auto-scheduling ---------------------------------------

    def _default_spec(self, target: DesignTarget) -> SpaceSpec:
        """The slice of schedule space this engine can execute: its backend
        family (keys as a JAX-package engine with the same ``impl``), one
        block_batch, the full legal R / mode / hoist axes.  Callers needing
        other axes pass an explicit spec."""
        backend = "xla" if self.impl == "xla" else "pallas_interpret"
        return SpaceSpec(backends=(backend,),
                         block_batches=(min(8, self.max_batch),))

    def schedule_for_target(self, target: DesignTarget, *,
                            spec: Optional[SpaceSpec] = None,
                            measure_top_k: int = 0) -> DesignPoint:
        """Resolve a DesignTarget to the priced point this engine will run.

        Memoized per (target, spec, measure_top_k), all frozen / hashable:
        a stream of same-target requests resolves the explorer once and
        then co-batches on the selected schedule's key, while the same
        target under another spec resolves independently.  With
        ``measure_top_k`` > 0 the top candidates are timed on the engine's
        device.  Raises ``InfeasibleTargetError`` (naming the
        nearest-to-feasible point) when the budget cannot be met.
        """
        memo = (target, spec, measure_top_k)
        pt = self._target_points.get(memo)
        if pt is None:
            eff = target
            if eff.fp is None and self.fp is not None:
                # price with the fp the engine will actually serve with
                eff = dataclasses.replace(eff, fp=self.fp)
            pt = autotune_select(self.cfg, eff,
                                 spec or self._default_spec(target),
                                 measure_top_k=measure_top_k,
                                 device=self.device)
            self._target_points[memo] = pt
        return pt

    def auto_schedule(self, target: DesignTarget, *,
                      spec: Optional[SpaceSpec] = None,
                      measure_top_k: int = 0,
                      warmup: bool = True) -> DesignPoint:
        """Make a DesignTarget this engine's default design point: later
        ``predict`` / ``submit`` calls without a schedule execute it (and
        the default queue reports it).  ``warmup`` readies the selected
        key's serving shape (:meth:`warmup`), so that its first request
        builds nothing."""
        pt = self.schedule_for_target(target, spec=spec,
                                      measure_top_k=measure_top_k)
        self.schedule = pt.schedule
        self.mode = None                 # the schedule is now authoritative
        self.impl = "pallas" if pt.schedule.use_pallas else "xla"
        if target.fp is not None:
            self.fp = pt.fp
        if warmup:
            self.warmup()
        return pt

    def _with_target(self, target: Optional[DesignTarget],
                     schedule: Optional[KernelSchedule],
                     fp: Optional[FixedPointConfig]
                     ) -> Tuple[Optional[KernelSchedule],
                                Optional[FixedPointConfig]]:
        """A request's (schedule, fp) with its ``target`` resolved, where it
        carries a target and no schedule."""
        if target is not None and schedule is None:
            pt = self.schedule_for_target(target)
            return pt.schedule, fp if fp is not None else pt.fp
        return schedule, fp

    def _ensure_key(self, sched: KernelSchedule,
                    fp: Optional[FixedPointConfig]) -> str:
        key = schedule_key(sched, fp)
        if key not in self._infer_cache:
            self._key_specs[key] = (sched, fp)
            self._infer_cache[key] = self._make_infer(key, sched, fp,
                                                      "_traces")
        return key

    def _executor_meta(self, kind: str, sched: KernelSchedule,
                       fp: Optional[FixedPointConfig]) -> Dict:
        """Content identity of one serving executor: the model config plus
        the EXHAUSTIVE schedule / fp axes (``cache_meta``, not the routing
        key: a future schedule axis must invalidate entries, not silently
        share them).  The toolchain and card axes are appended by the
        CompileCache itself; argument shapes by the executor."""
        return {"kind": kind, "cfg": repr(self.cfg),
                **cache_meta(sched, fp)}

    def _make_infer(self, key: str, sched: KernelSchedule,
                    fp: Optional[FixedPointConfig], counter: str) -> Callable:
        """The executor of one schedule key, readied per batch shape
        through the compile cache; its build is counted in ``counter``
        once, at its first cold signature (a warm start builds nothing,
        so the count stays 0)."""
        # the closures hold the fields they need, never ``self``: the
        # engine holds them (``_infer_cache``), and a closure over the
        # engine would keep a dropped engine's tensors alive until the
        # cycle collector ran
        traces = getattr(self, counter)
        impl = "pallas" if sched.use_pallas else "xla"
        model, device = self.model, self.device

        def built():
            traces[key] = traces.get(key, 0) + 1

        def infer(x: np.ndarray, lengths=None) -> np.ndarray:
            rec = tracing.ACTIVE
            if rec is not None:
                span = rec.open("engine.stage")
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            if lengths is not None:
                lengths = torch.from_numpy(np.asarray(lengths, np.int64))
            if rec is not None:
                rec.close(span)
                span = rec.open("engine.h2d")
            xt = xt.to(device)
            if lengths is not None:
                lengths = lengths.to(device)
            if rec is not None:
                rec.close(span)
            with torch.inference_mode():
                out = model(xt, fp=fp, impl=impl, schedule=sched,
                            lengths=lengths)
            if rec is not None:
                span = rec.open("engine.d2h")
            out = out.cpu().numpy()
            if rec is not None:
                rec.close(span)
            return out

        if graphs.replays(device, fp, sched.use_pallas):
            def run(xt: torch.Tensor) -> torch.Tensor:
                return model(xt, fp=fp, impl=impl, schedule=sched)

            # the live dict the ParameterDict registers its tensors in:
            # each call reads it in a few us (the ParameterDict's values()
            # take several times that)
            infer = graphs.GraphReplay(infer, run,
                                       model.weights._parameters, device)
            self._replays.append(infer)
        one = counter == "_one_traces"
        return CachedExecutor(
            infer, self.compile_cache, key,
            self._executor_meta("rnn_one" if one else "rnn_infer", sched,
                                fp),
            name_hint=f"{key}-one" if one else key, on_build=built)

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
                fp: Optional[FixedPointConfig] = None,
                target: Optional[DesignTarget] = None) -> np.ndarray:
        """[b, T, in] -> [b, n_outputs] under the request's schedule and
        fixed-point config (or the schedule auto-picked for its
        ``target``)."""
        rec = tracing.ACTIVE
        if rec is not None:
            root = rec.open_call("engine.predict", len(x), self.compile_cache)
        try:
            self._check_open()
            schedule, fp = self._with_target(target, schedule, fp)
            key = self._ensure_key(*self.resolve(schedule, fp))
            return self._predict_key(key, x)
        finally:
            if rec is not None:
                rec.close_call(root, self.compile_cache)

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

    def warmup(self, schedule: Optional[KernelSchedule] = None,
               fp: Optional[FixedPointConfig] = None) -> Dict[str, Dict]:
        """Ready ONE (schedule, fp) pair's serving shape: from the
        persistent cache when possible, else build-and-store."""
        return self.prewarm(schedules=[schedule], fps=[fp])

    def prewarm(self, targets: Optional[List[DesignTarget]] = None,
                schedules: Optional[List[Optional[KernelSchedule]]] = None,
                fps: Optional[List[Optional[FixedPointConfig]]] = None
                ) -> Dict[str, Dict]:
        """Zero-warmup entry point: ready the serving shape of a list of
        targets and/or schedules BEFORE traffic arrives.

        Each (schedule, fp) pair (targets resolved through the explorer
        first) is readied at the key's serving shape (``max_batch`` rows
        x the config's sequence, as an :class:`ArgSpec`) with no kernel
        launch: over a warm ``cache_dir`` its entry is loaded (no
        ``nvcc``, no residency query, no executor build); a cold one runs
        the executor once on zeros without launching (libraries built and
        loaded, layouts resolved) and is stored for the next engine /
        replica.  Returns per key ``{"status": "hot"|"warm"|"cold",
        "compile_s": ...}``.
        """
        pairs: List[Tuple[Optional[KernelSchedule],
                          Optional[FixedPointConfig]]] = []
        for t in (targets or ()):
            pt = self.schedule_for_target(t)
            pairs.append((pt.schedule, pt.fp))
        if schedules is not None:
            fps = fps if fps is not None else [None] * len(schedules)
            pairs.extend(zip(schedules, fps))
        if not pairs:
            pairs.append((None, None))   # the engine's resolved default
        r = self.cfg.rnn
        out: Dict[str, Dict] = {}
        for sched, fp in pairs:
            key = self._ensure_key(*self.resolve(sched, fp))
            mb, _ = self.batcher.policy(key)
            rows = mb if self.pad_batches else 1
            x = ArgSpec((rows, r.seq_len, r.input_size), "float32")
            out[key] = self._infer_cache[key].warm(x, None)
        return out

    # -- batch-1 latency fast path ------------------------------------------

    def predict_one(self, x: np.ndarray,
                    schedule: Optional[KernelSchedule] = None,
                    fp=None,
                    target: Optional[DesignTarget] = None) -> np.ndarray:
        """Single-event inference: ``[T, in] -> [n_outputs]``, skipping the
        batcher (no queueing, no pad to ``max_batch``), under the request's
        schedule or its ``target``'s.  Steady-state wall-clock is recorded
        per key and reported by ``serve_report`` as the ``fast_path``
        column."""
        rec = tracing.ACTIVE
        if rec is not None:
            root = rec.open_call("engine.predict_one", 1, self.compile_cache)
        try:
            self._check_open()
            schedule, fp = self._with_target(target, schedule, fp)
            sched, fpr = self.resolve(schedule, fp)
            key = self._ensure_key(sched, fpr)   # registers specs to report
            fn = self._one_cache.get(key)
            if fn is None:
                fn = self._one_cache[key] = self._make_infer(
                    key, sched, fpr, "_one_traces")
            readied = fn.compiled_signatures()
            t0 = time.perf_counter()
            out = fn(np.asarray(x)[None])[0]
            if fn.compiled_signatures() == readied:   # steady state
                self._one_stats.setdefault(key, KeyStats()).record_one(
                    time.perf_counter() - t0)
            return out
        finally:
            if rec is not None:
                rec.close_call(root, self.compile_cache)

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
        """Drain, then refuse all new work and drop the executors' CUDA
        graphs (idempotent)."""
        if self._closed:
            return []
        flushed = self.drain(now=now)
        self._closed = True
        for replay in self._replays:
            replay.close()
        return flushed

    # -- schedule-keyed serving ---------------------------------------------

    def submit(self, x: np.ndarray,
               schedule: Optional[KernelSchedule] = None,
               fp=None, target: Optional[DesignTarget] = None,
               now: Optional[float] = None) -> Request:
        """Enqueue one request ([T, in] payload) on its schedule's queue.
        A request may carry a ``target`` instead of a schedule: the engine
        resolves it through the explorer (memoized), so a stream of
        same-target requests lands on one auto-picked queue."""
        self._check_open()
        schedule, fp = self._with_target(target, schedule, fp)
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

    # -- measured throughput/latency ----------------------------------------

    def benchmark(self, batch: int, iters: int = 20,
                  schedule: Optional[KernelSchedule] = None,
                  fp: Optional[FixedPointConfig] = None) -> Dict[str, float]:
        """Measured latency/throughput for one schedule key on the engine's
        device, paired with the analytical estimate of the same schedule
        object (``latency_cycles``, ``ii_cycles``, ``dsp``: the paper's FPGA
        model, not the card)."""
        r = self.cfg.rnn
        sched, fpr = self.resolve(schedule, fp)
        key = self._ensure_key(sched, fpr)
        x = np.random.RandomState(0).randn(
            batch, r.seq_len, r.input_size).astype(np.float32)
        # through _predict_padded, NOT _predict_key: every batch size runs
        # the key's padded serving shape, the one executor its flushes run;
        # the untimed call readies it (on a cold key: nvcc and the launch
        # layouts)
        self._predict_padded(key, x)
        t0 = time.perf_counter()
        for _ in range(iters):
            # each call ends in its result on the host (``infer``'s
            # ``.cpu()`` waits for the card), so the clock reads finished
            # work
            self._predict_padded(key, x)
        dt = (time.perf_counter() - t0) / iters
        est = estimate_schedule(sched, r, fpr)
        return {"key": key, "batch": batch, "latency_s": dt,
                "throughput_eps": batch / dt,
                "latency_cycles": est.latency_cycles,
                "ii_cycles": est.ii_cycles, "dsp": est.dsp}

    # -- measured vs analytical, per schedule key ---------------------------

    def serve_report(self, clock_mhz: float = 200.0) -> Dict[str, Dict]:
        """Per schedule key: the schedule, the executor builds and the
        measured serving counters of the batcher (plus the batch-1 fast
        path's, where it ran), next to ``estimate_schedule`` of the SAME
        schedule object (``analytical``: the paper's FPGA model at
        ``clock_mhz``, not a time on the card), and the ``compile``
        column: the persistent cache's cold / warm split for the key (hit
        rate, the first cold signature's seconds).  Requests served on the
        bare DEFAULT_SCHEDULE_KEY queue report the resolved schedule with
        its estimate and point at its ``resolved_key``, which owns the
        build count."""
        specs = dict(self._key_specs)
        resolved_from: Dict[str, str] = {}
        if (DEFAULT_SCHEDULE_KEY in self.batcher.stats
                and DEFAULT_SCHEDULE_KEY not in specs):
            sched, fpr = self.resolve()
            specs[DEFAULT_SCHEDULE_KEY] = (sched, fpr)
            resolved_from[DEFAULT_SCHEDULE_KEY] = schedule_key(sched, fpr)
        report: Dict[str, Dict] = {}
        for key, (sched, fpr) in specs.items():
            est = estimate_schedule(sched, self.cfg.rnn, fpr)
            report[key] = {
                "schedule": sched,
                "fp": fpr,
                "traces": 0 if key in resolved_from else self.trace_count(key),
                "measured": self.batcher.key_stats(key).summary(),
                "analytical": est.report_row(clock_mhz),
                "compile": self.compile_cache.report_row(key),
            }
            if key in resolved_from:
                report[key]["resolved_key"] = resolved_from[key]
            if key in self._one_stats:
                report[key]["fast_path"] = self._one_stats[key].summary()
        return report

    # -- paired FPGA design point -------------------------------------------

    def fpga_design(self, reuse_kernel: int = 1, reuse_recurrent: int = 1,
                    strategy: str = "latency", part: str = "xcku115"
                    ) -> HLSDesign:
        """The table-calibrated FPGA design of this engine's model, fixed
        point and mode (``core.hls.estimate_design``)."""
        return estimate_design(RNNDesignPoint(
            self.cfg, self.fp or FixedPointConfig(),
            reuse_kernel, reuse_recurrent, self.resolved_mode,
            strategy, part))


def format_serve_report(report: Dict[str, Dict],
                        clock_mhz: float = 200.0) -> str:
    """Render serve_report() as the measured-vs-analytical table: measured
    request latency on the engine's device beside the FPGA model's
    latency, II and DSPs, and the compile cache's cold / warm builds and
    hit rate."""
    lines = [f"{'schedule key':38s} {'served':>6s} {'meas p50':>10s} "
             f"{'meas p99':>10s} {'est lat':>9s} {'est II':>8s} {'DSP':>6s} "
             f"{'cold/warm':>9s} {'hit':>5s}"]
    for key, row in report.items():
        m, a = row["measured"], row["analytical"]
        c = row.get("compile", {})
        cw = f"{int(c.get('cold', 0))}/{int(c.get('warm', 0))}"
        lines.append(
            f"{key:38s} {int(m['served']):6d} "
            f"{m['latency_p50_s'] * 1e3:8.2f}ms "
            f"{m['latency_p99_s'] * 1e3:8.2f}ms "
            f"{a['latency_us']:7.2f}us {a['ii_cycles']:8d} {a['dsp']:6d} "
            f"{cw:>9s} {c.get('hit_rate', 0.0):4.0%}")
    return "\n".join(lines)
