"""LM serving engine: token-by-token decode with slot-based continuous
batching, keyed by schedule like the RNN engine.

The port of ``repro/serving/lm_engine.py``, for every LM family (dense,
moe, ssm, hybrid, audio enc-dec, vlm).  The decode step is the paper's
static-mode schedule at LM scale (state resident, one token per step);
the slot manager does continuous batching: a finished sequence frees its
slot and a new request joins mid-flight.
Prompts are fed token by token through the same decode step (teacher
forcing), then tokens are sampled greedily.

Requests may carry a ``KernelSchedule``; they are routed by the stable
``schedule_key`` into per-key decoders.  Each key owns its slot pool, its
KV cache, ONE executor of the decode step (built once, counted by
``trace_count``) and its counters.  Requests of different keys never share
a decode batch; requests with no schedule ride ``DEFAULT_SCHEDULE_KEY``,
the einsum path.  For dense and vlm (``decode_schedulable``) a scheduled
key runs every projection on the ``decode_matmul`` kernel (4 launches per
layer and tick) over the packed weight layout, which the engine derives
once and holds for all its scheduled keys (the layout does not depend on
the schedule, and a full-width pack is larger than the residency cache
keeps).  The other families accept a schedule and run the einsum path on
every key, as ``repro``'s engine does; their keys still get their own
pools, caches and executors.  Prompts are teacher-forced through decode
and the encoder of an enc-dec model runs in neither engine, as in
``repro``: ``cache/xk`` / ``cache/xv`` stay zeros.

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu")
and raises without a CUDA device.  Greedy sampling takes the FIRST maximum
of each row's logits on the host (``np.argmax``), as ``jnp.argmax`` does.
Each key's step executor is readied through the persistent compile cache
(``cache_dir``, serving/compile_cache.py): ``prewarm`` readies a key's
step before its first tick without launching anything, and a warm
directory spares a fresh engine the build.
``serve_report`` gives per key the measured columns: request latency,
decoded tokens over decode wall-clock (tokens/s) and the tick latency,
and the ``compile`` column (cold / warm builds, hit rate).
The first tick of a key builds and loads its kernels and is left out of
tokens/s and tick latency, as ``repro`` leaves out the tick that traced.
A scheduled key's row pairs them with ``estimate_lm_decode`` of the SAME
schedule object (``analytical``: the paper's FPGA model at
``clock_mhz``, not a time on the card); the einsum key stays
estimate-less.

Speculative decode: a key may also carry a ``SpecConfig`` (the engine's
default or a request's ``spec=``).  Its decoder then drafts K tokens a
round on the cheap side of the R trade (the n-gram ``CacheTable`` or a
model draft step on ``spec.draft``) and verifies all K+1 positions in
ONE ``decode_steps`` pass on its own schedule (each projection once over
``[max_batch * (K+1), d]``: 4 ``decode_matmul`` calls a layer and round),
with exact greedy-match acceptance (``serving/speculative.py``): the
tokens are the sequential key's, bit for bit.  Speculative keys get a
``-spec[...]`` suffix, so they never share an executor or a KV cache with
plain traffic.  For them tokens/s counts ACCEPTED tokens only, and the
tick latency is a round's (draft steps, verify pass and argmax on the
host); a round that built an executor is left out, and ``trim`` runs
outside the timed window.  Rejected work shows in the ``accept_rate`` /
``spec`` columns, and ``verify_spec_accounting`` holds ``drafted ==
accepted + rejected`` exactly.  Greedy takes the first maximum on the
host (``np.argmax`` over float32 logits) in the tick, the draft step and
the verify pass alike.

Speculation is refused (``ValueError``) for the families whose decode
state absorbs every token it sees (ssm, hybrid): nothing rolls an SSM or
RG-LRU state back past a rejected draft, so their speculative tokens
would not be the sequential key's (``ROADMAP.md`` §3: a difference from
``repro``, whose engine speculates there and loses exactness).

:meth:`LMServingEngine.last_logits` hands a caller the host logits of a
key's last tick (the array the greedy argmax read, no copy) with the
positions the tick decoded; :meth:`LMServingEngine.decode_cache` the
key's decode cache as the tick left it.  Inside a ``repro_torch.tracing.recording()``
a tick is one request: root ``engine.tick``, and for each key a plain
tick holds ``lm.stage`` (the tokens and positions gathered and copied to
the device), ``lm.step`` (the decode executor: a hybrid's
``hybrid.<mixer>`` and ``hybrid.mlp`` spans inside it), ``lm.d2h`` (the
logits' ``.cpu()``, which waits for the step) and ``lm.sample`` (the
argmax and the slots' bookkeeping).  The root's counters beside
``launches`` and ``builds``: ``rows`` (active slots), ``state_bytes``
(the keys' resident decode caches: SSM, conv, KV), ``kv_live_tokens``
(the KV positions the active slots hold after the tick, min(pos + 1,
the cache's length) each) and ``kv_held_tokens`` (slots times the KV
cache's length, what the masked attention reads).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Union)

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.config import ModelConfig
from repro_torch.core.hls import estimate_lm_decode
from repro_torch.device import require_device
from repro_torch.kernels.schedule import (DEFAULT_SCHEDULE_KEY,
                                          KernelSchedule, cache_meta,
                                          schedule_key)
from repro_torch.models.decode import (cache_specs, decode_schedulable,
                                       decode_step, init_cache,
                                       pack_decode_params)
from repro_torch.models.transformer import require_lm
from repro_torch.serving.batcher import KeyStats, _now
from repro_torch.serving.compile_cache import CachedExecutor, CompileCache
from repro_torch.serving.engine import EngineClosedError
from repro_torch.serving.speculative import (SpecConfig, SpeculativeDecoder,
                                             accept_chunk,
                                             refuse_recurrent_spec)


class TickLogits(NamedTuple):
    """A key's last tick as the host saw it: ``rows`` [max_batch, vocab]
    float32 (the array the argmax read), ``pos`` [max_batch] the position
    each slot decoded and ``active`` [max_batch] which slots took part."""

    rows: np.ndarray
    pos: np.ndarray
    active: np.ndarray


def _kv_length(cache: Mapping[str, torch.Tensor]) -> int:
    """The decode KV cache's length (the slots' positions it holds): a
    full-length cache's max_seq, a ring's window; 0 without one."""
    for name, t in cache.items():
        if name == "cache/k" or name.endswith("_k"):
            return t.shape[-3]
    return 0


@dataclass
class Slot:
    active: bool = False
    req_id: int = -1
    pos: int = 0
    tokens: List[int] = field(default_factory=list)
    max_new: int = 16
    arrival_s: float = 0.0
    prompt_len: int = 0
    observed: int = 0                   # n-gram table watermark (spec keys)


class _KeyedDecoder:
    """One schedule key's continuous-batching state: slot pool, KV cache,
    the key's single executor of the decode step (readied through the
    compile cache), serving counters.  A scheduled key runs over the
    engine's packed weight layout (``scheduled``: dense and vlm only).  A
    key with a ``SpecConfig`` (k > 0) ticks through its
    :class:`SpeculativeDecoder` instead."""

    def __init__(self, cfg: ModelConfig, key: str,
                 schedule: Optional[KernelSchedule], *, max_batch: int,
                 max_seq: int, cache_dtype: str, params: Dict,
                 packed: Optional[Dict], device: torch.device,
                 compile_cache: Optional[CompileCache] = None,
                 spec: Optional[SpecConfig] = None):
        compile_cache = compile_cache or CompileCache(device=device)
        self.spec_dec = (SpeculativeDecoder(
            cfg, key, schedule, spec, max_batch=max_batch, max_seq=max_seq,
            cache_dtype=cache_dtype, params=params, packed=packed,
            device=device, compile_cache=compile_cache)
            if spec is not None and spec.k > 0 else None)
        self.key = key
        self.cfg = cfg
        self.cache_dtype = cache_dtype
        self.schedule = schedule
        self.scheduled = schedule is not None and decode_schedulable(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = device
        self.slots = [Slot() for _ in range(max_batch)]
        self.cache = init_cache(cfg, max_batch, max_seq, cache_dtype, device)
        #: recurrent entries (an SSM or RG-LRU state, a conv tail) -> their
        #: batch axis: a claimed slot's rows start from zeros
        self.recurrent = {
            k: sp.logical_axes.index("batch")
            for k, sp in cache_specs(cfg, max_batch, max_seq,
                                     cache_dtype).items()
            if k.endswith(("state", "conv"))}
        self.kv_len = _kv_length(self.cache)
        self.last: Optional[TickLogits] = None
        self.stats = KeyStats()          # request latency
        self.tick_stats = KeyStats()     # steady-state tick latency
        self.traces = 0                  # executor builds (cold: one a key)
        self.ticks = 0
        self.tokens = 0                  # decoded tokens (per-key tokens/s)
        self.decode_s = 0.0              # wall-clock spent in decode steps
        self.packed = packed
        self._step = self._build(cfg, params, compile_cache)

    def _build(self, cfg: ModelConfig, params: Dict,
               compile_cache: CompileCache) -> Callable:
        schedule, packed = self.schedule, self.packed
        # a weak reference: the decoder holds the executor, so a callback
        # holding the decoder would keep a dropped engine's KV caches and
        # packed weights alive until the cycle collector ran
        me = weakref.ref(self)

        def built():
            me().traces += 1

        def step(cache, tokens, pos):
            with torch.inference_mode():
                return decode_step(cfg, params, cache, tokens, pos,
                                   schedule=schedule, packed=packed)

        meta = {"kind": "lm_decode_step", "cfg": repr(cfg),
                "max_batch": self.max_batch, "max_seq": self.max_seq,
                "cache_dtype": self.cache_dtype,
                **cache_meta(schedule, None)}
        return CachedExecutor(step, compile_cache, self.key, meta,
                              name_hint=f"lm-{self.key}", on_build=built)

    def warm_step(self) -> Dict:
        """Ready this key's decode step at the shapes ``_tick_decoder``
        calls it with, without ticking: the KV cache is untouched (a cold
        signature runs once, launching nothing, on a zero cache of the
        same shapes), warm over a persistent cache, build-and-store when
        cold.  A speculative key readies its verify (and draft) executor
        instead: those are the only ones its ticks run."""
        if self.spec_dec is not None:
            return self.spec_dec.warm()
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.int64,
                             device=self.device)
        pos = torch.zeros((self.max_batch,), dtype=torch.int64,
                          device=self.device)
        cache = init_cache(self.cfg, self.max_batch, self.max_seq,
                           self.cache_dtype, self.device)
        return self._step.warm(cache, tokens, pos)

    @property
    def state_bytes(self) -> int:
        """The bytes of the key's decode cache as it stands (a conv tail
        takes the wider of its and the compute dtype at the first step)."""
        return sum(t.nbytes for t in self.cache.values())

    @property
    def any_active(self) -> bool:
        return any(s.active for s in self.slots)

    def free_slot(self) -> Optional[Slot]:
        for s in self.slots:
            if not s.active:
                return s
        return None

    def restart(self, slot: Slot) -> None:
        """Zero ``slot``'s rows of the recurrent state: a request's first
        token has no past, whatever the slot's last occupant (or the idle
        ticks, which step a free slot at position 0) left there.  The KV
        cache needs nothing: a tick writes its position before attending,
        and attention masks every later one."""
        i = self.slots.index(slot)
        with torch.inference_mode():
            for k, axis in self.recurrent.items():
                self.cache[k].select(axis, i).zero_()


class LMServingEngine:
    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                 *, max_batch: int = 4, max_seq: int = 256,
                 cache_dtype: str = "float32",
                 schedule: Optional[KernelSchedule] = None,
                 device: Union[str, torch.device] = "cuda",
                 cache_dir: Optional[str] = None,
                 spec: Optional[SpecConfig] = None):
        require_lm(cfg, "LMServingEngine")
        self.device = require_device(device, "LMServingEngine")
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.schedule = schedule            # default-request schedule
        self.spec = spec                    # default-request speculation
        self.compile_cache = CompileCache(cache_dir, self.device)
        self._decoders: Dict[str, _KeyedDecoder] = {}
        self._packed: Optional[Dict] = None  # shared by the scheduled keys
        self._next_req = 0
        self._closed = False
        self._decoder_for(self.schedule)

    # -- keyed decoders ------------------------------------------------------

    def _resolve_spec(self, spec: Optional[SpecConfig]
                      ) -> Optional[SpecConfig]:
        spec = spec if spec is not None else self.spec
        spec = None if spec is None or spec.k == 0 else spec
        if spec is not None:
            refuse_recurrent_spec(self.cfg)
        return spec

    def _key_for(self, schedule: Optional[KernelSchedule],
                 spec: Optional[SpecConfig] = None) -> str:
        schedule = schedule if schedule is not None else self.schedule
        key = (DEFAULT_SCHEDULE_KEY if schedule is None
               else schedule_key(schedule))
        spec = self._resolve_spec(spec)
        if spec is not None:
            # a dash-separated suffix: KernelSchedule.from_key still parses
            # the schedule part; speculative keys never share an executor
            # or a KV cache with plain traffic on the same schedule
            key = key + "-" + spec.key_token()
        return key

    def _decoder_for(self, schedule: Optional[KernelSchedule],
                     spec: Optional[SpecConfig] = None) -> _KeyedDecoder:
        sched = schedule if schedule is not None else self.schedule
        spc = self._resolve_spec(spec)
        key = self._key_for(sched, spec)
        dec = self._decoders.get(key)
        if dec is None:
            scheduled = decode_schedulable(self.cfg) and (
                sched is not None or (spc is not None
                                      and spc.draft is not None))
            if scheduled and self._packed is None:
                self._packed = pack_decode_params(self.cfg, self.params)
            dec = self._decoders[key] = _KeyedDecoder(
                self.cfg, key, sched, max_batch=self.max_batch,
                max_seq=self.max_seq, cache_dtype=self.cache_dtype,
                params=self.params,
                packed=self._packed if scheduled else None,
                device=self.device, compile_cache=self.compile_cache,
                spec=spc)
        return dec

    def prewarm(self, schedules: Optional[List[Optional[KernelSchedule]]]
                = None, spec: Optional[SpecConfig] = None
                ) -> Dict[str, Dict]:
        """Zero-warmup for the decode path: build each schedule's keyed
        decoder (under ``spec``, else the engine's default speculation) and
        ready what its ticks run before the first tick, launching nothing:
        loaded from a warm ``cache_dir`` (no build) or built once and
        stored.  No schedules: the engine default."""
        out: Dict[str, Dict] = {}
        for sched in (schedules if schedules is not None else [None]):
            dec = self._decoder_for(sched, spec)
            out[dec.key] = dec.warm_step()
        return out

    def keys(self) -> List[str]:
        return list(self._decoders)

    def trace_count(self, key: str) -> int:
        dec = self._decoders.get(key)
        return 0 if dec is None else dec.traces

    @property
    def slots(self) -> List[Slot]:
        """The engine-default key's slot pool."""
        return self._decoder_for(None).slots

    # -- request management --------------------------------------------------

    def add_request(self, prompt: List[int], max_new: int = 16,
                    now: Optional[float] = None,
                    schedule: Optional[KernelSchedule] = None,
                    spec: Optional[SpecConfig] = None
                    ) -> Optional[int]:
        """Claim a slot on the request's (schedule, spec) key decoder; None
        when that key's pool is full (keys never borrow each other's
        slots).  ``spec=SpecConfig(k=0)`` opts out of the engine's default
        speculation."""
        if self._closed:
            raise EngineClosedError("LMServingEngine")
        dec = self._decoder_for(schedule, spec)
        s = dec.free_slot()
        if s is None:
            return None
        dec.restart(s)
        s.active = True
        s.req_id = self._next_req
        self._next_req += 1
        s.pos = 0
        s.tokens = list(prompt)
        s.max_new = max_new
        s.arrival_s = _now() if now is None else now
        s.prompt_len = len(prompt)
        s.observed = 0
        return s.req_id

    # -- one engine tick: every active slot decodes one token ----------------

    def _tick_decoder(self, dec: _KeyedDecoder,
                      now: Optional[float]) -> Dict[int, List[int]]:
        rec = tracing.ACTIVE
        if rec is not None:
            span = rec.open("lm.stage")
        tokens = np.zeros((dec.max_batch, 1), np.int64)
        pos = np.zeros((dec.max_batch,), np.int64)
        active = np.zeros((dec.max_batch,), bool)
        for i, s in enumerate(dec.slots):
            if s.active:
                tokens[i, 0] = s.tokens[s.pos]
                pos[i] = s.pos
                active[i] = True
        n_active = int(active.sum())
        t0 = time.perf_counter()
        tokens_d = torch.from_numpy(tokens).to(dec.device)
        pos_d = torch.from_numpy(pos).to(dec.device)
        if rec is not None:
            rec.close(span)
            span = rec.open("lm.step")
        logits, dec.cache = dec._step(dec.cache, tokens_d, pos_d)
        if rec is not None:
            rec.close(span)
            span = rec.open("lm.d2h")
        rows = logits[:, 0].float().cpu().numpy()   # waits for the step
        dt = time.perf_counter() - t0
        if rec is not None:
            rec.close(span)
            span = rec.open("lm.sample")
        dec.last = TickLogits(rows, pos, active)
        dec.ticks += 1
        if dec.ticks > 1:               # steady state: kernels built
            dec.decode_s += dt
            dec.tokens += n_active
            dec.tick_stats.record_one(dt)

        finished: Dict[int, List[int]] = {}
        for i, s in enumerate(dec.slots):
            if not s.active:
                continue
            if s.pos + 1 < s.prompt_len:              # teacher-force
                nxt = s.tokens[s.pos + 1]
            else:                                     # greedy: first max
                nxt = int(np.argmax(rows[i]))
                s.tokens.append(nxt)
            s.pos += 1
            if (len(s.tokens) - s.prompt_len >= s.max_new
                    or s.pos >= dec.max_seq - 1):
                finished[s.req_id] = list(s.tokens)
                s.active = False
                t = _now() if now is None else now
                dec.stats.record_one(t - s.arrival_s)
        if finished:
            dec.stats.batches += 1
        if rec is not None:
            rec.close(span)
        return finished

    # -- one speculative round: draft K, verify K+1 in one pass --------------

    def _tick_spec(self, dec: _KeyedDecoder,
                   now: Optional[float]) -> Dict[int, List[int]]:
        sd = dec.spec_dec
        if sd.table is not None:
            # feed the newly seen tokens (prompt and accepted continuations)
            # into the n-gram table before drafting this round
            for s in dec.slots:
                if s.active:
                    sd.table.observe(s.tokens, start=s.observed)
                    s.observed = len(s.tokens)
        rows: List[Optional[tuple]] = [None] * dec.max_batch
        for i, s in enumerate(dec.slots):
            if s.active:
                rows[i] = (s.tokens, s.prompt_len, s.pos)
        dec.cache, chunk, greedy, wall, built = sd.round(dec.cache, rows)
        dec.traces = sd.verify_traces
        dec.ticks += 1

        finished: Dict[int, List[int]] = {}
        emitted = 0
        keep = np.zeros((dec.max_batch,), np.int64)
        for i, s in enumerate(dec.slots):
            if not s.active:
                continue
            adv = accept_chunk(
                [int(t) for t in chunk[i]], [int(g) for g in greedy[i]],
                tokens=s.tokens, plen=s.prompt_len, pos=s.pos,
                max_new=s.max_new, max_seq=dec.max_seq)
            s.tokens.extend(adv.emitted)
            s.pos += adv.advanced
            emitted += len(adv.emitted)
            sd.drafted += adv.drafted
            sd.accepted += adv.accepted
            sd.rejected += adv.rejected
            keep[i] = s.pos
            if adv.done:
                finished[s.req_id] = list(s.tokens)
                s.active = False
                keep[i] = 0             # trim frees the whole row
                t = _now() if now is None else now
                dec.stats.record_one(t - s.arrival_s)
        if sd.spec.trim:
            # optional rollback, outside the timed window: exactness does
            # not need it (serving/speculative.py)
            dec.cache = sd.trim(dec.cache, keep)
        # steady state: ACCEPTED tokens only; a round that built an
        # executor is left out
        if not built:
            dec.decode_s += wall
            dec.tokens += emitted
            dec.tick_stats.record_one(wall)
        if finished:
            dec.stats.batches += 1
        return finished

    def tick(self, now: Optional[float] = None) -> Dict[int, List[int]]:
        """One decode step (a speculative key: one round) on every key with
        active slots; returns every request finished this tick."""
        rec = tracing.ACTIVE
        if rec is not None:
            rows, given = self._tick_counters()
            root = rec.open_call("engine.tick", rows, self.compile_cache,
                                 given)
        try:
            finished: Dict[int, List[int]] = {}
            for dec in self._decoders.values():
                if dec.any_active:
                    if dec.spec_dec is not None:
                        finished.update(self._tick_spec(dec, now))
                    else:
                        finished.update(self._tick_decoder(dec, now))
            return finished
        finally:
            if rec is not None:
                rec.close_call(root, self.compile_cache)

    def _tick_counters(self):
        """(active slots, {state_bytes, kv_live_tokens, kv_held_tokens})
        of the tick about to run, for its root span."""
        rows = live = held = state = 0
        for dec in self._decoders.values():
            state += dec.state_bytes
            held += dec.max_batch * dec.kv_len
            for s in dec.slots:
                if s.active:
                    rows += 1
                    live += min(s.pos + 1, dec.kv_len)
        return rows, {"state_bytes": state, "kv_live_tokens": live,
                      "kv_held_tokens": held}

    def last_logits(self, schedule: Optional[KernelSchedule] = None,
                    spec: Optional[SpecConfig] = None
                    ) -> Optional[TickLogits]:
        """The host logits of the (schedule, spec) key's last plain tick
        (None before its first): the array its argmax read, handed over
        without a copy, with the positions the slots decoded."""
        dec = self._decoders.get(self._key_for(schedule, spec))
        return None if dec is None else dec.last

    def decode_cache(self, schedule: Optional[KernelSchedule] = None,
                     spec: Optional[SpecConfig] = None
                     ) -> Optional[Mapping[str, torch.Tensor]]:
        """The (schedule, spec) key's decode cache as it stands (None
        before the key's first request): ``cache_specs``' entries, the
        tensors themselves, each row a slot; a tick replaces them."""
        dec = self._decoders.get(self._key_for(schedule, spec))
        return None if dec is None else dec.cache

    def run_to_completion(self, max_ticks: int = 512,
                          now: Optional[float] = None) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for _ in range(max_ticks):
            out.update(self.tick(now=now))
            if not any(d.any_active for d in self._decoders.values()):
                break
        return out

    def serve_report(self, clock_mhz: float = 200.0) -> Dict[str, Dict]:
        """Measured serving stats per schedule key: request latency, decoded
        tokens over decode wall-clock (tokens/s) and steady-state tick
        latency (host clock around a step that ends in its logits on the
        host).  A scheduled key, whose step runs the ``decode_matmul``
        kernel, pairs them with ``estimate_lm_decode`` of the SAME
        schedule object; the einsum key's ``analytical`` is None: an
        estimate must never describe kernels that did not run.  A
        speculative key adds its ``accept_rate``, ``draft_traces`` and
        ``spec`` columns (``SpeculativeDecoder.report_row``); its ticks
        are rounds and its tokens accepted tokens."""
        report: Dict[str, Dict] = {}
        for key, dec in self._decoders.items():
            measured = dec.stats.summary()
            ticks = dec.tick_stats.summary()
            measured.update({
                "tokens": float(dec.tokens),
                "decode_s": dec.decode_s,
                "tokens_per_s": (dec.tokens / dec.decode_s
                                 if dec.decode_s > 0 else 0.0),
                "ticks": float(dec.ticks),
                "tick_latency_p50_s": ticks["latency_p50_s"],
                "tick_latency_p99_s": ticks["latency_p99_s"]})
            analytical = None
            if dec.scheduled:
                analytical = estimate_lm_decode(
                    dec.schedule, self.cfg).report_row(clock_mhz)
                analytical["scheduled_kernels"] = True
            sd = dec.spec_dec
            report[key] = {"schedule": dec.schedule, "fp": None,
                           "traces": dec.traces,
                           "accept_rate": sd.accept_rate if sd else None,
                           "draft_traces": sd.draft_traces if sd else 0,
                           "spec": sd.report_row() if sd else None,
                           "measured": measured,
                           "analytical": analytical,
                           "compile": self.compile_cache.report_row(key)}
        return report

    def verify_spec_accounting(self) -> Dict[str, Dict]:
        """The exact-sum invariant for every speculative key: drafted ==
        accepted + rejected, no counter negative.  Raises AssertionError
        naming the broken key and counters; returns the per-key counters
        on success."""
        out: Dict[str, Dict] = {}
        for key, dec in self._decoders.items():
            sd = dec.spec_dec
            if sd is None:
                continue
            if sd.drafted != sd.accepted + sd.rejected:
                raise AssertionError(
                    f"speculative accounting broken for key {key}: "
                    f"drafted ({sd.drafted}) != accepted ({sd.accepted}) "
                    f"+ rejected ({sd.rejected})")
            if min(sd.drafted, sd.accepted, sd.rejected) < 0:
                raise AssertionError(
                    f"speculative accounting broken for key {key}: "
                    f"negative counter (drafted={sd.drafted}, "
                    f"accepted={sd.accepted}, rejected={sd.rejected})")
            out[key] = {"drafted": sd.drafted, "accepted": sd.accepted,
                        "rejected": sd.rejected, "rounds": sd.rounds,
                        "accept_rate": sd.accept_rate}
        return out

    # -- lifecycle -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self, max_ticks: int = 512,
              now: Optional[float] = None) -> Dict[int, List[int]]:
        """Decode every active slot on every key to completion; the engine
        stays open."""
        return self.run_to_completion(max_ticks=max_ticks, now=now)

    def close(self, max_ticks: int = 512,
              now: Optional[float] = None) -> Dict[int, List[int]]:
        """Drain, then refuse new requests (idempotent)."""
        if self._closed:
            return {}
        finished = self.drain(max_ticks=max_ticks, now=now)
        self._closed = True
        return finished
