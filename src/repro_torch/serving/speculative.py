"""Speculative decode on the scheduled step: draft cheap, verify dense.

The port of ``repro/serving/speculative.py``.  The paper's central trade
is reuse factor R against initiation interval: high-R schedules are slow
per step but nearly free in resources.  Speculative decoding exploits the
asymmetry: draft K tokens a round on a cheap schedule (a high-R LM decode
step, or an n-gram :class:`CacheTable` whose drafts cost nothing), then
verify all K+1 positions in ONE pass on the dense schedule
(:func:`repro_torch.models.decode.decode_steps`).  Acceptance is an exact
greedy match: a draft token survives only if it equals the argmax the
verify pass produced at the position before it, so the emitted tokens are
those of sequential greedy decode.  Speculation changes how many
sequential steps the wall clock pays for, never the tokens.

That rests on the verify pass giving the sequential step's logits bit for
bit at every position (``decode_steps``: on the card and on the CPU), and
on every argmax here being the host's ``np.argmax`` over float32 logits,
which takes the FIRST maximum, as the sequential engine tick does: a tie
never resolves one way in the draft or verify pass and another in the
tick.

KV-cache correctness without rollback: each round's verify writes the
whole window ``[pos, pos+K]`` a row, and a row advances by at most K+1, so
the next round's window covers (and overwrites) any stale wrong-branch
entry before a query can attend to it.  ``kv_trim`` (rollback to the
accepted frontier) is optional hygiene, ``SpecConfig(trim=True)``.

That exactness also needs every piece of decode state to be either
written per position (a KV cache: the verify window rewrites what a
rejected draft left) or untouched by decode (an encoder cache).  An SSM or
RG-LRU state absorbs every token it sees, drafts included, and nothing
rolls it back, so :func:`refuse_recurrent_spec` refuses speculation on
the ssm and hybrid families (``repro`` speculates there and its tokens
then differ from sequential decode once a draft is rejected).  moe and
enc-dec keep it (their verify pass unrolls the sequential step), vlm runs
the dense verify pass.

The ``CacheTable`` is a suffix-keyed n-gram table with LRU eviction over
contexts and a short most-recently-promoted candidate row per context:
accepted continuations move to the front, so hot loops in the stream
draft themselves.

:class:`SpeculativeDecoder` keeps one executor for the verify pass
(``decode_steps`` over the fixed ``[max_batch, k+1]`` chunk) and, for a
model draft, one for the draft step (``decode_step`` on ``spec.draft``),
each readied through the compile cache (``serving/compile_cache.py``) as
the engine's step is.  Both run over the engine's one packed weight
layout: the port's pack does not depend on the schedule.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.schedule import KernelSchedule, cache_meta
from repro_torch.models.decode import (decode_step, decode_steps,
                                       init_cache, kv_trim)
from repro_torch.serving.compile_cache import CachedExecutor, CompileCache


# ---------------------------------------------------------------------------
# configuration

#: families whose decode state absorbs every token (no rollback exists)
RECURRENT_STATE_FAMILIES = ("ssm", "hybrid")


def refuse_recurrent_spec(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for speculative decode on a family whose decode
    state absorbs every token: a verify pass would advance the SSM / RG-LRU
    state through drafts that may be rejected, and no rollback restores
    it, so the tokens would not be sequential greedy decode's."""
    if cfg.family in RECURRENT_STATE_FAMILIES:
        raise ValueError(
            f"speculative decode on {cfg.name!r} ({cfg.family}): its "
            f"recurrent decode state absorbs every drafted token and cannot "
            f"be rolled back past a rejected one, so the tokens would differ "
            f"from sequential decode; serve it with spec=None or "
            f"SpecConfig(k=0)")


@dataclass(frozen=True)
class SpecConfig:
    """Per-key speculative-decode configuration.

    ``k`` draft tokens a round (``k=0`` disables speculation: the key
    decodes sequentially, bit for bit the plain engine path).  ``draft`` is
    the cheap schedule the model-draft steps run on; ``None`` selects the
    free n-gram ``CacheTable`` draft instead.  ``trim`` also rolls the KV
    cache back to the accepted frontier after every round (optional
    hygiene, not needed for exactness)."""

    k: int = 4
    draft: Optional[KernelSchedule] = None
    ngram_n: int = 3
    capacity: int = 4096
    lru_size: int = 4
    trim: bool = False

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"k must be >= 0, got {self.k}")
        if self.ngram_n < 1:
            raise ValueError(f"ngram_n must be >= 1, got {self.ngram_n}")
        if self.capacity < 1 or self.lru_size < 1:
            raise ValueError("capacity and lru_size must be >= 1")

    def key_token(self) -> str:
        """Dash-free serving-key suffix: appended to the schedule key as
        ``<schedule_key>-spec[...]``, it must survive a round trip through
        ``KernelSchedule.from_key`` (which ignores unknown dash-separated
        tokens), so no dash may appear inside."""
        if self.k == 0:
            return ""
        if self.draft is None:
            d = f"ngram{self.ngram_n}"
        else:
            d = "draft[" + self.draft.key().replace("-", "_") + "]"
        t = "_trim" if self.trim else ""
        return f"spec[k{self.k}_{d}{t}]"


# ---------------------------------------------------------------------------
# n-gram draft table (suffix-keyed, LRU-evicted, promoted on accept)


class CacheTable:
    """Bounded n-gram -> continuation table.

    Keys are ``n``-token context tuples; each maps to a short list of
    candidate next tokens, most recently promoted first (at most
    ``lru_size`` a context).  The table holds at most ``capacity``
    contexts; inserting past that evicts the least recently used context.
    Lookups and inserts both count as a use.  Invariants:
    ``len(table) <= capacity``; a candidate row holds no duplicates; a
    just-inserted (context, token) pair is an immediate hit; eviction is
    exactly LRU over contexts."""

    def __init__(self, n: int = 3, capacity: int = 1024, lru_size: int = 4):
        if n < 1 or capacity < 1 or lru_size < 1:
            raise ValueError("n, capacity and lru_size must all be >= 1")
        self.n = n
        self.capacity = capacity
        self.lru_size = lru_size
        self._table: "OrderedDict[Tuple[int, ...], List[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._table)

    def candidates(self, context: Sequence[int]) -> List[int]:
        return list(self._table.get(tuple(int(t) for t in context), ()))

    def insert(self, context: Sequence[int], nxt: int) -> None:
        ctx = tuple(int(t) for t in context)
        if len(ctx) != self.n:
            return                      # only n-length suffixes are keys
        t = int(nxt)
        row = self._table.get(ctx)
        if row is None:
            self._table[ctx] = [t]
            if len(self._table) > self.capacity:
                self._table.popitem(last=False)     # LRU context out
                self.evictions += 1
            return
        self._table.move_to_end(ctx)
        if t in row:                    # promote, never duplicate
            row.remove(t)
        row.insert(0, t)
        while len(row) > self.lru_size:
            row.pop()                   # least recently promoted candidate

    def lookup(self, context: Sequence[int]) -> Optional[int]:
        ctx = tuple(int(t) for t in context)
        row = self._table.get(ctx)
        if not row:
            self.misses += 1
            return None
        self.hits += 1
        self._table.move_to_end(ctx)    # a lookup is a use
        return row[0]

    def observe(self, tokens: Sequence[int], start: int = 0) -> None:
        """Feed every (n-gram suffix -> next token) pair of ``tokens``
        whose target index is ``>= start`` (the caller's watermark, so a
        growing stream is observed incrementally)."""
        toks = [int(t) for t in tokens]
        for j in range(max(int(start), self.n), len(toks)):
            self.insert(toks[j - self.n:j], toks[j])

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        """K speculative continuations of ``tokens``: chained MRU lookups on
        the rolling n-token suffix; on a miss, repeat the last token (a
        bet that costs nothing when wrong: the verify pass's own token
        takes its place)."""
        toks = [int(t) for t in tokens]
        ctx = toks[-self.n:]
        last = toks[-1] if toks else 0
        out: List[int] = []
        for _ in range(int(k)):
            cand = self.lookup(ctx) if len(ctx) == self.n else None
            t = last if cand is None else int(cand)
            out.append(t)
            ctx = (ctx + [t])[-self.n:]
            last = t
        return out


# ---------------------------------------------------------------------------
# exact greedy-match acceptance


@dataclass
class RowAdvance:
    """Outcome of one row's acceptance walk over a verified chunk."""

    emitted: List[int]
    advanced: int
    drafted: int
    accepted: int
    rejected: int
    done: bool


def accept_chunk(inputs: Sequence[int], greedy: Sequence[int], *,
                 tokens: Sequence[int], plen: int, pos: int,
                 max_new: int, max_seq: int = 1 << 30) -> RowAdvance:
    """Walk one row's verified chunk exactly as the sequential engine tick
    would have: ``inputs[i]`` is the token fed at position ``pos+i``,
    ``greedy[i]`` the verify pass's argmax there.  Teacher-force inside
    the prompt, emit greedy tokens after it, and stop at the first
    position whose fed token does not match: everything after a mismatch
    is a wrong-branch draft.  ``drafted`` counts every speculative input
    of the chunk (``pos+i >= len(tokens)``); ``accepted`` those consumed
    matching; ``rejected = drafted - accepted`` exactly.

    The advance / done logic is the sequential tick's: emit iff the next
    position leaves the prompt; done when ``max_new`` fresh tokens exist
    or the row reaches ``max_seq - 1``."""
    S = len(inputs)
    toks = list(tokens)
    n_tok = len(toks)
    drafted = sum(1 for i in range(1, S) if pos + i >= n_tok)
    emitted: List[int] = []
    advanced = accepted = 0
    n = n_tok
    p = pos
    done = False
    for i in range(S):
        nxt = int(toks[p + 1]) if p + 1 < plen else int(greedy[i])
        if p + 1 >= plen:
            emitted.append(nxt)
            n += 1
        p += 1
        advanced += 1
        done = (n - plen >= max_new) or (p >= max_seq - 1)
        if done or i + 1 >= S:
            break
        if int(inputs[i + 1]) != nxt:
            break                       # first rejection: stop the walk
        if pos + i + 1 >= n_tok:
            accepted += 1               # a draft was consumed matching
    return RowAdvance(emitted=emitted, advanced=advanced, drafted=drafted,
                      accepted=accepted, rejected=drafted - accepted,
                      done=done)


def _host(a: Union[np.ndarray, torch.Tensor, Sequence[float]]) -> np.ndarray:
    """Logits on the host as float32 (a tensor on any device, or an array):
    the one place an argmax is taken."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def speculative_generate(step_fn: Callable[[List[int]], object],
                         prompt: Sequence[int], max_new: int, *,
                         k: int = 4,
                         draft_fn: Optional[Callable[[List[int], int],
                                                     Sequence[int]]] = None,
                         table: Optional[CacheTable] = None,
                         max_seq: int = 1 << 30
                         ) -> Tuple[List[int], Dict[str, int]]:
    """Reference speculative loop over a stateless next-token oracle
    (``step_fn(context) -> logits``, an array or a tensor on any device),
    for conformance against the plain sequential greedy loop, fixed-point
    oracles (native int8) included, where the engine's KV path does not
    apply.  Returns the generated tokens (those of sequential greedy, by
    the exact-match rule) and the drafted / accepted / rejected / rounds
    counters."""
    if k > 0 and draft_fn is None and table is None:
        table = CacheTable()
    toks = [int(t) for t in prompt]
    plen = len(toks)
    stats = {"drafted": 0, "accepted": 0, "rejected": 0, "rounds": 0}
    observed = 0
    while len(toks) - plen < max_new and len(toks) < max_seq:
        if table is not None:
            table.observe(toks, start=observed)
            observed = len(toks)
        pos = len(toks) - 1
        if k > 0:
            drafts = (list(draft_fn(toks, k)) if draft_fn is not None
                      else table.draft(toks, k))[:k]
        else:
            drafts = []
        inputs = [toks[-1]] + [int(d) for d in drafts]
        greedy: List[int] = []
        ctx = list(toks)
        for i, t in enumerate(inputs):
            if i > 0:
                ctx = ctx + [int(t)]
            greedy.append(int(np.argmax(_host(step_fn(ctx)))))
        adv = accept_chunk(inputs, greedy, tokens=toks, plen=plen, pos=pos,
                           max_new=max_new, max_seq=max_seq)
        toks.extend(adv.emitted)
        stats["drafted"] += adv.drafted
        stats["accepted"] += adv.accepted
        stats["rejected"] += adv.rejected
        stats["rounds"] += 1
        if adv.done:
            break
    return toks[plen:], stats


# ---------------------------------------------------------------------------
# the engine-side decoder: one executor each for draft and verify


class SpeculativeDecoder:
    """Executors and counters for one serving key's speculative rounds.

    Owns the verify executor (``decode_steps`` over the fixed
    ``[max_batch, k+1]`` chunk, built once: ``verify_traces``) and, for a
    model draft, the draft executor (``decode_step`` on ``spec.draft``:
    ``draft_traces``), both over ``params`` and the engine's ``packed``
    layout, on ``device``.  The KV cache stays the keyed decoder's:
    :meth:`round` threads it through the draft steps and the verify pass
    and hands it back.  ``draft_steps`` counts the model-draft steps run
    (each launches what a sequential tick on ``spec.draft`` launches)."""

    def __init__(self, cfg: ModelConfig, key: str,
                 schedule: Optional[KernelSchedule], spec: SpecConfig, *,
                 max_batch: int, max_seq: int, cache_dtype: str,
                 params: Dict, packed: Optional[Dict] = None,
                 device: Union[str, torch.device] = "cuda",
                 compile_cache: Optional[CompileCache] = None):
        if spec.k < 1:
            raise ValueError("SpeculativeDecoder needs k >= 1 "
                             "(k=0 means speculation is disabled)")
        refuse_recurrent_spec(cfg)
        self.cfg = cfg
        self.key = key
        self.schedule = schedule
        self.spec = spec
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self.verify_traces = 0
        self.draft_traces = 0
        self.draft_steps = 0
        self.drafted = 0
        self.accepted = 0
        self.rejected = 0
        self.rounds = 0
        self.table = (CacheTable(spec.ngram_n, spec.capacity, spec.lru_size)
                      if spec.draft is None else None)
        cache = compile_cache or CompileCache(device=self.device)

        # weak: the decoder holds these executors (see _KeyedDecoder._build)
        me = weakref.ref(self)

        def verify_built():
            me().verify_traces += 1

        def draft_built():
            me().draft_traces += 1

        def verify(kv, tokens, pos):
            with torch.inference_mode():
                return decode_steps(cfg, params, kv, tokens, pos,
                                    schedule=schedule, packed=packed)

        common = {"cfg": repr(cfg), "max_batch": max_batch,
                  "max_seq": max_seq, "cache_dtype": cache_dtype,
                  "spec": spec.key_token()}
        self._verify = CachedExecutor(
            verify, cache, key,
            {"kind": "lm_decode_steps", "chunk": spec.k + 1, **common,
             **cache_meta(schedule, None)},
            name_hint=f"lmverify-{key}", on_build=verify_built)

        self._draft = None
        if spec.draft is not None:
            def draft_step(kv, tokens, pos):
                with torch.inference_mode():
                    return decode_step(cfg, params, kv, tokens, pos,
                                       schedule=spec.draft, packed=packed)

            self._draft = CachedExecutor(
                draft_step, cache, key,
                {"kind": "lm_draft_step", **common,
                 **cache_meta(spec.draft, None)},
                name_hint=f"lmdraft-{key}", on_build=draft_built)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- warm-up -------------------------------------------------------------

    def warm(self) -> Dict[str, Dict]:
        """Ready this key's verify (and draft) executor at the shapes
        :meth:`round` calls them with, without running a round: nothing is
        launched and the key's KV cache is untouched (a cold signature runs
        once, dry, on a zero cache of the same shapes)."""
        B = self.max_batch
        kv = init_cache(self.cfg, B, self.max_seq, self.cache_dtype,
                        self.device)
        pos = torch.zeros((B,), dtype=torch.int64, device=self.device)
        vtok = torch.zeros((B, self.spec.k + 1), dtype=torch.int64,
                           device=self.device)
        out = {"verify": self._verify.warm(kv, vtok, pos)}
        if self._draft is not None:
            out["draft"] = self._draft.warm(kv, vtok[:, :1], pos)
        return out

    # -- one speculative round -----------------------------------------------

    def round(self, kv: Dict,
              rows: Sequence[Optional[Tuple[Sequence[int], int, int]]]
              ) -> Tuple[Dict, np.ndarray, np.ndarray, float, bool]:
        """Draft and verify one chunk for every row.  ``rows[b]`` is
        ``(tokens, prompt_len, pos)`` for an active slot, None otherwise.
        Returns ``(kv, chunk [B,S], greedy [B,S], wall_s, built)``: the
        caller runs :func:`accept_chunk` a row and applies the advances;
        ``built`` flags a round that built an executor (left out of
        steady-state tokens/s).  ``wall_s`` is host time from the first
        draft to the verify pass's argmax on the host."""
        B, S = self.max_batch, self.spec.k + 1
        chunk = np.zeros((B, S), np.int64)
        posv = np.zeros((B,), np.int64)
        known = np.full((B,), S, np.int64)      # inactive rows: no drafts
        t0 = time.perf_counter()
        builds0 = self.verify_traces + self.draft_traces
        for b, row in enumerate(rows):
            if row is None:
                continue
            toks, _plen, pos = row
            posv[b] = pos
            nk = min(S, len(toks) - pos)        # known (non-draft) prefix
            chunk[b, :nk] = [int(t) for t in toks[pos:pos + nk]]
            known[b] = nk
        if self.table is not None:
            for b, row in enumerate(rows):
                if row is None or known[b] >= S:
                    continue
                toks, _plen, _pos = row
                nk = int(known[b])
                prefix = [int(t) for t in toks[:int(posv[b]) + nk]]
                chunk[b, nk:] = self.table.draft(prefix, S - nk)
        elif self._draft is not None and int(known.min()) < S:
            for i in range(1, S):
                dlog, kv = self._draft(kv, self._tensor(chunk[:, i - 1:i]),
                                       self._tensor(posv + (i - 1)))
                self.draft_steps += 1
                need = known <= i               # rows drafting position i
                if need.any():
                    nxt = np.argmax(_host(dlog[:, 0]), axis=-1)
                    chunk[:, i] = np.where(need, nxt, chunk[:, i])
        logits, kv = self._verify(kv, self._tensor(chunk),
                                  self._tensor(posv))
        greedy = np.argmax(_host(logits), axis=-1)  # waits for the pass
        wall = time.perf_counter() - t0
        built = (self.verify_traces + self.draft_traces) != builds0
        self.rounds += 1
        return kv, chunk, greedy, wall, built

    def trim(self, kv: Dict, keep: np.ndarray) -> Dict:
        """Optional post-round rollback to the accepted frontier."""
        if not self.spec.trim:
            return kv
        return kv_trim(kv, self._tensor(keep.astype(np.int64)))

    @property
    def accept_rate(self) -> Optional[float]:
        return (self.accepted / self.drafted) if self.drafted else None

    def report_row(self) -> Dict[str, object]:
        return {"k": self.spec.k,
                "draft": (None if self.spec.draft is None
                          else self.spec.draft.key()),
                "ngram_n": self.spec.ngram_n if self.spec.draft is None
                else None,
                "trim": self.spec.trim,
                "rounds": self.rounds,
                "drafted": self.drafted,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "accept_rate": self.accept_rate,
                "verify_traces": self.verify_traces,
                "draft_traces": self.draft_traces,
                "table_hits": self.table.hits if self.table else None,
                "table_misses": self.table.misses if self.table else None}
