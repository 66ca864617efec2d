"""Spans and counters inside the serving path, off unless a caller turns
them on.

    from repro_torch import tracing

    with tracing.recording() as rec:
        for chunk in chunks:
            engine.predict(chunk)
    print(tracing.format_summary(rec.summary()))

A span marks one layer boundary of a request: ``engine.predict`` (or
``engine.predict_one``) is the request's root, and inside it
``engine.stage`` (``np.ascontiguousarray`` and ``torch.from_numpy``),
``engine.h2d`` (the copy to the device), ``model.forward`` (issuing the
tagger's kernels: ``rnn.scan`` and ``model.head`` inside it) and
``engine.d2h`` (``.cpu().numpy()``: the wait for the device's queue and
the copy back).  A call that replays a CUDA graph (serving/graphs.py)
holds ``engine.h2d`` (the copy into the graph's static input),
``engine.replay`` (the graph's launch) and ``engine.d2h`` (the wait and
the copy out) instead; the call that captures it ``engine.capture``
before them.  The root's self time is the engine's own work: target
and key resolution, the executor's signature lookup, ``inference_mode``.

Off, a span site costs one read of :data:`ACTIVE` and a branch on it; it
allocates nothing and calls nothing.  On, a span costs two
``time.perf_counter_ns`` reads and one entry in each column of the
recording's per-thread buffer (ints and names: nothing for the cycle
collector to walk); a root also reads, before it opens and after it closes, the counters of
its call: ``rows`` (events), ``launches`` (the port's kernel launches,
``cuda.launch_total``, a CUDA graph's replay included), ``builds``
(signatures the compile cache readied cold plus ``nvcc`` runs: a kernel
built again shows here), ``graph_replays`` (1 where the executor replayed
a CUDA graph, else 0) and ``graph_captures`` (graphs captured).  A root
may also be given counters of its own when it opens (the LM engine's
``engine.tick``: ``state_bytes``, ``kv_live_tokens``,
``kv_held_tokens``), kept as they were given.

Records stay in memory; :attr:`Recording.spans` is filled when the
recording ends, on ``time.perf_counter_ns``'s clock, with
:attr:`Recording.offset_ns` (``time.time_ns() - time.perf_counter_ns()``,
read when it began) to move them onto the wall clock that
``torch.profiler`` stamps its device events on.  Each thread nests its
own spans; a span opened with none open starts a call of its own.  A span
left open by an exception is closed by the first enclosing span to close.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import (Dict, Iterator, List, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np

from repro_torch.kernels import cuda

#: the recording every span site writes to; None (tracing off) unless
#: inside :func:`recording`
ACTIVE: Optional["Recording"] = None


class Span(NamedTuple):
    name: str
    start_ns: int        # time.perf_counter_ns
    end_ns: int
    parent: int          # index of the enclosing span in ``spans``, or -1
    call: int            # shared by every span of one request
    counters: Mapping[str, int]   # a root's COUNTERS; else {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


def _wall_offset(reads: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the wall-clock
    read that the two ``perf_counter_ns`` reads around it bracket most
    tightly of ``reads`` tries (a read delayed between the two clocks
    would move the offset by the delay)."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


#: the counters a root span reads at its edges, in order (``rows`` is
#: given at its open)
COUNTERS = ("rows", "launches", "builds", "graph_replays", "graph_captures")


def _counts(cache) -> Tuple[int, int, int, int]:
    """launches, builds, graph replays, graph captures, so far."""
    return (cuda.launch_total(), cache.cold_compiles + cuda.COUNTS["nvcc"],
            cuda.GRAPHS["replays"], cuda.GRAPHS["captures"])


class _Buffer:
    """One thread's spans, a column each (ints and names only: a span
    allocates no object the cycle collector would have to walk)."""

    def __init__(self):
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []       # 0 while open
        self.parents: List[int] = []    # index in this buffer, or -1
        self.calls: List[int] = []
        self.stack: List[int] = []      # the open spans, innermost last
        #: root index -> its place in ``counts``: rows, then the other
        #: COUNTERS (the readings at its open; their deltas once closed),
        #: then 1 once closed by :meth:`Recording.close_call`
        self.counted: Dict[int, int] = {}
        self.counts: List[int] = []
        #: root index -> the counters given when it opened
        self.given: Dict[int, Mapping[str, int]] = {}


class Recording:
    """The spans of one :func:`recording` block.  Span sites call
    :meth:`open` / :meth:`close` (and :meth:`open_call` /
    :meth:`close_call` at a request's root) on one thread; a reader reads
    :attr:`spans` once the block has ended."""

    def __init__(self):
        self.offset_ns = _wall_offset()
        self.spans: List[Span] = []
        self._calls = itertools.count()
        self._local = threading.local()
        self._buffers: List[_Buffer] = []
        self._lock = threading.Lock()

    def _new_buffer(self) -> _Buffer:
        buf = self._local.buf = _Buffer()
        with self._lock:
            self._buffers.append(buf)
        return buf

    def open(self, name: str) -> int:
        """Open a span inside the innermost one open on this thread; the
        handle goes to :meth:`close`."""
        try:
            buf = self._local.buf
        except AttributeError:          # this thread's first span
            buf = self._new_buffer()
        stack = buf.stack
        i = len(buf.names)
        if stack:
            parent = stack[-1]
            call = buf.calls[parent]
        else:
            parent, call = -1, next(self._calls)
        buf.names.append(name)
        buf.parents.append(parent)
        buf.calls.append(call)
        buf.ends.append(0)
        stack.append(i)
        buf.starts.append(time.perf_counter_ns())
        return i

    def close(self, i: int) -> None:
        """Close span ``i`` and every span still open inside it."""
        now = time.perf_counter_ns()
        buf = self._local.buf
        stack, ends = buf.stack, buf.ends
        while stack:
            top = stack.pop()
            ends[top] = now
            if top == i:
                break

    def open_call(self, name: str, rows: int, cache,
                  given: Optional[Mapping[str, int]] = None) -> int:
        """Open a request's root span: ``cache`` is the engine's
        ``CompileCache``, whose cold count ``builds`` reads; ``given``,
        counters of this request read by its caller (kept as given)."""
        counts = _counts(cache)
        i = self.open(name)
        buf = self._local.buf
        if given:
            buf.given[i] = given
        buf.counted[i] = len(buf.counts)
        buf.counts.append(rows)
        buf.counts.extend(counts)
        buf.counts.append(0)
        return i

    def close_call(self, i: int, cache) -> None:
        self.close(i)
        counts = _counts(cache)
        buf = self._local.buf
        j, c = buf.counted[i] + 1, buf.counts
        for k, n in enumerate(counts):
            c[j + k] = n - c[j + k]
        c[j + len(counts)] = 1

    def _finish(self) -> None:
        # a span still open (on another thread) when the recording ends
        # is left out, and its children become roots
        spans: List[Span] = []
        for buf in self._buffers:
            index = {}
            for i, end in enumerate(buf.ends):
                if not end:
                    continue
                index[i] = len(spans)
                j = buf.counted.get(i)
                n = len(COUNTERS)
                counters = ({} if j is None or not buf.counts[j + n] else
                            dict(zip(COUNTERS, buf.counts[j:j + n]),
                                 **buf.given.get(i, {})))
                spans.append(Span(buf.names[i], buf.starts[i], end,
                                  index.get(buf.parents[i], -1),
                                  buf.calls[i], counters))
        self.spans = spans
        self._buffers = []

    def self_ns(self) -> List[int]:
        """Each span's duration less the part its child spans cover."""
        out = [s.duration_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.duration_ns
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, the duration's ``mean_us``,
        ``p50_us`` and ``p95_us``, and ``self_us``, the mean self time."""
        by_name: Dict[str, tuple] = {}
        for s, own in zip(self.spans, self.self_ns()):
            durs, selfs = by_name.setdefault(s.name, ([], []))
            durs.append(s.duration_ns)
            selfs.append(own)
        out = {}
        for name, (durs, selfs) in by_name.items():
            d = np.asarray(durs, np.float64) * 1e-3
            out[name] = {"count": len(d), "mean_us": float(d.mean()),
                         "p50_us": float(np.percentile(d, 50)),
                         "p95_us": float(np.percentile(d, 95)),
                         "self_us": float(
                             (np.asarray(selfs, np.float64) * 1e-3).mean())}
        return out


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span opened inside the block; the spans are on the
    yielded :class:`Recording` once the block ends.  One recording at a
    time."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a tracing recording is already on")
    rec = ACTIVE = Recording()
    try:
        yield rec
    finally:
        ACTIVE = None
        rec._finish()


def format_summary(summary: Mapping[str, Mapping[str, float]]) -> str:
    """:meth:`Recording.summary` as a table, one span name a line."""
    lines = [f"{'span':16s} {'count':>7s} {'mean us':>9s} {'p50 us':>9s} "
             f"{'p95 us':>9s} {'self us':>9s}"]
    for name, r in summary.items():
        lines.append(f"{name:16s} {r['count']:7d} {r['mean_us']:9.2f} "
                     f"{r['p50_us']:9.2f} {r['p95_us']:9.2f} "
                     f"{r['self_us']:9.2f}")
    return "\n".join(lines)
