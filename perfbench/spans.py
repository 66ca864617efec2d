"""The program's own spans in a traced run, beside the profiler's device
events: what the span metrics read, the device's idle time split by the
span open on the host, and the check that spans and device events share
one clock.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--profile 0|1] [--record 0|1]

runs a cell's window as ``perfbench/run.py --trace 1`` does, with
``repro_torch.tracing`` recording over it (``--record 0``: not), and under
``torch.profiler`` (``--profile 0``: not; the window then lasts
``--seconds``).  It prints the tracer's summary and the clock check on
standard error and one JSON line on standard output: every metric of the
cell that has something to read, the six span metrics (:data:`METRICS`),
``breakdown`` with ``idle_by_span``, ``brackets`` and ``correct``.

The program's spans come on ``time.perf_counter_ns`` with the offset the
recording read when it began; :func:`recorded` moves them onto the
profiler's wall-clock base with it.  A device operation belongs to the
request whose root span holds the host stamp of the runtime call that
issued it (the trace links the two by correlation id; host stamps and
spans share one clock).  :func:`brackets` tests the device stamps against
causal order: a request's copy to the device starts after its
``engine.h2d`` starts, each of its kernels after its ``model.forward``
starts, and its copy back ends before its ``engine.d2h`` ends.  Where the
device stamps break one, :func:`corrections` moves that request's device
operations by the least shift that mends its brackets, and
``idle_by_span`` reads the moved stamps (:func:`aligned`).  Where the
program has no tracer (a tree older than ``repro_torch.tracing``), no
span is recorded and each span metric has nothing to read.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)             # perfbench's modules load as a package
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from perfbench.trace import Window, merge  # noqa: E402

#: the span metrics and their units; each reader lives in
#: ``perfbench/metrics/<quantity>.py``
METRICS = {"engine_self_us.bulk": "us", "input_host_ms.bulk": "ms",
           "launch_host_ms.bulk": "ms", "output_wait_ms.bulk": "ms",
           "launches_per_call.bulk": "launches", "rebuilds.bulk": "builds"}
#: the root span of each request entry the traffic can call
ROOTS = ("engine.predict", "engine.predict_one")


@dataclass
class SpanWindow(Window):
    """A window with the program's spans (the tracer's ``Span`` records,
    ns on the profiler's base) and, per device operation in ``device``'s
    order, the host stamp (ns, the same base) of the runtime call that
    issued it, or None."""

    spans: List = field(default_factory=list)
    issued: List = field(default_factory=list)


def spans_of(win) -> list:
    return getattr(win, "spans", None) or []


def roots(spans: Sequence) -> list:
    """(index, span) of every request's root span."""
    return [(i, s) for i, s in enumerate(spans)
            if s.parent == -1 and s.name in ROOTS]


def per_call(win, names: Sequence[str]) -> Optional[np.ndarray]:
    """Per request: the summed duration (ns) of its spans named in
    ``names``; None where the window holds no request's spans."""
    spans = spans_of(win)
    total = {s.call: 0 for _, s in roots(spans)}
    if not total:
        return None
    for s in spans:
        if s.name in names and s.call in total:
            total[s.call] += s.end_ns - s.start_ns
    return np.array(list(total.values()), np.float64)


def root_self(win) -> Optional[np.ndarray]:
    """Per request: its root span's self time (ns), the duration less the
    part its child spans cover."""
    spans = spans_of(win)
    own = {i: s.end_ns - s.start_ns for i, s in roots(spans)}
    if not own:
        return None
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return np.array(list(own.values()), np.float64)


def counters(win, name: str) -> Optional[np.ndarray]:
    """Per request: the counter ``name`` its root span recorded."""
    got = [s.counters[name] for _, s in roots(spans_of(win))]
    return np.array(got, np.float64) if got else None


def innermost(spans: Sequence) -> list:
    """The host's time as disjoint (start, end, name) pieces, each named
    by the innermost span open over it, in order (one thread's spans)."""
    children = defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            children[s.parent].append(s)
    pieces = []
    for i, s in enumerate(spans):
        t = s.start_ns
        for c in children[i]:
            if c.start_ns > t:
                pieces.append((t, c.start_ns, s.name))
            t = max(t, c.end_ns)
        if s.end_ns > t:
            pieces.append((t, s.end_ns, s.name))
    pieces.sort()
    return pieces


def idle_by_span(win) -> list:
    """The device's idle time in the window, [[name, seconds], ...] by the
    innermost program span open on the host meanwhile (``harness`` where
    none is), most first; on the device stamps :func:`aligned` moves."""
    w0, w1 = int(win.starts[0]), int(win.ends[-1])
    busy = merge([(max(s, w0), min(e, w1)) for _, _, s, e in aligned(win)
                  if e > w0 and s < w1])
    edges = [w0, *busy.ravel().tolist(), w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    pieces = innermost(spans_of(win))
    out: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        out["harness"] += (b - a) - covered
    return [[k, v * 1e-9] for k, v in sorted(out.items(),
                                             key=lambda kv: -kv[1])]


def op_calls(win) -> Optional[np.ndarray]:
    """Per device operation: the request (its place in :func:`roots`)
    whose root span holds the host stamp of the runtime call that issued
    it, -1 where none does; None without spans or issue stamps."""
    rs = [s for _, s in roots(spans_of(win))]
    issued = getattr(win, "issued", None)
    if not rs or not issued or len(issued) != len(win.device):
        return None
    starts = np.array([s.start_ns for s in rs], np.int64)
    ends = np.array([s.end_ns for s in rs], np.int64)
    t = np.array([-1 if v is None else v for v in issued], np.int64)
    k = np.searchsorted(starts, t, side="right") - 1
    return np.where((k >= 0) & (t < ends[np.maximum(k, 0)]), k, -1)


def bracket_terms(win) -> Optional[tuple]:
    """Each checked device operation's bound on a shift of its request's
    spans: ``(call, bound, upper)`` arrays, the request (as
    :func:`op_calls`), the bound (ns) and whether it is an upper one (a
    copy in or a kernel: shift <= its start less its span's start) or a
    lower one (the copy back: shift >= its end less its ``engine.d2h``'s
    end).  None where :func:`op_calls` is."""
    calls = op_calls(win)
    if calls is None:
        return None
    kids = [{} for _ in roots(spans_of(win))]
    order = {s.call: k for k, (_, s) in enumerate(roots(spans_of(win)))}
    for s in spans_of(win):
        if s.call in order:
            kids[order[s.call]][s.name] = s
    terms = []
    for k, (name, kind, s, e) in zip(calls.tolist(), win.device):
        c = kids[k] if k >= 0 else {}
        if "HtoD" in name and "engine.h2d" in c:
            terms.append((k, s - c["engine.h2d"].start_ns, True))
        elif kind == "kernel" and "model.forward" in c:
            terms.append((k, s - c["model.forward"].start_ns, True))
        elif "DtoH" in name and "engine.d2h" in c:
            terms.append((k, e - c["engine.d2h"].end_ns, False))
    if not terms:
        return None
    call, bound, upper = zip(*terms)
    return (np.array(call, np.int64), np.array(bound, np.int64),
            np.array(upper, bool))


def corrections(win) -> Optional[np.ndarray]:
    """Per request, the shift (ns) of its spans against its device
    operations that mends its brackets, the least one (0 where they hold;
    the middle of an empty range)."""
    terms = bracket_terms(win)
    if terms is None:
        return None
    call, bound, upper = terms
    n = len(roots(spans_of(win)))
    lo = np.full(n, np.iinfo(np.int64).min)
    hi = np.full(n, np.iinfo(np.int64).max)
    np.maximum.at(lo, call[~upper], bound[~upper])
    np.minimum.at(hi, call[upper], bound[upper])
    shift = np.clip(0, lo, hi)
    empty = lo > hi
    shift[empty] = (lo[empty] + hi[empty]) // 2
    return shift


def aligned(win) -> list:
    """The device operations with each request's moved against its spans
    by :func:`corrections` (as they are where there is nothing to pair)."""
    shift, calls = corrections(win), op_calls(win)
    if shift is None:
        return list(win.device)
    return [(n, k, s - shift[c], e - shift[c]) if c >= 0 else (n, k, s, e)
            for (n, k, s, e), c in zip(win.device, calls.tolist())]


def brackets(win) -> Optional[Dict]:
    """The clock check on the profiler's stamps as they come: the checked
    device operations, those that break a causal bracket, the worst breach
    (us), ``shift_us``, the range [lo, hi] of one shift of every span that
    breaks none (empty where lo > hi); then the requests
    :func:`corrections` moves, the largest move (us), and the breaches
    left after it and the requests they fall in (those whose own brackets
    admit no shift: the device clock jumped inside them).  None where
    :func:`bracket_terms` is."""
    terms = bracket_terms(win)
    if terms is None:
        return None
    call, bound, upper = terms
    excess = np.where(upper, -bound, bound)
    bad = excess > 0
    lo = bound[~upper].max() if (~upper).any() else None
    hi = bound[upper].min() if upper.any() else None
    shift = corrections(win)
    left = np.where(upper, shift[call] - bound, bound - shift[call]) > 0
    return {"ops": len(bound), "breaches": int(bad.sum()),
            "worst_us": float(excess[bad].max()) * 1e-3 if bad.any()
            else 0.0,
            "shift_us": [None if v is None else float(v) * 1e-3
                         for v in (lo, hi)],
            "calls_moved": int((shift != 0).sum()),
            "moved_max_us": float(np.abs(shift).max()) * 1e-3,
            "breaches_after": int(left.sum()),
            "calls_unmended": len(np.unique(call[left]))}


def bracket_drift(win, slices: int = 10) -> Optional[list]:
    """[lo, hi] of :func:`brackets`'s ``shift_us`` in each of ``slices``
    equal slices of the window (by request): a clock that drifts against
    the other moves the range along the window."""
    terms = bracket_terms(win)
    if terms is None:
        return None
    call, bound, upper = terms
    part = call * slices // (call.max() + 1)
    out = []
    for k in range(slices):
        here = part == k
        lo, hi = bound[here & ~upper], bound[here & upper]
        out.append([float(lo.max()) * 1e-3 if len(lo) else None,
                    float(hi.min()) * 1e-3 if len(hi) else None])
    return out


def outside_calls(win) -> Optional[Dict]:
    """Requests whose root span is not inside the harness's span of the
    same call (paired by order), and the farthest one's excess (us)."""
    rs = [s for _, s in roots(spans_of(win))]
    if len(rs) != win.calls:
        return None
    out = np.maximum(win.starts - np.array([s.start_ns for s in rs]),
                     np.array([s.end_ns for s in rs]) - win.ends)
    return {"outside": int((out > 0).sum()),
            "worst_us": max(float(out.max()), 0.0) * 1e-3}


def issue_stamps(prof) -> list:
    """Per device operation of ``prof`` (in ``trace.device_events``'s
    order), the host start (ns) of the runtime call that issued it, by
    correlation id; None where the trace holds no such call."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != DeviceType.CUDA and e.correlation_id()}
    return [host.get(e.correlation_id()) for e in events
            if e.device_type() == DeviceType.CUDA]


@contextlib.contextmanager
def linked_device_events() -> Iterator[list]:
    """While inside, the harness's ``trace.device_events`` also fills the
    yielded list with :func:`issue_stamps` of the trace it reads."""
    from perfbench import trace

    read = trace.device_events
    issued: list = []

    def device_events(prof):
        issued[:] = issue_stamps(prof)
        return read(prof)

    trace.device_events = device_events
    try:
        yield issued
    finally:
        trace.device_events = read


def program_tracing():
    """``repro_torch.tracing``, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


@contextlib.contextmanager
def recorded(on: bool = True) -> Iterator[SimpleNamespace]:
    """The program's recording over the block.  Yields a namespace whose
    ``spans`` (on the profiler's base) and ``summary`` (the tracer's) are
    filled when the block ends; both stay empty where ``on`` is false or
    the program has no tracer."""
    got = SimpleNamespace(spans=[], summary={})
    tracing = program_tracing() if on else None
    if tracing is None:
        yield got
        return
    with tracing.recording() as rec:
        yield got
    off = rec.offset_ns
    got.spans = [s._replace(start_ns=s.start_ns + off,
                            end_ns=s.end_ns + off) for s in rec.spans]
    got.summary = rec.summary()


def span_medians(win) -> Dict[str, float]:
    """Per span name, the median over the window's requests of its time a
    request (us); the root's is its self time."""
    own = root_self(win)
    if own is None:
        return {}
    names = sorted({s.name for s in spans_of(win)} - set(ROOTS))
    out = {"engine (self)": float(np.median(own)) * 1e-3}
    for n in names:
        out[n] = float(np.median(per_call(win, (n,)))) * 1e-3
    return out


def read_span_metrics(win) -> Dict[str, Dict]:
    from perfbench import spec

    return spec.read_metrics([{"name": n, "unit": u}
                              for n, u in METRICS.items()], win)


def run_traced(cell, seed: int, seconds: float, device, profile: bool = True,
               record: bool = True) -> Dict:
    """One window of ``cell`` with the program's recording (``record``)
    and the profiler (``profile``) on: the result's fields."""
    import torch

    from perfbench import run, spec
    from perfbench.trace import breakdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    bench = run.build(cell, seed, device)
    with recorded(record) as got, linked_device_events() as issued:
        (starts, ends), dev, sample, failed, setup_s = run.window(
            bench, seconds, seed, profile)
    bench.engine = bench.call = None
    gc.unfreeze()
    gc.collect()
    checks = run.compare(bench, sample.kept)
    win = SpanWindow(cell.cfg, cell.traffic, starts, ends,
                     cell.traffic["events_per_call"], setup_s, profile, dev,
                     spans=got.spans, issued=issued)
    metrics = spec.read_metrics(cell.end_to_end + cell.per_layer, win)
    metrics.update(read_span_metrics(win))
    result = {"correct": failed == 0 and run.passed(checks),
              "attempted": win.calls, "failed": failed,
              "profile": profile, "record": record, "metrics": metrics,
              "device": {"kind": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"},
              "window_s": win.window_s,
              "span_p50_us": span_medians(win),
              "roots_outside_calls": outside_calls(win)}
    if profile:
        result["device"]["busy_s"] = win.busy_s()
        result["breakdown"] = {**breakdown(win),
                               "idle_by_span": idle_by_span(win)}
        result["brackets"] = brackets(win)
        result["bracket_drift_us"] = bracket_drift(win)
    if got.summary:
        program = program_tracing()
        print(program.format_summary(got.summary), file=sys.stderr)
    print(f"brackets: {result.get('brackets')}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    result = run_traced(spec.resolve(args.workload), args.seed,
                        args.seconds, torch.device("cuda", 0),
                        bool(args.profile), bool(args.record))
    result["seed"] = args.seed
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
