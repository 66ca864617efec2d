"""The port's tracer (``repro_torch.tracing``) on a CPU engine: nothing is
recorded while it is off, one request gives one tree of spans sharing a
call id, the root's self time and its children add up to it to the ns,
and the root's counters (rows, launches, builds, graph replays and
captures) read their deltas.  Then the executors' CUDA graph replay
(``serving/graphs.py``): a CPU engine never captures; its capture policy,
driven on the CPU through a stand-in for the graph."""

import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.config import FixedPointConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.schedule import KernelSchedule
from repro_torch.models import rnn_tagger
from repro_torch.models.rnn_tagger import RNNTagger
from repro_torch.registry import get_config
from repro_torch.serving import graphs
from repro_torch.serving.engine import RNNServingEngine

TAG = "top-tagging-gru"
#: (span, its parent) of one request, in the order the spans open
CHILDREN = [("engine.stage", "root"), ("engine.h2d", "root"),
            ("model.forward", "root"), ("rnn.scan", "model.forward"),
            ("model.head", "model.forward"), ("engine.d2h", "root")]
ENTRIES = {"engine.predict": 4, "engine.predict_one": 1}


@pytest.fixture(scope="module")
def params():
    return dict(RNNTagger(get_config(TAG), device="cpu").weights)


@pytest.fixture
def engine(params):
    return RNNServingEngine(get_config(TAG), params, device="cpu",
                            max_batch=4)


@pytest.fixture
def x():
    return np.random.RandomState(3).randn(4, 20, 6).astype(np.float32)


def request(engine, root, x):
    """One request through the entry whose root span is ``root``."""
    if root == "engine.predict":
        return engine.predict(x)
    return engine.predict_one(x[0])


def test_off_records_nothing_and_calls_nothing(engine, x, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span site called the tracer while off")

    for name in ("open", "close", "open_call", "close_call"):
        monkeypatch.setattr(tracing.Recording, name, refuse)
    assert tracing.ACTIVE is None
    engine.predict(x)
    engine.predict_one(x[0])
    with tracing.recording() as rec:
        pass
    engine.predict(x)
    assert tracing.ACTIVE is None
    assert rec.spans == []


@pytest.mark.parametrize("root", list(ENTRIES))
def test_one_request_is_one_tree(engine, x, root):
    request(engine, root, x)                 # the signature readied
    with tracing.recording() as rec:
        request(engine, root, x)
    spans = rec.spans
    assert [s.name for s in spans] == [root] + [n for n, _ in CHILDREN]
    assert {s.call for s in spans} == {spans[0].call}
    assert spans[0].parent == -1
    for s, (_, parent) in zip(spans[1:], CHILDREN):
        assert spans[s.parent].name == (root if parent == "root" else parent)
        outer = spans[s.parent]
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    own = rec.self_ns()
    kids = sum(s.duration_ns for s in spans if s.parent == 0)
    assert own[0] + kids == spans[0].duration_ns
    assert own[0] >= 0 and min(own) >= 0
    assert spans[0].counters["rows"] == ENTRIES[root]


def test_requests_get_their_own_calls(engine, x):
    engine.predict(x)
    engine.predict_one(x[0])
    with tracing.recording() as rec:
        engine.predict(x)
        engine.predict_one(x[0])
        engine.predict(x)
    roots = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in roots] == ["engine.predict",
                                       "engine.predict_one",
                                       "engine.predict"]
    assert len({s.call for s in roots}) == 3
    for r in roots:
        assert sum(s.call == r.call for s in rec.spans) == 1 + len(CHILDREN)


@pytest.mark.parametrize("root", list(ENTRIES))
@pytest.mark.parametrize("bumps", [0, 3])
def test_launches_read_the_delta(engine, x, monkeypatch, root, bumps):
    request(engine, root, x)
    counts = dict.fromkeys(cuda.LAUNCHES, 7)
    monkeypatch.setattr(cuda, "LAUNCHES", counts)
    layer = rnn_tagger.rnn_layer

    def counted(*a, **kw):
        counts["lstm_scan"] += bumps
        return layer(*a, **kw)

    monkeypatch.setattr(rnn_tagger, "rnn_layer", counted)
    with tracing.recording() as rec:
        request(engine, root, x)
    assert rec.spans[0].counters["launches"] == bumps


@pytest.mark.parametrize("root", list(ENTRIES))
def test_builds_count_a_cold_signature_once(engine, x, root):
    with tracing.recording() as rec:
        request(engine, root, x)
        request(engine, root, x)
    roots = [s for s in rec.spans if s.parent == -1]
    assert [r.counters["builds"] for r in roots] == [1, 0]


def test_answers_equal_with_recording_on(engine, x):
    off = engine.predict(x)
    with tracing.recording():
        on = engine.predict(x)
    np.testing.assert_array_equal(off, on)


def test_an_exception_closes_the_call(engine, x, monkeypatch):
    engine.predict(x)
    layer = rnn_tagger.rnn_layer
    fail = [True]

    def flaky(*a, **kw):
        if fail.pop():
            raise RuntimeError("injected")
        return layer(*a, **kw)

    monkeypatch.setattr(rnn_tagger, "rnn_layer", flaky)
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="injected"):
            engine.predict(x)
        fail.append(False)
        engine.predict(x)
    roots = [i for i, s in enumerate(rec.spans) if s.parent == -1]
    assert len(roots) == 2
    first = rec.spans[roots[0]]
    assert [s.name for s in rec.spans[roots[0] + 1:roots[1]]] == [
        "engine.stage", "engine.h2d", "model.forward", "rnn.scan"]
    assert all(s.end_ns == first.end_ns
               for s in rec.spans[roots[0] + 3:roots[1]])
    assert [s.name for s in rec.spans[roots[1]:]] == \
        ["engine.predict"] + [n for n, _ in CHILDREN]


def test_summary_fields(engine, x):
    engine.predict(x)
    with tracing.recording() as rec:
        for _ in range(3):
            engine.predict(x)
    summary = rec.summary()
    assert set(summary) == {"engine.predict"} | {n for n, _ in CHILDREN}
    for name, row in summary.items():
        assert set(row) == {"count", "mean_us", "p50_us", "p95_us",
                            "self_us"}
        assert row["count"] == 3
        assert 0 <= row["self_us"] <= row["mean_us"]
        assert row["p50_us"] <= row["p95_us"]
    leaf = summary["engine.d2h"]
    assert leaf["self_us"] == leaf["mean_us"]
    table = tracing.format_summary(summary)
    assert table.splitlines()[0].split()[0] == "span"
    assert len(table.splitlines()) == 1 + len(summary)


def test_one_recording_at_a_time():
    with tracing.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with tracing.recording():
                pass
    assert tracing.ACTIVE is None


def test_threads_nest_their_own_spans():
    both = threading.Barrier(2)

    def work(name):
        rec = tracing.ACTIVE
        outer = rec.open(name)
        both.wait(timeout=10)
        rec.close(rec.open(name + ".inner"))
        both.wait(timeout=10)
        rec.close(outer)

    with tracing.recording() as rec:
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in rec.spans}
    for n in ("a", "b"):
        inner = by_name[n + ".inner"]
        assert rec.spans[inner.parent].name == n
        assert inner.call == by_name[n].call
        assert by_name[n].parent == -1
    assert by_name["a"].call != by_name["b"].call


def test_launch_total_sums_the_launches(monkeypatch):
    monkeypatch.setattr(cuda, "LAUNCHES", {"lstm_scan": 2, "col_matmul": 3})
    monkeypatch.setattr(cuda, "ENTRIES", {"lstm_scan": 2})
    assert cuda.launch_total() == 5
    cuda.reset_launches()
    assert cuda.launch_total() == 0


# -- CUDA graph replay (serving/graphs.py) ---------------------------------

#: the spans of a replayed request, under its root
REPLAYED = ["engine.h2d", "engine.replay", "engine.d2h"]


def counted(rec, name):
    return [s.counters[name] for s in rec.spans if s.parent == -1]


def test_cpu_engine_never_captures(engine, params, x):
    """A CPU engine keeps the eager spans on every call, replays nothing and
    answers with the bits of the tagger's forward on the same weights."""
    want = rnn_tagger.forward(get_config(TAG), params, torch.from_numpy(x),
                              impl="pallas",
                              schedule=engine.resolved_schedule).numpy()
    with tracing.recording() as rec:
        got = [engine.predict(x) for _ in range(4)]
        engine.predict_one(x[0])
    assert engine._replays == []
    assert counted(rec, "graph_replays") == [0] * 5
    assert counted(rec, "graph_captures") == [0] * 5
    for r in [i for i, s in enumerate(rec.spans) if s.parent == -1]:
        assert [s.name for s in rec.spans[r + 1:r + 1 + len(CHILDREN)]] \
            == [n for n, _ in CHILDREN]
    for g in got:
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("device,fp,kernels,want", [
    ("cuda", None, True, True),
    ("cuda", FixedPointConfig(8, 3), True, False),
    ("cuda", FixedPointConfig(16, 6), True, False),
    ("cuda", None, False, False),
    ("cpu", None, True, False),
])
def test_which_executors_capture(device, fp, kernels, want):
    assert graphs.replays(torch.device(device), fp, kernels) is want


class StandIn:
    """A CPU stand-in for :class:`graphs.CudaGraph`: static buffers, the
    forward run once at capture (whose launches the replay takes back)
    and again at each replay, counting and recording nothing then, as a
    graph's kernels run without ``cuda.launch`` or the host's spans."""

    def __init__(self, run, device_in, host_out):
        self.run, self.device_in, self.host_out = run, device_in, host_out
        host_out.copy_(run(device_in.clone()))

    def replay(self):
        before = (dict(cuda.LAUNCHES), dict(cuda.ENTRIES))
        rec, tracing.ACTIVE = tracing.ACTIVE, None
        try:
            with torch.inference_mode():
                self.host_out.copy_(self.run(self.device_in.clone()))
        finally:
            tracing.ACTIVE = rec
        cuda.count_launches(*cuda.launches_since(before), times=-1)

    def wait(self):
        pass


@pytest.fixture
def replaying(monkeypatch, params):
    """A CPU engine whose float kernel executors replay through
    :class:`StandIn`; each forward counts one ``lstm_scan`` launch."""
    monkeypatch.setattr(graphs, "replays",
                        lambda device, fp, kernels: fp is None and kernels)
    monkeypatch.setattr(graphs, "CudaGraph", StandIn)
    monkeypatch.setattr(cuda, "LAUNCHES", dict.fromkeys(cuda.LAUNCHES, 0))
    monkeypatch.setattr(cuda, "ENTRIES", {})
    monkeypatch.setattr(cuda, "GRAPHS", {"captures": 0, "replays": 0})
    layer = rnn_tagger.rnn_layer

    def launching(*a, **kw):
        cuda.LAUNCHES["lstm_scan"] += 1
        cuda.ENTRIES["lstm_scan"] = cuda.ENTRIES.get("lstm_scan", 0) + 1
        return layer(*a, **kw)

    monkeypatch.setattr(rnn_tagger, "rnn_layer", launching)
    return RNNServingEngine(get_config(TAG),
                            {k: v.clone() for k, v in params.items()},
                            device="cpu", max_batch=4)


@pytest.mark.parametrize("root", list(ENTRIES))
def test_second_call_captures_and_later_calls_replay(replaying, x, root):
    with tracing.recording() as rec:
        got = [request(replaying, root, x) for _ in range(4)]
    assert counted(rec, "graph_captures") == [0, 1, 0, 0]
    assert counted(rec, "graph_replays") == [0, 1, 1, 1]
    assert counted(rec, "launches") == [1] * 4
    assert cuda.LAUNCHES["lstm_scan"] == cuda.ENTRIES["lstm_scan"] == 4
    assert cuda.GRAPHS == {"captures": 1, "replays": 3}
    roots = [i for i, s in enumerate(rec.spans) if s.parent == -1]
    assert [s.name for s in rec.spans[roots[0] + 1:roots[1]]] == \
        [n for n, _ in CHILDREN]
    assert [s.name for s in rec.spans[roots[3] + 1:]] == REPLAYED
    assert rec.spans[roots[1] + 1].name == "engine.capture"
    assert [s.name for s in rec.spans[roots[2] + 1:roots[3]]] == REPLAYED
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])


def test_a_dry_warm_up_is_not_the_eager_call(replaying, x):
    """``prewarm`` runs the executor inside a dry ``cuda.recording``,
    which launches nothing: the first real call is still eager."""
    assert replaying.prewarm()[replaying._ensure_key(
        *replaying.resolve())]["status"] == "cold"
    with tracing.recording() as rec:
        for _ in range(3):
            replaying.predict(x)
    assert counted(rec, "graph_captures") == [0, 1, 0]
    assert counted(rec, "graph_replays") == [0, 1, 1]


def test_each_shape_captures_its_own_graph(replaying, x):
    for rows in (4, 2, 4, 2, 4):
        replaying._infer_cache[replaying._ensure_key(*replaying.resolve())](
            x[:rows])
    assert cuda.GRAPHS == {"captures": 2, "replays": 3}
    assert replaying._replays[0].graphs() == 2


def test_fp_and_ragged_calls_stay_eager(replaying, params, x):
    fixed = RNNServingEngine(get_config(TAG), params, device="cpu",
                             max_batch=4, fp=FixedPointConfig(16, 6))
    for _ in range(3):
        fixed.predict(x)
    replaying.ragged = "mask"
    for _ in range(3):
        replaying.predict_ragged([x[0], x[1][:7], x[2]])
    assert fixed._replays == []
    assert cuda.GRAPHS == {"captures": 0, "replays": 0}


def test_an_in_place_weight_update_captures_again(replaying, params, x):
    for _ in range(3):
        replaying.predict(x)
    w = replaying.model.weights["head/b"]
    with torch.no_grad():
        w.add_(0.25)
    with tracing.recording() as rec:
        got = replaying.predict(x)
        replaying.predict(x)
    assert counted(rec, "graph_captures") == [1, 0]
    assert counted(rec, "graph_replays") == [1, 1]
    moved = {k: v.clone() for k, v in params.items()}
    moved["head/b"] += 0.25
    want = RNNServingEngine(get_config(TAG), moved, device="cpu",
                            max_batch=4).predict(x)
    np.testing.assert_array_equal(got, want)


def test_replayed_answers_never_alias(replaying):
    xs = np.random.RandomState(5).randn(6, 4, 20, 6).astype(np.float32)
    want = [rnn_tagger.forward(
        get_config(TAG), replaying.params, torch.from_numpy(xi),
        impl="pallas", schedule=replaying.resolved_schedule).numpy()
        for xi in xs]
    got = [replaying.predict(xs[i % len(xs)]) for i in range(14)]
    assert cuda.GRAPHS["replays"] == 13
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % len(xs)])
        assert not any(np.shares_memory(g, h) for h in got[:i])


def test_close_drops_the_graphs(replaying, x):
    for _ in range(3):
        replaying.predict(x)
    assert replaying._replays[0].graphs() == 1
    replaying.close()
    assert replaying._replays[0].graphs() == 0
