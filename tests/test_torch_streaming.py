"""The port's streaming pipeline (``repro_torch.serving.streaming``) against
``repro``'s, on the CPU.

Each scenario of ``tests/test_streaming.py`` (a 2x burst that drives the
pipeline down its degradation ladder and a 0.5x tail that brings it back,
a single rung at 2x that sheds at admission, the full fault matrix with a
backwards clock step, a flush exception on one key) is replayed with the
same seeded payloads in the same ``VirtualClock`` time through both
packages, each over its own engine (``impl="pallas"``, ``max_batch=8``)
and its own ladder (``select`` + ``degradation_ladder`` over
``pallas_interpret`` points) for ``top-tagging-gru``.  Service times are
analytic, so both replays must agree exactly on every terminal state,
rung, shed reason, ``KeyCounts`` and the simulated stage report; the
outputs agree within ``CONFORMANCE_TOL``, and the port's rung-0 results
are bit for bit its own direct ``predict``.  The property tests hold the
port's exactly-one-terminal-state and accounting laws (``deadline=None``:
the first example builds the engine's executors).
"""

import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.autotune as jautotune  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import CONFORMANCE_TOL  # noqa: E402

import repro_torch.autotune as tautotune  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.serving.streaming import STAGES  # noqa: E402

TAG = "top-tagging-gru"
CLOCK_MHZ = 200.0
TERMINAL = ("answered", "shed", "failed")


def _side(autotune, serving, cfg, params, **engine_kw):
    spec = autotune.SpaceSpec(backends=("pallas_interpret",),
                              block_batches=(8,))
    base = autotune.select(cfg, autotune.DesignTarget(
        max_dsp=400, objective="latency"), spec)
    ladder = autotune.degradation_ladder(cfg, base, spec=spec, max_rungs=3)
    return SimpleNamespace(
        serving=serving, ladder=ladder,
        engine=serving.RNNServingEngine(cfg, params, max_batch=8,
                                        **engine_kw))


@pytest.fixture(scope="module")
def harness():
    jcfg = jget_config(TAG)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(0)).items()}
    tcfg, tparams = get_config(TAG), params_from_jax(jparams, "cpu")
    r = jcfg.rnn
    xs = np.random.RandomState(0).randn(
        400, r.seq_len, r.input_size).astype(np.float32)
    sides = {"repro": _side(jautotune, jserving, jcfg, jparams,
                            impl="pallas"),
             "port": _side(tautotune, tserving, tcfg, tparams,
                           device="cpu")}
    assert [p.key for p in sides["port"].ladder] \
        == [p.key for p in sides["repro"].ladder]
    assert len(sides["port"].ladder) == 3
    return sides, xs


def _pipe(side, clk, ladder=None, **kw):
    kw.setdefault("deadline_us", 50.0)
    kw.setdefault("prewarm", False)
    kw.setdefault("clock_mhz", CLOCK_MHZ)
    return side.serving.StreamingPipeline(
        side.engine, side.ladder if ladder is None else ladder, clock=clk,
        **kw)


def _replay(pipe, clk, xs, rate_mult, base_rate=None, step_back_at=None):
    rate = base_rate if base_rate is not None else pipe._rung_rate(0)
    dt = 1.0 / (rate_mult * rate)
    reqs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, x in enumerate(xs):
            if i == step_back_at:
                clk.step_back(10 * dt)
            t = clk.advance(dt) if i else clk.t
            reqs.append(pipe.push(x, now=t))
            pipe.pump(now=t)
        pipe.drain()
    return reqs


# each scenario: (side, xs) -> (pipeline, requests)


def burst_down_and_back(side, xs):
    clk = side.serving.VirtualClock()
    pipe = _pipe(side, clk)
    base = pipe._rung_rate(0)
    reqs = _replay(pipe, clk, xs[:300], 2.0, base_rate=base)
    assert pipe.downgrades >= 1 and pipe.rung >= 1
    reqs += _replay(pipe, clk, xs[:400], 0.5, base_rate=base)
    assert pipe.recoveries >= 1 and pipe.rung == 0
    return pipe, reqs


def single_rung_sheds(side, xs):
    clk = side.serving.VirtualClock()
    pipe = _pipe(side, clk, ladder=side.ladder[:1])
    return pipe, _replay(pipe, clk, xs[:200], 2.0)


def fault_matrix(side, xs):
    clk = side.serving.VirtualClock()
    faults = (side.serving.FaultInjector()
              .stall("ingest", 1e-6, times=2, after=2)
              .stall("infer", 20e-6, after=10)
              .fail("prep", after=7)
              .fail("sink", after=15))
    pipe = _pipe(side, clk, faults=faults)
    return pipe, _replay(pipe, clk, xs[:80], 1.5, step_back_at=40)


def flush_exception(side, xs):
    from importlib import import_module

    faults = import_module(side.serving.__name__ + ".faults")
    clk = side.serving.VirtualClock()
    pipe = _pipe(side, clk, ladder=side.ladder[:1])
    reqs = _replay(pipe, clk, xs[:4], 0.5)
    flaky = faults.break_engine_key(side.engine, side.ladder[0].key, times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reqs.append(pipe.push(xs[4], now=clk.advance(1e-3)))
        pipe.drain()
    assert flaky.raised == 1
    side.engine._infer_cache[side.ladder[0].key] = flaky.real
    return pipe, reqs + _replay(pipe, clk, xs[5:12], 0.5)


SCENARIOS = (burst_down_and_back, single_rung_sheds, fault_matrix,
             flush_exception)


def _trace(pipe, reqs):
    stages = pipe.stage_report()
    return {
        "requests": [(r.status, r.rung, r.key, r.shed_reason,
                      type(r.error).__name__ if r.error else None)
                     for r in reqs],
        "accounting": pipe.verify_accounting(),
        "counts": {k: dataclasses.asdict(c) for k, c in pipe.counts.items()},
        "ladder": (pipe.rung, pipe.downgrades, pipe.recoveries, pipe.rerates,
                   pipe.clock_steps),
        "stages": {s: (sorted(row), row["sim"], row["over_budget"])
                   for s, row in stages.items()},
    }


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_stream_replay_matches_repro(harness, scenario):
    sides, xs = harness
    (jpipe, jreqs) = scenario(sides["repro"], xs)
    (tpipe, treqs) = scenario(sides["port"], xs)
    assert _trace(tpipe, treqs) == _trace(jpipe, jreqs)
    assert all(r.status in TERMINAL for r in treqs)
    tol = CONFORMANCE_TOL["float32"]
    for j, t in zip(jreqs, treqs):
        if t.status == "answered":
            want = np.asarray(j.result)
            assert float(np.abs(np.asarray(t.result) - want).max()) \
                <= tol * max(1.0, float(np.abs(want).max()))
    text = tserving.format_stream_report(tpipe)
    assert all(stage in text for stage in STAGES) and "ladder" in text


def test_rung0_results_equal_direct_predict(harness):
    sides, xs = harness
    side = sides["port"]
    clk = tserving.VirtualClock()
    pipe = _pipe(side, clk)
    reqs = _replay(pipe, clk, xs[:24], 1.0)
    assert all(r.status == "answered" and r.rung == 0 for r in reqs)
    pt = side.ladder[0]
    want = side.engine.predict(xs[:24], schedule=pt.schedule, fp=pt.fp)
    got = np.stack([r.result for r in reqs])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    one = np.stack([side.engine.predict_one(x, schedule=pt.schedule,
                                            fp=pt.fp) for x in xs[:24]])
    np.testing.assert_array_equal(one.view(np.int32), want.view(np.int32))


def test_exec_mode_one_matches_batch(harness):
    sides, xs = harness
    outs = {}
    for mode in ("batch", "one"):
        clk = tserving.VirtualClock()
        pipe = _pipe(sides["port"], clk, exec_mode=mode)
        reqs = _replay(pipe, clk, xs[:6], 0.5)
        assert all(r.status == "answered" for r in reqs)
        outs[mode] = np.stack([r.result for r in reqs]).view(np.int32)
    np.testing.assert_array_equal(outs["batch"], outs["one"])


def test_all_rungs_prewarmed_at_construction(harness):
    sides, _ = harness
    side = sides["port"]
    eng = tserving.RNNServingEngine(side.engine.cfg, side.engine.params,
                                    max_batch=8, device="cpu")
    tserving.StreamingPipeline(eng, side.ladder, deadline_us=50.0,
                               prewarm=True)
    for pt in side.ladder:
        assert eng._infer_cache[pt.key].compiled_signatures() >= 1


def test_corrupt_cache_entry_serves_with_one_warning(harness, tmp_path):
    sides, xs = harness
    side = sides["port"]
    cfg, params = side.engine.cfg, side.engine.params
    warm = tserving.RNNServingEngine(cfg, params, max_batch=8, device="cpu",
                                     cache_dir=tmp_path)
    tserving.StreamingPipeline(warm, side.ladder[:1], deadline_us=50.0,
                               prewarm=True, clock=tserving.VirtualClock())
    assert tserving.corrupt_cache_entries(tmp_path) >= 1
    eng = tserving.RNNServingEngine(cfg, params, max_batch=8, device="cpu",
                                    cache_dir=tmp_path)
    clk = tserving.VirtualClock()
    with pytest.warns(RuntimeWarning, match="quarantined"):
        pipe = tserving.StreamingPipeline(eng, side.ladder[:1],
                                          deadline_us=50.0, prewarm=True,
                                          clock=clk)
    reqs = _replay(pipe, clk, xs[:8], 0.5)
    assert all(r.status == "answered" for r in reqs)
    pt = side.ladder[0]
    want = eng.predict(xs[:8], schedule=pt.schedule, fp=pt.fp)
    np.testing.assert_array_equal(
        np.stack([r.result for r in reqs]).view(np.int32),
        want.view(np.int32))
    assert eng.compile_cache.stats(pt.key).errors == 1


@settings(max_examples=12, deadline=None)
@given(n=st.integers(5, 80), rate_pct=st.integers(25, 400),
       rungs=st.integers(1, 3), max_queue=st.integers(1, 32),
       pump_every=st.integers(1, 5), deadline_us=st.floats(2.0, 100.0))
def test_exactly_one_terminal_state_and_exact_counts(harness, n, rate_pct,
                                                     rungs, max_queue,
                                                     pump_every,
                                                     deadline_us):
    sides, xs = harness
    side = sides["port"]
    clk = tserving.VirtualClock()
    pipe = _pipe(side, clk, ladder=side.ladder[:rungs],
                 max_queue=max_queue, deadline_us=deadline_us)
    dt = 1.0 / ((rate_pct / 100.0) * pipe._rung_rate(0))
    reqs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(n):
            t = clk.advance(dt) if i else clk.t
            reqs.append(pipe.push(xs[i % len(xs)], now=t))
            if i % pump_every == 0:
                pipe.pump(now=t)
        pipe.drain()
    assert pipe.in_flight() == 0 and len(reqs) == n
    acc = pipe.verify_accounting()
    for r in reqs:
        assert r.status in TERMINAL
        if r.status == "shed":
            assert r.shed_reason is not None and r.result is None
        if r.status == "answered":
            assert r.result is not None and r.error is None
            assert r.stamps["infer"] <= r.deadline_s + 1e-12
    for key, c in acc.items():
        for status in TERMINAL:
            assert c[status] == sum(1 for r in reqs
                                    if r.key == key and r.status == status)
    assert sum(c["submitted"] for c in acc.values()) == n
