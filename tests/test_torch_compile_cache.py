"""The port's persistent compile cache (``repro_torch.serving.compile_cache``)
on the CPU, through the scenarios of ``tests/test_compile_cache.py``.

An entry holds what a first request pays for: the CUDA libraries its path
launches and the launch layouts its shapes resolve to (on the CPU, where
the kernels' plain versions run, both are empty), never a result.  A warm
start builds no executor (``trace_count`` 0), answers bit for bit as the
uncached path, and ``prewarm`` launches nothing.  The served answers are
held to ``repro``'s engine within ``CONFORMANCE_TOL``.
"""

import json
import threading
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL  # noqa: E402

from repro_torch.autotune import DesignTarget, SpaceSpec, explore  # noqa: E402,E501
from repro_torch.config import FixedPointConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule, schedule_key  # noqa: E402,E501
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.serving import (ArgSpec, CachedExecutor,  # noqa: E402
                                 CompileCache, RNNServingEngine,
                                 corrupt_cache_entries)
from repro_torch.serving import compile_cache as cc  # noqa: E402
from repro_torch.serving.compile_cache import CACHE_SUFFIX  # noqa: E402

TAG = "top-tagging-gru"
SCHED = KernelSchedule(reuse_factor=2, mode="static", block_batch=4,
                       backend="pallas_interpret")
GLOB = f"*{CACHE_SUFFIX}"


@pytest.fixture(scope="module")
def tagger():
    jcfg = jget_config(TAG)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(0)).items()}
    return jcfg, jparams, get_config(TAG), params_from_jax(jparams, "cpu")


@pytest.fixture
def x():
    return np.random.RandomState(3).randn(4, 20, 6).astype(np.float32)


def _engine(tagger, cache_dir=None, **kw):
    kw.setdefault("max_batch", 4)
    return RNNServingEngine(tagger[2], tagger[3], device="cpu",
                            cache_dir=cache_dir, **kw)


def _serve_once(eng, x, schedule=SCHED, fp=None):
    reqs = [eng.submit(x[i], schedule=schedule, fp=fp)
            for i in range(x.shape[0])]
    eng.flush(force=True)
    assert all(r.status == "answered" for r in reqs)
    return np.stack([r.result for r in reqs])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_cold_then_warm_engine_builds_nothing_bit_identical(tagger, x,
                                                            tmp_path):
    key = schedule_key(SCHED)
    cold = _engine(tagger, cache_dir=tmp_path)
    got_cold = _serve_once(cold, x)
    assert cold.trace_count(key) == 1
    row = cold.serve_report()[key]["compile"]
    assert (row["cold"], row["warm"]) == (1, 0)
    assert row["first_compile_s"] > 0
    entries = list(tmp_path.glob(GLOB))
    assert len(entries) == 1 and not list(tmp_path.glob("*.tmp.*"))
    doc = json.loads(entries[0].read_text())
    assert doc["libraries"] == {} and doc["layouts"] == []   # CPU: none
    assert doc["meta"]["platform"] == "cpu"

    warm = _engine(tagger, cache_dir=tmp_path)
    got_warm = _serve_once(warm, x)
    assert warm.trace_count(key) == 0
    assert warm.compile_cache.cold_compiles == 0
    row = warm.serve_report()[key]["compile"]
    assert (row["warm"], row["hit_rate"]) == (1, 1.0)

    plain = _engine(tagger)                        # no cache_dir
    got_plain = _serve_once(plain, x)
    assert plain.trace_count(key) == 1
    np.testing.assert_array_equal(_bits(got_cold), _bits(got_plain))
    np.testing.assert_array_equal(_bits(got_warm), _bits(got_plain))
    jeng = JEngine(tagger[0], tagger[1], impl="xla", max_batch=4)
    want = jeng.predict(x)
    tol = CONFORMANCE_TOL["float32"] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got_warm - want).max()) <= tol


def test_corrupted_entry_warns_once_quarantines_and_builds_cold(tagger, x,
                                                                 tmp_path):
    key = schedule_key(SCHED)
    want = _serve_once(_engine(tagger, cache_dir=tmp_path), x)
    assert corrupt_cache_entries(tmp_path) == 1

    eng = _engine(tagger, cache_dir=tmp_path)
    with pytest.warns(RuntimeWarning, match="quarantined") as caught:
        got = _serve_once(eng, x)
    assert len([w for w in caught if "unusable" in str(w.message)]) == 1
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert eng.trace_count(key) == 1               # one cold build
    row = eng.serve_report()[key]["compile"]
    assert row["errors"] == 1 and row["cold"] == 1
    assert not eng.compile_cache._quarantine       # the store lifted it
    fresh = _engine(tagger, cache_dir=tmp_path)
    np.testing.assert_array_equal(_bits(_serve_once(fresh, x)), _bits(want))
    assert fresh.trace_count(key) == 0


def test_quarantined_entry_is_skipped_silently(tmp_path):
    cache = CompileCache(tmp_path, device="cpu")
    meta = {"kind": "t"}
    cache.entry_path("e", meta).write_bytes(b"\x00garbage\x00")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert cache.load("e", meta, "k") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cache.load("e", meta, "k") is None
        assert cache.load("e", meta, "k") is None
    st = cache.stats("k")
    assert (st.errors, st.quarantined) == (1, 2)


def test_stale_metadata_is_never_served(tagger, x, tmp_path):
    _serve_once(_engine(tagger, cache_dir=tmp_path), x)
    entry = next(iter(tmp_path.glob(GLOB)))
    doc = json.loads(entry.read_text())
    doc["meta"]["torch"] = "0.0.0"
    entry.write_text(json.dumps(doc))
    eng = _engine(tagger, cache_dir=tmp_path)
    with pytest.warns(RuntimeWarning, match="unusable"):
        _serve_once(eng, x)
    assert eng.trace_count(schedule_key(SCHED)) == 1


@pytest.mark.parametrize("axis", ("torch", "toolkit", "device_kind",
                                  "kernels"))
def test_env_fingerprint_change_invalidates(tagger, x, tmp_path,
                                            monkeypatch, axis):
    """Another torch, toolkit, card or kernel source is another entry: a
    plain miss (cold, no warning), never a stale hit."""
    _serve_once(_engine(tagger, cache_dir=tmp_path), x)
    real = cc._env_meta
    monkeypatch.setattr(cc, "_env_meta",
                        lambda device=None: {**real(device), axis: "other"})
    eng = _engine(tagger, cache_dir=tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _serve_once(eng, x)
    assert eng.trace_count(schedule_key(SCHED)) == 1
    assert eng.compile_cache.warm_hits == 0
    assert len(list(tmp_path.glob(GLOB))) == 2


def test_distinct_schedule_fp_shape_get_distinct_entries(tagger, x,
                                                         tmp_path):
    eng = _engine(tagger, cache_dir=tmp_path)
    _serve_once(eng, x)
    _serve_once(eng, x, fp=FixedPointConfig(16, 6))
    assert len(list(tmp_path.glob(GLOB))) == 2
    other = _engine(tagger, cache_dir=tmp_path, max_batch=2)
    _serve_once(other, x[:2])
    assert len(list(tmp_path.glob(GLOB))) == 3
    assert other.trace_count(schedule_key(SCHED)) == 1


def test_concurrent_stores_leave_one_complete_entry(tmp_path):
    """N replicas storing the same entry at once: every store succeeds, one
    complete file remains, no temp litter, and it loads."""
    meta = {"kind": "unit"}
    caches = [CompileCache(tmp_path, device="cpu") for _ in range(8)]
    rec = cuda.Recording(dry=False)
    ok = []
    threads = [threading.Thread(target=lambda c=c: ok.append(
        c.store("e", meta, rec, "k"))) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ok == [True] * 8
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == CACHE_SUFFIX
    assert caches[0].load("e", meta, "k") is not None


def test_disabled_cache_counts_cold_builds():
    cache = CompileCache(None, device="cpu")
    assert not cache.enabled
    assert cache.load("x", {"k": 1}, "key") is None
    assert cache.store("x", {"k": 1}, cuda.Recording(False), "key") is False
    cache.record_cold("key", 0.5)
    cache.record_warm("key")
    row = cache.report_row("key")
    assert (row["cold"], row["warm"], row["hit_rate"]) == (1, 1, 0.5)
    assert row["first_compile_s"] == 0.5


def test_cached_executor_warm_runs_nothing(tmp_path):
    """``warm`` readies a signature without a request: a cold one runs the
    executor once on zeros inside a dry recording, a warm one not at all;
    a later call of the signature is counted as neither."""
    calls = []

    def fn(x, lengths=None):
        calls.append(cuda._RECORDINGS[-1].dry if cuda._RECORDINGS else None)
        return x.sum()

    builds = []
    ex = CachedExecutor(fn, CompileCache(tmp_path, device="cpu"), "k",
                        {"kind": "unit"}, on_build=lambda: builds.append(1))
    spec = ArgSpec((2, 3), "float32")
    assert ex.warm(spec, None)["status"] == "cold" and calls == [True]
    assert ex.warm(spec, None)["status"] == "hot" and len(calls) == 1
    assert ex(np.ones((2, 3), np.float32), None) == 6 and calls[-1] is None
    ex2 = CachedExecutor(fn, CompileCache(tmp_path, device="cpu"), "k",
                         {"kind": "unit"}, on_build=lambda: builds.append(2))
    assert ex2.warm(spec, None)["status"] == "warm" and len(calls) == 2
    assert builds == [1]


def test_prewarm_targets_then_fresh_engine_serves_warm(tagger, x, tmp_path):
    targets = [DesignTarget(max_dsp=600), DesignTarget(objective="latency")]
    eng = _engine(tagger, cache_dir=tmp_path)
    report = eng.prewarm(targets=targets)
    assert report and all(r["status"] == "cold" for r in report.values())
    assert all(eng.trace_count(k) == 1 for k in report)
    fresh = _engine(tagger, cache_dir=tmp_path)
    report2 = fresh.prewarm(targets=targets)
    assert [r["status"] for r in report2.values()] == ["warm"] * len(report)
    assert fresh.compile_cache.cold_compiles == 0
    pt = fresh.schedule_for_target(targets[0])
    reqs = [fresh.submit(x[i], target=targets[0]) for i in range(3)]
    fresh.flush(force=True)
    assert fresh.trace_count(pt.key) == 0
    want = _engine(tagger).predict(x[:3], schedule=pt.schedule, fp=pt.fp)
    np.testing.assert_array_equal(_bits(np.stack([r.result for r in reqs])),
                                  _bits(want))


def test_auto_schedule_warms_selected_point(tagger, tmp_path):
    spec = SpaceSpec(backends=("pallas_interpret",), block_batches=(4,))
    eng = _engine(tagger, cache_dir=tmp_path)
    pt = eng.auto_schedule(DesignTarget(max_dsp=600), spec=spec)
    assert eng.compile_cache.stats(pt.key).cold == 1
    fresh = _engine(tagger, cache_dir=tmp_path)
    fresh.auto_schedule(DesignTarget(max_dsp=600), spec=spec)
    assert fresh.compile_cache.cold_compiles == 0
    assert fresh.trace_count(pt.key) == 0


def test_exploration_prewarm_hook(tagger, tmp_path):
    spec = SpaceSpec(backends=("xla",), block_batches=(4,))
    ex = explore(tagger[2], DesignTarget(objective="latency"), spec)
    report = ex.prewarm(_engine(tagger, cache_dir=tmp_path), k=2)
    assert len(report) == min(2, len(ex.feasible))
    assert all(r["status"] == "cold" for r in report.values())
    fresh = _engine(tagger, cache_dir=tmp_path)
    assert all(r["status"] == "warm"
               for r in ex.prewarm(fresh, k=2).values())


def test_warmup_without_cache_dir_builds_once(tagger, x):
    eng = _engine(tagger)
    key = schedule_key(SCHED)
    assert eng.warmup(schedule=SCHED)[key]["status"] == "cold"
    assert eng.trace_count(key) == 1
    _serve_once(eng, x)
    assert eng.trace_count(key) == 1


def test_lm_engine_cold_then_warm_decode(tmp_path):
    import dataclasses

    from repro.testing import tiny_config

    from repro_torch.config import PORT_ONLY_FIELDS, ModelConfig
    from repro_torch.models.decode import lm_params_from_jax
    from repro_torch.serving import LMServingEngine

    jcfg = tiny_config(jget_config("stablelm-3b"))
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)
                          if f.name != "rnn"
                          and f.name not in PORT_ONLY_FIELDS})
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = lm_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    sched = KernelSchedule(reuse_factor=2, mode="static")
    key = schedule_key(sched)

    def engine(cache_dir=None):
        return LMServingEngine(tcfg, tparams, max_batch=2, max_seq=32,
                               device="cpu", cache_dir=cache_dir)

    cold = engine(tmp_path)
    assert cold.prewarm(schedules=[sched])[key]["status"] == "cold"
    a = cold.add_request([3, 4, 5], max_new=2)
    b = cold.add_request([5, 7], max_new=2, schedule=sched)
    done = cold.run_to_completion()
    assert cold.trace_count("default") == cold.trace_count(key) == 1
    warm = engine(tmp_path)
    assert warm.prewarm(schedules=[sched])[key]["status"] == "warm"
    c = warm.add_request([3, 4, 5], max_new=2)
    d = warm.add_request([5, 7], max_new=2, schedule=sched)
    done2 = warm.run_to_completion()
    assert warm.trace_count("default") == warm.trace_count(key) == 0
    assert (done2[c], done2[d]) == (done[a], done[b])
    rows = warm.serve_report()
    assert rows["default"]["compile"]["warm"] == 1
    assert rows[key]["compile"]["cold"] == 0
    ref = engine()
    e = ref.add_request([3, 4, 5], max_new=2)
    assert ref.run_to_completion()[e] == done[a]
