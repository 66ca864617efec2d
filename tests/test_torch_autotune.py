"""The port's auto-scheduler (``repro_torch.autotune``) and the engines'
target-driven half against the JAX package's, on the CPU.

Spaces, frontiers, selections, errors, ladders and the engines'
``analytical`` columns are compared for equality (pure Python on the same
numbers, keys byte-identical).  The one deliberate difference is the
pruning rule: the port prunes a kernel-backend point by the card's launch
layouts (``space._card_legal``), where the JAX package prunes
``backend="pallas_tpu"`` by the TPU's lane alignment; on the six taggers
the card prunes nothing.

On the CPU, ``measure_points`` times the kernels' plain versions (its
ranking means nothing there) and the engines run them too; served
probabilities are held to the JAX engine at ``CONFORMANCE_TOL["float32"]``
x max(1, |want|), as in ``tests/test_torch_serving.py``, and to the port's
own ``predict`` bit for bit.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import autotune as jat  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import LMServingEngine as JLMEngine  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402

from repro_torch import autotune as at  # noqa: E402
from repro_torch.autotune import space  # noqa: E402
from repro_torch.config import (PORT_ONLY_FIELDS,  # noqa: E402
                                FixedPointConfig, ModelConfig, RNNConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import scan_layout  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models.decode import lm_params_from_jax  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.serving import (LMServingEngine, RNNServingEngine,  # noqa: E402,E501
                                 format_serve_report)

TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
SMALL = dict(reuse_factors=(1, 2, 4), iis=(0, 1))
SMALL_SPEC = at.SpaceSpec(**SMALL)
JSMALL_SPEC = jat.SpaceSpec(**SMALL)
#: the targets of tests/test_autotune.py: static R = 1, static with R up,
#: pipeline / non-static
TARGETS = (dict(objective="latency"), dict(max_dsp=600),
           dict(min_throughput_eps=1e7, objective="throughput"))
TARGET_IDS = ("latency", "dsp600", "throughput")
FPS = (None, FixedPointConfig(16, 6), FixedPointConfig(8, 3))
FP_IDS = ("float", "ap16_6", "ap8_3_native")
TOL = CONFORMANCE_TOL["float32"]


def jfp(fp):
    return None if fp is None else jconfig.FixedPointConfig(
        **dataclasses.asdict(fp))


def targets(kw, fp=None):
    """The port's and the JAX package's DesignTarget of one budget."""
    return at.DesignTarget(fp=fp, **kw), jat.DesignTarget(fp=jfp(fp), **kw)


def keys(points):
    return [p.key for p in points]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err


@pytest.fixture(scope="module")
def tagger_params():
    """name -> (JAX params as numpy, the port's params on the CPU)."""
    out = {}
    for name in TAGGERS:
        jp = build_model(jget_config(name)).init(jax.random.PRNGKey(0))
        jp = {k: np.asarray(v) for k, v in jp.items()}
        out[name] = (jp, params_from_jax(jp, "cpu"))
    return out


# ---------------------------------------------------------------------------
# Space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ("xla", "pallas_interpret"))
@pytest.mark.parametrize("name", TAGGERS)
def test_space_keys_match_repro(name, backend):
    cfg, jcfg = get_config(name), jget_config(name)
    for kw in ({}, SMALL, dict(hoist_reuses=(1, 2), block_batches=(8, 128))):
        spec = at.SpaceSpec(backends=(backend,), **kw)
        jspec = jat.SpaceSpec(backends=(backend,), **kw)
        got = at.enumerate_space(cfg, spec)
        assert [s.key() for s in got] == \
            [s.key() for s in jat.enumerate_space(jcfg, jspec)]
        assert [s.key() for s in at.enumerate_decode_space(cfg, spec)] == \
            [s.key() for s in jat.enumerate_decode_space(jcfg, jspec)]
        # the card prunes nothing of a tagger's space
        assert all(space._card_legal(s, cfg) for s in got)


def test_card_legal_prunes_what_the_layout_refuses():
    """An input width that leaves the cluster kernel no layout
    (``scan_layout``: every candidate loads more x a step than its threads
    hold) prunes exactly the static in-loop points of the kernel backend;
    hoisted, pipeline and non-static points, and the reference, stay."""
    rnn = RNNConfig(cell="lstm", hidden=16, input_size=1024)
    cfg = ModelConfig(name="wide-input", rnn=rnn)
    jcfg = jconfig.ModelConfig(name="wide-input", rnn=jconfig.RNNConfig(
        cell="lstm", hidden=16, input_size=1024))
    assert scan_layout.scan_route(16) == "cluster"
    with pytest.raises(ValueError, match="no cluster layout fits"):
        scan_layout.scan_layout(8, 16, 1024, "lstm",
                                resident=scan_layout.model_resident)
    scan_layout.scan_layout(8, 16, 1024, "lstm", hoisted=True,
                            resident=scan_layout.model_resident)
    want = [s.key() for s in jat.enumerate_space(jcfg, JSMALL_SPEC)]
    got = [s.key() for s in at.enumerate_space(cfg, SMALL_SPEC)]
    pruned = [k for k in want if k.startswith("static") and "hoist" not in k]
    assert pruned and got == [k for k in want if k not in pruned]
    xla = dict(SMALL, backends=("xla",))
    assert [s.key() for s in at.enumerate_space(cfg, at.SpaceSpec(**xla))] \
        == [s.key() for s in jat.enumerate_space(jcfg, jat.SpaceSpec(**xla))]
    # the decode space asks decode_layout, which lays these products out
    assert [s.key() for s in at.enumerate_decode_space(cfg, SMALL_SPEC)] == \
        [s.key() for s in jat.enumerate_decode_space(jcfg, JSMALL_SPEC)]
    # a spec of only refused points leaves nothing to select from
    static = at.SpaceSpec(modes=("static",), hoist=(False,))
    assert at.enumerate_space(cfg, static) == ()
    with pytest.raises(ValueError, match="space is empty.*scan_layout"):
        at.select(cfg, at.DesignTarget(), static)


def test_lm_decode_schedules_match_repro():
    cfg, jcfg = lm_configs()
    for kw in ({}, dict(reuse_factors=(1, 2, 3, 4, 64))):
        assert [s.key() for s in at.lm_decode_schedules(
            cfg, at.SpaceSpec(**kw))] == [s.key() for s in
                                          jat.lm_decode_schedules(
                                              jcfg, jat.SpaceSpec(**kw))]


# ---------------------------------------------------------------------------
# Explorer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TAGGERS)
def test_explore_frontier_matches_repro(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for i, fp in enumerate(FPS):
        t, jt = targets({}, fp)
        for spec, jspec in ((SMALL_SPEC, JSMALL_SPEC),
                            (at.SpaceSpec(), jat.SpaceSpec())):
            for a, b in ((at.explore(cfg, None, spec),
                          jat.explore(jcfg, None, jspec)),
                         (at.explore(cfg, t, spec),
                          jat.explore(jcfg, jt, jspec))):
                assert keys(a.points) == keys(b.points)
                assert keys(a.frontier) == keys(b.frontier)
                assert keys(a.feasible) == keys(b.feasible)
                assert a.frontier_table() == b.frontier_table()
                assert at.pareto(a.frontier) == a.frontier


@pytest.mark.parametrize("ti", range(len(TARGETS)), ids=TARGET_IDS)
@pytest.mark.parametrize("name", TAGGERS)
def test_select_matches_repro(name, ti):
    cfg, jcfg = get_config(name), jget_config(name)
    for fp in FPS:
        t, jt = targets(TARGETS[ti], fp)
        for spec, jspec in ((SMALL_SPEC, JSMALL_SPEC),
                            (at.SpaceSpec(), jat.SpaceSpec())):
            for sel, jsel in ((at.select, jat.select),
                              (at.select_decode, jat.select_decode)):
                pt, jpt = same_outcome(lambda: sel(cfg, t, spec),
                                       lambda: jsel(jcfg, jt, jspec))
                if pt is None:
                    continue
                assert pt.key == jpt.key
                assert pt.report_row() == jpt.report_row()
                assert at.is_feasible(pt, t) and at.violation(pt, t) == 0.0


def same_outcome(call, jcall):
    """Both packages' results, or (None, None) where both raise
    InfeasibleTargetError with the same message."""
    try:
        got = call()
    except at.InfeasibleTargetError as err:
        with pytest.raises(jat.InfeasibleTargetError) as jerr:
            jcall()
        assert str(err) == str(jerr.value)
        return None, None
    return got, jcall()


@pytest.mark.parametrize("name", TAGGERS)
def test_infeasible_target_matches_repro(name):
    """The nearest point, the replica hint and the message itself."""
    cfg, jcfg = get_config(name), jget_config(name)
    best = max(p.throughput_eps(200.0)
               for p in at.explore(cfg, at.DesignTarget(), SMALL_SPEC).points)
    for kw in (dict(max_latency_us=1e-4),
               dict(min_throughput_eps=best * 2.5, objective="throughput"),
               dict(max_latency_us=1e-4, min_throughput_eps=1e12),
               dict(max_dsp=1, part="vu9p_slr")):
        t, jt = targets(kw)
        with pytest.raises(at.InfeasibleTargetError) as ei:
            at.select(cfg, t, SMALL_SPEC)
        with pytest.raises(jat.InfeasibleTargetError) as jei:
            jat.select(jcfg, jt, JSMALL_SPEC)
        err, jerr = ei.value, jei.value
        assert str(err) == str(jerr)
        assert err.nearest.key == jerr.nearest.key
        assert err.suggested_replicas == jerr.suggested_replicas
        assert (None if err.suggested_point is None
                else err.suggested_point.key) == \
            (None if jerr.suggested_point is None
             else jerr.suggested_point.key)
        hint = at.suggest_replicas(at.explore(cfg, t, SMALL_SPEC).points, t)
        assert (hint is None) == (err.suggested_replicas is None)
    assert ei.value.suggested_replicas is None
    fixed = dataclasses.replace(targets(dict(min_throughput_eps=best * 2.5,
                                             objective="throughput"))[0],
                                replicas=3)
    assert at.select(cfg, fixed, SMALL_SPEC).throughput_eps() * 3 >= best * 2.5


@pytest.mark.parametrize("name", TAGGERS)
def test_degradation_ladder_matches_repro(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for fp in (None, FixedPointConfig(8, 3)):
        t, jt = targets(dict(objective="latency"), fp)
        base, jbase = (at.select(cfg, t, SMALL_SPEC),
                       jat.select(jcfg, jt, JSMALL_SPEC))
        for kw in ({}, dict(max_rungs=8, min_gain=2.0)):
            got = at.degradation_ladder(cfg, base, spec=SMALL_SPEC, fp=fp,
                                        **kw)
            want = jat.degradation_ladder(jcfg, jbase, spec=JSMALL_SPEC,
                                          fp=jfp(fp), **kw)
            assert keys(got) == keys(want) and got[0] is base
    with pytest.raises(ValueError, match="min_gain"):
        at.degradation_ladder(cfg, base, min_gain=1.0)


def lm_configs():
    jcfg = tiny_config(jget_config("gemma-2b"))
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)
                         if f.name != "rnn"
                         and f.name not in PORT_ONLY_FIELDS})
    return cfg, jcfg


@pytest.mark.parametrize("name", ("gemma-2b", "top-tagging-gru"))
def test_select_speculative_matches_repro(name):
    if name in TAGGERS:
        cfg, jcfg = get_config(name), jget_config(name)
    else:
        cfg, jcfg = lm_configs()
    for kw in ({}, dict(max_dsp=10 ** 6), dict(max_latency_us=0.5)):
        t, jt = targets(kw) if kw else (None, None)
        for extra in ({}, dict(ks=(1, 3), accept_rate=0.5,
                               include_ngram=False)):
            got = at.explore_speculative(cfg, t, SMALL_SPEC, **extra)
            want = jat.explore_speculative(jcfg, jt, JSMALL_SPEC, **extra)
            assert keys(got) == keys(want)
            assert [p.report_row() for p in got] == \
                [p.report_row() for p in want]
            if got:
                assert at.select_speculative(cfg, t, SMALL_SPEC,
                                             **extra).key == \
                    jat.select_speculative(jcfg, jt, JSMALL_SPEC,
                                           **extra).key


# ---------------------------------------------------------------------------
# Measured selection (on the CPU: the plain versions, ranking meaningless)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("top-tagging-lstm", "top-tagging-gru"))
def test_measure_points_on_cpu(name):
    cfg = get_config(name)
    target = at.DesignTarget(objective="latency")
    top = at.explore(cfg, target, SMALL_SPEC).feasible[:3]
    walls = at.measure_points(cfg, top, batch=4, iters=2, device="cpu")
    assert sorted(walls) == sorted(keys(top))
    assert all(np.isfinite(w) and w > 0 for w in walls.values())
    pt = at.select(cfg, target, SMALL_SPEC, measure_top_k=2,
                   measure_batch=4, device="cpu")
    assert pt.key in keys(top[:2])
    # measurement carries no resource information: the analytic pick stands
    res = at.DesignTarget(objective="resources")
    assert at.select(cfg, res, SMALL_SPEC, measure_top_k=3,
                     device="cpu").key == at.select(cfg, res,
                                                    SMALL_SPEC).key


# ---------------------------------------------------------------------------
# The engines, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fi", range(2), ids=FP_IDS[:2])
@pytest.mark.parametrize("ti", range(len(TARGETS)), ids=TARGET_IDS)
@pytest.mark.parametrize("name", ("top-tagging-lstm", "top-tagging-gru"))
def test_auto_schedule_serves_like_predict_and_repro(name, ti, fi,
                                                     tagger_params, rng):
    """auto_schedule(target) serves bit-identically to predict under the
    selected schedule, and within tolerance of the JAX engine (its Pallas
    kernels in interpret mode) auto-scheduled to the same key."""
    jparams, tparams = tagger_params[name]
    cfg, jcfg = get_config(name), jget_config(name)
    t, jt = targets(TARGETS[ti], FPS[fi])
    eng = RNNServingEngine(cfg, tparams, device="cpu", max_batch=8)
    jeng = JEngine(jcfg, jparams, impl="pallas", max_batch=8)
    pt = eng.auto_schedule(t, spec=SMALL_SPEC)
    jpt = jeng.auto_schedule(jt, spec=JSMALL_SPEC, warmup=False)
    assert pt.key == jpt.key and at.is_feasible(pt, t)
    assert eng.schedule == pt.schedule and eng.fp == pt.fp
    x = rng.randn(5, cfg.rnn.seq_len, cfg.rnn.input_size).astype(np.float32)
    auto = eng.predict(x)
    # the warm-up built the selected key's executor: serving builds nothing
    assert list(eng._infer_cache) == [pt.key] and eng.trace_count(pt.key) == 1
    np.testing.assert_array_equal(
        auto, eng.predict(x, schedule=pt.schedule, fp=pt.fp))
    assert_close(auto, jeng.predict(x))
    # a request's target resolves over the engine's own spec, and one
    # event's answer has the same bits in every batch shape: predict_one,
    # predict of one row, of the whole batch, and a padded flush
    sp = eng.schedule_for_target(t)
    full = eng.predict(x, schedule=sp.schedule, fp=sp.fp)
    reqs = [eng.submit(x[i], target=t) for i in range(len(x))]
    eng.flush(force=True)
    for i in range(len(x)):
        for got in (eng.predict_one(x[i], target=t),
                    eng.predict(x[i:i + 1], schedule=sp.schedule,
                                fp=sp.fp)[0],
                    reqs[i].result):
            np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                          full[i].view(np.int32))


@pytest.mark.parametrize("name", TAGGERS)
def test_auto_schedule_every_tagger(name, tagger_params, rng):
    """Every tagger at a resource budget, and its row of serve_report, as
    the JAX engine gives them (reference path: the same numbers)."""
    jparams, tparams = tagger_params[name]
    cfg, jcfg = get_config(name), jget_config(name)
    t, jt = targets(dict(max_dsp=600))
    eng = RNNServingEngine(cfg, tparams, device="cpu", max_batch=4)
    jeng = JEngine(jcfg, jparams, impl="xla", max_batch=4)
    pt = eng.auto_schedule(t, warmup=False)
    jpt = jat.select(jcfg, jt, jat.SpaceSpec(backends=("pallas_interpret",),
                                             block_batches=(4,)))
    assert pt.key == jpt.key
    x = rng.randn(4, cfg.rnn.seq_len, cfg.rnn.input_size).astype(np.float32)
    reqs = [eng.submit(x[i], target=t) for i in range(4)]
    eng.flush(force=True)
    want = eng.predict(x, schedule=pt.schedule)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(r.result), want[i])
    assert_close(want, jeng.predict(x))
    rep = eng.serve_report()[pt.key]
    assert rep["measured"]["served"] == 4
    assert rep["analytical"] == jpt.estimate.report_row(200.0)


def test_target_carrying_stream_cobatches_on_one_key(tagger_params, rng):
    """submit(target=...) resolves the explorer once: every request lands
    on the selected key, one executor, bit for bit equal to predict."""
    name = "top-tagging-gru"
    cfg = get_config(name)
    eng = RNNServingEngine(cfg, tagger_params[name][1], device="cpu",
                           max_batch=8)
    target = at.DesignTarget(max_dsp=600)
    x = rng.randn(8, 20, 6).astype(np.float32)
    reqs = [eng.submit(x[i], target=target) for i in range(8)]
    eng.flush(force=True)
    pt = eng.schedule_for_target(target)
    assert {r.key for r in reqs} == {pt.key}
    assert eng.trace_count(pt.key) == 1 and list(eng._infer_cache) == [pt.key]
    direct = eng.predict(x, schedule=pt.schedule, fp=pt.fp)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(r.result), direct[i])
    np.testing.assert_array_equal(eng.predict(x, target=target), direct)


def test_schedule_for_target_memoizes_per_spec(tagger_params):
    eng = RNNServingEngine(get_config("top-tagging-gru"),
                           tagger_params["top-tagging-gru"][1], device="cpu",
                           impl="xla", max_batch=4)
    target = at.DesignTarget(objective="latency")
    default_pt = eng.schedule_for_target(target)
    assert default_pt.schedule.backend == "xla"
    small_pt = eng.schedule_for_target(target, spec=SMALL_SPEC)
    assert small_pt.schedule.backend == "pallas_interpret"
    assert eng.schedule_for_target(target) is default_pt
    assert eng.schedule_for_target(target, spec=SMALL_SPEC) is small_pt
    measured = eng.schedule_for_target(target, measure_top_k=2)
    assert eng.schedule_for_target(target, measure_top_k=2) is measured
    assert measured is not default_pt
    with pytest.raises(at.InfeasibleTargetError, match="nearest-to-feasible"):
        eng.auto_schedule(at.DesignTarget(max_latency_us=1e-4))


@pytest.mark.parametrize("impl", ("xla", "pallas"))
def test_serve_report_analytical_matches_repro(impl, tagger_params, rng):
    """The analytical column equals the JAX engine's for every key, the
    default queue's row (served under the resolved schedule) included;
    format_serve_report renders one row per key."""
    name = "flavor-tagging-lstm"
    jparams, tparams = tagger_params[name]
    cfg, jcfg = get_config(name), jget_config(name)
    fp = FixedPointConfig(16, 6)
    eng = RNNServingEngine(cfg, tparams, device="cpu", impl=impl, fp=fp,
                           max_batch=4)
    jeng = JEngine(jcfg, jparams, impl="xla", fp=jfp(fp), max_batch=4)
    scheds = (KernelSchedule(reuse_factor=4, block_batch=8),
              KernelSchedule(mode="pipeline", block_batch=8, ii=1))
    x = rng.randn(3, 15, 6).astype(np.float32)
    for e, mk in ((eng, lambda s: s),
                  (jeng, lambda s: JSchedule(**dataclasses.asdict(s)))):
        for s in scheds:
            e.submit(x[0], schedule=mk(s))
        for i in range(2):
            e.batcher.submit(x[i])             # the bare default queue
        e.flush(force=True)
    rep, jrep = eng.serve_report(150.0), jeng.serve_report(150.0)
    if impl == "xla":
        assert sorted(rep) == sorted(jrep)
    for key, row in rep.items():
        jkey = key if key in jrep else key.replace("-auto", "-xla")
        if key == "default":
            assert row["resolved_key"].replace("-auto", "-xla") == \
                jrep["default"]["resolved_key"]
            assert row["schedule"] == eng.resolved_schedule
        jrow = jrep[jkey]["analytical"]
        assert row["analytical"] == {**jrow, "schedule_key":
                                     row["schedule"].key()}
        assert row["analytical"]["schedule_key"] == row["schedule"].key()
    assert rep["default"]["measured"]["served"] == 2
    table = format_serve_report(rep, 150.0).splitlines()
    assert len(table) == 1 + len(rep)
    for key, line in zip(rep, table[1:]):
        assert line.startswith(key)
    assert eng.fpga_design().as_dict() == jeng.fpga_design().as_dict()
    assert eng.fpga_design(6, 5, "resource", "u250").as_dict() == \
        jeng.fpga_design(6, 5, "resource", "u250").as_dict()


def test_lm_engine_analytical_matches_repro():
    """Scheduled keys carry estimate_lm_decode of their schedule, as the
    JAX engine's do; the einsum key has none."""
    cfg, jcfg = lm_configs()
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = lm_params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, "cpu")
    sched = KernelSchedule(reuse_factor=2, block_batch=8)
    eng = LMServingEngine(cfg, tparams, max_batch=2, max_seq=16,
                          device="cpu")
    jeng = JLMEngine(jcfg, jparams, max_batch=2, max_seq=16)
    for e, s in ((eng, sched), (jeng, JSchedule(**dataclasses.asdict(sched)))):
        e.add_request([3, 4], max_new=2, now=0.0)
        e.add_request([5], max_new=2, now=0.0, schedule=s)
        e.run_to_completion()
    rep, jrep = eng.serve_report(100.0), jeng.serve_report(100.0)
    assert sorted(rep) == sorted(jrep) == ["default", sched.key()]
    assert rep["default"]["analytical"] is None
    assert jrep["default"]["analytical"] is None
    assert rep[sched.key()]["analytical"] == jrep[sched.key()]["analytical"]
    assert rep[sched.key()]["analytical"]["scheduled_kernels"] is True
