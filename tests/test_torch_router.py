"""The port's replica pool and router (``repro_torch.serving.{replica,
router,faults}``) against ``repro``'s, on the CPU.

Each chaos scenario of ``tests/test_router.py`` (crash failover, a
straggler past its timeout, a hedge that beats a slow primary, a flapping
replica, every replica down, probe re-admission) is replayed with the same
seeded payloads and the same explicit ``now`` stamps through both
packages, each over its own engines (``impl="pallas"``: ``repro`` in
interpret mode, the port on its kernels' plain versions) for
``top-tagging-gru``.  Service times are analytic, so both replays must
agree exactly on every terminal state, attempt, counter, event and report
key, and on the hash ring's placements; the outputs agree within
``CONFORMANCE_TOL``, and the port's are bit for bit its own single
engine's ``predict_one``.  The property test holds the port's
exactly-one-terminal-state law over random fault plans
(``deadline=None``: the first example builds the engines' executors).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.serving as jserving  # noqa: E402
import repro.serving.faults as jfaults  # noqa: E402
import repro.serving.router as jrouter  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import CONFORMANCE_TOL  # noqa: E402

import repro_torch.serving as tserving  # noqa: E402
import repro_torch.serving.faults as tfaults  # noqa: E402
import repro_torch.serving.router as trouter  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402

TAG = "top-tagging-gru"
N_ENGINES = 4
TERMINAL = ("answered", "failed", "shed")


def _pkg(serving, faults, router):
    return SimpleNamespace(
        ReplicaPool=serving.ReplicaPool, EngineReplica=serving.EngineReplica,
        Router=serving.Router, RouterPolicy=serving.RouterPolicy,
        HashRing=router.HashRing, format_router_report=(
            serving.format_router_report),
        crash=faults.crash_replica, slow=faults.slow_replica,
        flap=faults.flapping)


@pytest.fixture(scope="module")
def harness():
    jcfg = jget_config(TAG)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(0)).items()}
    tcfg, tparams = get_config(TAG), params_from_jax(jparams, "cpu")
    r = jcfg.rnn
    xs = np.random.RandomState(0).randn(
        16, r.seq_len, r.input_size).astype(np.float32)
    sides = {
        "repro": (_pkg(jserving, jfaults, jrouter),
                  [jserving.RNNServingEngine(jcfg, jparams, impl="pallas")
                   for _ in range(N_ENGINES)]),
        "port": (_pkg(tserving, tfaults, trouter),
                 [tserving.RNNServingEngine(tcfg, tparams, device="cpu")
                  for _ in range(N_ENGINES)]),
    }
    oracle = tserving.RNNServingEngine(tcfg, tparams, device="cpu")
    return sides, xs, oracle


def _router(pkg, engines, n, **policy):
    pool = pkg.ReplicaPool([pkg.EngineReplica(f"r{i}", engines[i])
                            for i in range(n)])
    return pool, pkg.Router(pool, policy=pkg.RouterPolicy(**policy))


# each scenario: (pkg, engines, xs) -> (router, requests)


def crash_failover(pkg, engines, xs):
    pool, router = _router(pkg, engines, 3, consecutive_failures=2)
    first = router.submit(xs[0], now=0.0)
    pkg.crash(pool.get(first.winner))
    return router, [first] + [router.submit(x, now=0.01 + i * 1e-4)
                              for i, x in enumerate(xs[:10])]


def straggler_timeout(pkg, engines, xs):
    pool, router = _router(pkg, engines, 3, timeout_s=0.01)
    first = router.submit(xs[0], now=0.0)
    pkg.slow(pool.get(first.winner), 0.05, times=1)
    return router, [first, router.submit(xs[1], now=1e-3),
                    router.submit(xs[2], now=2e-3)]


def hedge_wins(pkg, engines, xs):
    pool, router = _router(pkg, engines, 3, timeout_s=0.1,
                           hedge_after_s=1e-3)
    first = router.submit(xs[0], now=0.0)
    pkg.slow(pool.get(first.winner), 5e-3)
    return router, [first] + [router.submit(x, now=1e-2 + i * 1e-3)
                              for i, x in enumerate(xs[1:4])]


def flapping_replica(pkg, engines, xs):
    pool, router = _router(pkg, engines, 3, consecutive_failures=2,
                           probe_interval_s=1e9)
    first = router.submit(xs[0], now=0.0)
    pkg.flap(pool.get(first.winner), period=2)
    return router, [first] + [router.submit(x, now=1e-3 + i * 1e-4)
                              for i, x in enumerate(xs)]


def all_down(pkg, engines, xs):
    pool, router = _router(pkg, engines, 2, consecutive_failures=1,
                           max_retries=1, probe_interval_s=1e9)
    for rep in pool:
        pkg.crash(rep)
    return router, [router.submit(xs[0], now=0.0),
                    router.submit(xs[1], now=1e-3)]


def probe_readmit(pkg, engines, xs):
    pool, router = _router(pkg, engines, 3, consecutive_failures=1,
                           probe_successes=2)
    first = router.submit(xs[0], now=0.0)
    dead = pool.get(first.winner)
    pkg.crash(dead, times=3)
    reqs = [first, router.submit(xs[1], now=1e-3)]
    router.probe(now=0.1)
    dead.faults.clear()
    router.probe(now=0.2)
    router.probe(now=0.3)
    reqs.append(router.submit(xs[2], now=0.4))
    deferred = [router.submit(x, now=0.5 + i * 1e-4, defer=True)
                for i, x in enumerate(xs[3:8])]
    router.flush(now=1.0)
    return router, reqs + deferred


SCENARIOS = (crash_failover, straggler_timeout, hedge_wins,
             flapping_replica, all_down, probe_readmit)


def _trace(router, reqs):
    """Everything two replays must agree on exactly (results aside)."""
    return {
        "requests": [(r.status, r.winner, r.hedged, r.shed_reason,
                      type(r.error).__name__ if r.error else None,
                      [(a.kind, a.replica_id, a.outcome) for a in r.attempts])
                     for r in reqs],
        "counts": {k: dataclasses.asdict(c)
                   for k, c in router.counts.items()},
        "events": list(router.events),
        "accounting": router.verify_router_accounting(),
        "healthy": router.healthy_count(),
    }


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_chaos_replay_matches_repro(harness, scenario):
    sides, xs, oracle = harness
    runs = {name: scenario(pkg, engines, xs)
            for name, (pkg, engines) in sides.items()}
    (jr, jreqs), (tr, treqs) = runs["repro"], runs["port"]
    assert _trace(tr, treqs) == _trace(jr, jreqs)
    jrep, trep = jr.router_report(), tr.router_report()
    assert _keys(trep) == _keys(jrep)
    assert trep["pool"] == jrep["pool"]
    for rid, row in trep["replicas"].items():
        want = jrep["replicas"][rid]
        assert {k: v for k, v in row.items() if k != "engine_served"} \
            == {k: v for k, v in want.items() if k != "engine_served"}
    assert set(sides["port"][0].format_router_report(tr).split()) \
        == set(sides["repro"][0].format_router_report(jr).split())
    tol = CONFORMANCE_TOL["float32"]
    for j, t in zip(jreqs, treqs):
        if t.status != "answered":
            assert t.result is None and j.result is None
            continue
        want = np.asarray(j.result)
        assert float(np.abs(t.result - want).max()) \
            <= tol * max(1.0, float(np.abs(want).max()))
        # bit for bit the port's single-engine predict_one of the payload
        np.testing.assert_array_equal(
            np.asarray(t.result).view(np.int32),
            oracle.predict_one(t.payload).view(np.int32))


@pytest.mark.parametrize("vnodes", (1, 16, 64))
@pytest.mark.parametrize("n", (1, 3, 5))
def test_hash_ring_places_as_repro(vnodes, n):
    ids = [f"r{i}" for i in range(n)]
    keys = ["static-R1-bb128-auto", "pipeline-R4-bb8-pallas_interpret-hoist",
            "static-R2-bb8-xla-ap16_6_rnd_sat"] + [f"k{i}" for i in range(40)]
    jring, tring = jrouter.HashRing(ids, vnodes), trouter.HashRing(ids,
                                                                  vnodes)
    for key in keys:
        assert tring.ordered(key) == jring.ordered(key)


def test_policy_and_fault_validation_match_repro(harness):
    sides, _, _ = harness
    for bad in (dict(timeout_s=0.0), dict(max_retries=-1), dict(jitter=1.0),
                dict(consecutive_failures=0), dict(probe_successes=0),
                dict(max_error_rate=0.0)):
        with pytest.raises(ValueError):
            trouter.RouterPolicy(**bad)
    eng = sides["port"][1][0]
    with pytest.raises(TypeError, match="ReplicaFaultSet"):
        tfaults.crash_replica(eng)
    rep = tserving.EngineReplica("rX", eng)
    arm = tfaults.crash_replica(rep, after=1, times=1)
    assert rep.heartbeat() == 0.0
    with pytest.raises(tfaults.ReplicaCrashed):
        rep.heartbeat()
    assert rep.heartbeat() == 0.0 and not arm.live
    assert rep.faults.fired == ["crash:rX"]


def test_router_close_is_terminal_and_idempotent(harness):
    _, xs, _ = harness
    cfg = get_config(TAG)
    params = dict(harness[2].params)
    pool = tserving.ReplicaPool.build(cfg, params, 2, device="cpu")
    router = tserving.Router(pool)
    router.submit(xs[0], now=0.0, defer=True)
    done = router.close(now=1.0)
    assert len(done) == 1 and done[0].status == "answered"
    assert router.closed and all(rep.closed for rep in pool)
    assert router.close() == []
    with pytest.raises(tserving.EngineClosedError, match="closed"):
        router.submit(xs[1], now=2.0)
    router.verify_router_accounting()


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 3),
       kind=st.sampled_from(("crash", "stall", "flap")),
       after=st.integers(0, 3), times=st.integers(1, 4),
       hedge=st.sampled_from((None, 0.0, 1e-3)),
       defer=st.lists(st.booleans(), min_size=6, max_size=6))
def test_exactly_one_terminal_state_under_chaos(harness, n, kind, after,
                                                times, hedge, defer):
    sides, xs, oracle = harness
    pkg, engines = sides["port"]
    pool, router = _router(pkg, engines, n, timeout_s=0.01,
                           hedge_after_s=hedge, max_retries=2)
    rep = pool.get("r0")
    if kind == "crash":
        pkg.crash(rep, after=after, times=times)
    elif kind == "stall":
        pkg.slow(rep, 0.05, after=after, times=times)
    else:
        pkg.flap(rep, period=1, after=after, times=times)
    reqs = [router.submit(xs[i], now=i * 1e-3, defer=d)
            for i, d in enumerate(defer)]
    router.flush(now=1.0)
    acc = router.verify_router_accounting()
    assert all(r.status in TERMINAL for r in reqs)
    assert sum(a["in_flight"] for a in acc.values()) == 0
    for i, r in enumerate(reqs):
        if r.status == "answered":
            assert sum(a.outcome == "ok" for a in r.attempts) == 1
            np.testing.assert_array_equal(
                np.asarray(r.result).view(np.int32),
                oracle.predict_one(xs[i]).view(np.int32))
