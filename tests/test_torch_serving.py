"""The port's tagger and serving engine against the JAX package's, on the
CPU, for all six (config x cell) taggers at their published widths.

Weights are initialised by ``repro`` (JAX) and cross through
``params_from_jax``; request payloads come from numpy with a seed.  The
reference is ``repro``'s ``forward(impl="xla")`` and its engine on
``impl="xla"``; the port runs both its kernel path (``impl="pallas"``: the
kernels' plain versions on a CPU tensor) and its reference path.

Tolerance: ``CONFORMANCE_TOL["float32"]`` = 3e-5 x max(1, |want|) on the
served probabilities (float32 accumulation order differs between XLA and
PyTorch).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import build_model  # noqa: E402
from repro.models import rnn_tagger as jtagger  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule, schedule_key  # noqa: E402,E501
from repro_torch.models.rnn_tagger import RNNTagger, params_from_jax  # noqa: E402,E501
from repro_torch.serving import RNNServingEngine  # noqa: E402

TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
TOL = CONFORMANCE_TOL["float32"]
MAX_BATCH = 8


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    limit = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"max_err={err:.3e} > {limit:.3e}"


@pytest.fixture(scope="module", params=TAGGERS)
def tagger(request):
    """(name, jax cfg, jax params, port cfg, port params, payloads)."""
    name = request.param
    jcfg = jget_config(name)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    r = jcfg.rnn
    x = np.random.RandomState(7).randn(6, r.seq_len, r.input_size)
    return (name, jcfg, jparams, get_config(name),
            params_from_jax(jparams, "cpu"), x.astype(np.float32))


@pytest.fixture(scope="module")
def engines(tagger):
    """The port's kernel-path engine and repro's reference engine."""
    _, jcfg, jparams, tcfg, tparams, _ = tagger
    return (RNNServingEngine(tcfg, tparams, device="cpu",
                             max_batch=MAX_BATCH),
            JEngine(jcfg, jparams, impl="xla", max_batch=MAX_BATCH))


@pytest.mark.parametrize("impl", ("pallas", "xla"))
def test_forward_matches_repro(tagger, impl):
    _, jcfg, jparams, tcfg, tparams, x = tagger
    want = jtagger.forward(jcfg, jparams, jax.numpy.asarray(x), impl="xla")
    model = RNNTagger(tcfg, tparams, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), impl=impl)
        logits = model(torch.from_numpy(x), impl=impl, return_logits=True)
    assert_close(got, want)
    assert_close(logits, jtagger.forward(jcfg, jparams, jax.numpy.asarray(x),
                                         impl="xla", return_logits=True))


def test_engine_predict(tagger, engines):
    eng, ref = engines
    x = tagger[-1]
    assert eng.impl == "pallas" and ref.impl == "xla"
    assert_close(eng.predict(x), ref.predict(x))
    for s in (KernelSchedule(reuse_factor=4, block_batch=8),
              KernelSchedule(hoist_input=True, block_batch=8)):
        assert_close(eng.predict(x, schedule=s), ref.predict(x))
    for key in eng._infer_cache:
        assert eng.trace_count(key) == 1


def test_engine_predict_one(tagger, engines):
    eng, ref = engines
    x = tagger[-1]
    for i in range(3):
        assert_close(eng.predict_one(x[i]), ref.predict_one(x[i]))
    key = schedule_key(eng.resolved_schedule)
    assert key == schedule_key(ref.resolved_schedule.replace(
        backend="auto"))
    assert eng.one_trace_count(key) == 1
    assert eng.serve_report()[key]["fast_path"]["served"] == 2.0


def test_engine_submit_flush(tagger, engines):
    eng, ref = engines
    x = tagger[-1]
    hoist = KernelSchedule(hoist_input=True)
    reqs = [eng.submit(x[i]) for i in range(4)]
    reqs += [eng.submit(x[i], schedule=hoist) for i in range(4, 6)]
    done = eng.flush(force=True)
    assert {q.req_id for q in done} == {q.req_id for q in reqs}
    assert all(q.status == "answered" for q in reqs)
    assert_close(np.stack([q.result for q in reqs]), ref.predict(x))
    want = [ref.submit(x[i]) for i in range(6)]
    ref.flush(force=True)
    assert_close(np.stack([q.result for q in reqs]),
                 np.stack([q.result for q in want]))
    for key in (schedule_key(eng.resolved_schedule), schedule_key(hoist)):
        assert eng.trace_count(key) == 1
        assert eng.serve_report()[key]["traces"] == 1
    assert eng.serve(list(x[:2]))[1].status == "answered"
    assert eng.drain() == []


@pytest.mark.parametrize("policy", ("bucket", "mask"))
def test_engine_predict_ragged(tagger, policy):
    _, jcfg, jparams, tcfg, tparams, x = tagger
    T = x.shape[1]
    xs = [x[0, :T], x[1, :T - 3], x[2, :T - 1], x[3, :T - 3], x[4, :1]]
    eng = RNNServingEngine(tcfg, tparams, device="cpu", max_batch=MAX_BATCH,
                           ragged=policy)
    ref = JEngine(jcfg, jparams, impl="xla", max_batch=MAX_BATCH,
                  ragged=policy)
    got, want = eng.predict_ragged(xs), ref.predict_ragged(xs)
    assert_close(np.stack(got), np.stack(want))
    assert eng.trace_count(schedule_key(eng.resolved_schedule)) == 1
    # a ragged queue flushes through the same policy
    reqs = [eng.submit(p) for p in xs]
    eng.flush(force=True)
    assert_close(np.stack([q.result for q in reqs]), np.stack(want))
