"""The port's single-card drivers of the main path against the JAX
package's, on the CPU: ``RNNServingEngine.benchmark``,
``launch/serve.py`` (``serve_rnn``, ``serve_lm``, ``main``) and the
examples (``repro_torch.examples``), plus the engines' release of their
memory without the cycle collector.

Weights are initialised by ``repro`` (JAX) and cross through
``params_from_jax`` / ``lm_params_from_jax`` where answers are compared.
``benchmark``'s analytical fields and the FPGA design points are held to
``repro``'s exactly; served answers to the same engine's ``predict`` bit
for bit (the engine is batch-invariant) and to ``repro``'s reference
forward within ``CONFORMANCE_TOL["float32"]`` = 3e-5 x max(1, |want|).
On a CPU tensor the kernel path runs each kernel's plain version.
"""

import gc
import importlib
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.config import FixedPointConfig as JFixedPointConfig  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import rnn_tagger as jtagger  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.serving.lm_engine import LMServingEngine as JLMEngine  # noqa: E402,E501
from repro.testing import CONFORMANCE_TOL  # noqa: E402
from repro.testing import tiny_config as jtiny_config  # noqa: E402

from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.decode import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.serving import (LMServingEngine,  # noqa: E402
                                 RNNServingEngine, SpecConfig)
from repro_torch.testing import tiny_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = CONFORMANCE_TOL["float32"]
EXAMPLES = ("_common", "quickstart", "serve_tagger", "streaming_scenarios",
            "quantization_scan", "lm_pretrain")
FPGA_FIELDS = ("latency_min_us", "latency_max_us", "ii_cycles", "dsp",
               "fits", "part", "throughput_eps")


def _jparams(arch):
    p = jbuild_model(jget_config(arch)).init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


def _assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err


# ---------------------------------------------------------------------------
# RNNServingEngine.benchmark
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reuse", [1, 2, 4])
def test_benchmark_matches_repro(reuse):
    """The same key, batch and analytical fields as ``repro``'s
    ``benchmark`` for the same schedule, with finite times."""
    arch = "top-tagging-gru"
    jp = _jparams(arch)
    eng = RNNServingEngine(get_config(arch), params_from_jax(jp, "cpu"),
                           max_batch=8, device="cpu")
    jeng = JEngine(jget_config(arch), jp, max_batch=8)
    got = eng.benchmark(3, iters=2, schedule=KernelSchedule(
        reuse_factor=reuse, mode="static", backend="xla"))
    want = jeng.benchmark(3, iters=2, schedule=JSchedule(
        reuse_factor=reuse, mode="static", backend="xla"))
    assert sorted(got) == sorted(want)
    for k in ("key", "batch", "latency_cycles", "ii_cycles", "dsp"):
        assert got[k] == want[k], k
    assert np.isfinite(got["latency_s"]) and got["latency_s"] > 0
    assert got["throughput_eps"] == pytest.approx(3 / got["latency_s"])


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_benchmark_keeps_one_executor_per_key(backend):
    """``repro``'s regression: benchmark at batch sizes 2, 4 and 7 runs
    the key's padded serving shape, so the key keeps one executor build;
    the kernel path (the plain versions here) and the reference alike."""
    cfg = get_config("top-tagging-gru")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    s = KernelSchedule(reuse_factor=1, mode="static", backend=backend)
    eng = RNNServingEngine(cfg, params, max_batch=8, device="cpu")
    rows = [eng.benchmark(b, iters=1, schedule=s) for b in (2, 4, 7)]
    assert {r["key"] for r in rows} == {s.key()}
    assert eng.trace_count(s.key()) == 1
    assert [r["batch"] for r in rows] == [2, 4, 7]


def test_benchmark_finite_and_monotone_in_reuse():
    """The default backend's keys (the kernel path) at R 1, 2, 4: finite
    times, three keys, the paper's trade-off in the analytical column
    (latency up, DSP down as R grows)."""
    cfg = get_config("top-tagging-gru")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    eng = RNNServingEngine(cfg, params, max_batch=8, device="cpu")
    rows = [eng.benchmark(4, iters=2, schedule=KernelSchedule(
        reuse_factor=r, mode="static")) for r in (1, 2, 4)]
    assert len({b["key"] for b in rows}) == 3
    for b in rows:
        assert np.isfinite(b["latency_s"]) and b["latency_s"] > 0
        assert np.isfinite(b["throughput_eps"])
    lat = [b["latency_cycles"] for b in rows]
    dsp = [b["dsp"] for b in rows]
    assert all(a < b for a, b in zip(lat, lat[1:])), lat
    assert all(a > b for a, b in zip(dsp, dsp[1:])), dsp


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mode,fixed_point,reuse", [
    ("top-tagging-gru", "static", False, 1),
    ("top-tagging-lstm", "nonstatic", False, 4),
    ("top-tagging-gru", "static", True, 2)])
def test_serve_rnn_matches_repro(arch, mode, fixed_point, reuse):
    """Every request served once; the answers equal the engine's
    ``predict`` of the same rows bit for bit and, in float, ``repro``'s
    reference forward within 3e-5; the FPGA design point equals
    ``repro``'s ``fpga_design`` for the same config, fp and reuse."""
    n = 24
    jp = _jparams(arch)
    rep = tserve.serve_rnn(arch, mode, n, fixed_point, reuse, device="cpu",
                           params=params_from_jax(jp, "cpu"))
    assert rep["served"] == n and rep["answers"].shape[0] == n
    assert np.isfinite(rep["events_per_s"]) and rep["events_per_s"] > 0
    assert 0 < rep["latency_p50_ms"] <= rep["latency_p99_ms"]
    eng = rep["engine"]
    want = eng.predict(rep["x"])
    assert np.array_equal(rep["answers"].view(np.int32), want.view(np.int32))
    jcfg = jget_config(arch)
    if not fixed_point:
        _assert_close(rep["answers"], jtagger.forward(
            jcfg, jp, jax.numpy.asarray(rep["x"]), impl="xla"))
    jfp = JFixedPointConfig(16, 6) if fixed_point else None
    d = JEngine(jcfg, jp, mode=mode, fp=jfp).fpga_design(
        reuse_kernel=reuse, reuse_recurrent=reuse,
        strategy="resource" if reuse > 1 else "latency")
    assert rep["fpga"] == {k: getattr(d, k) for k in FPGA_FIELDS}


def test_serve_rnn_payloads_and_default_params():
    """The request load is ``repro``'s (its dataset, seed 3); with no
    ``params`` the engine serves the port's seeded init."""
    from repro.data import quickdraw_dataset as jquickdraw

    cfg = get_config("quickdraw-gru")
    assert np.array_equal(tserve.request_load(cfg, 5),
                          jquickdraw(5, seed=3)[0])
    rep = tserve.serve_rnn("top-tagging-gru", n_requests=6, device="cpu")
    cfg = get_config("top-tagging-gru")
    eng = RNNServingEngine(cfg, build_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    assert np.array_equal(rep["answers"], eng.predict(rep["x"]))


def test_serve_lm_serves_repros_tokens():
    """Every request of the continuous-batching loop is served, and the
    tokens equal ``repro``'s engine run through the same loop on the same
    tiny-config weights."""
    arch, n = "gemma-2b", 6
    jcfg = jtiny_config(jget_config(arch))
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    rep = tserve.serve_lm(arch, n, device="cpu", params=lm_params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    jeng = JLMEngine(jcfg, jp, max_batch=4, max_seq=64)
    rng = np.random.RandomState(0)
    pending = [list(rng.randint(2, jcfg.vocab_size, rng.randint(2, 8)))
               for _ in range(n)]
    want = {}
    while pending or any(s.active for s in jeng.slots):
        while pending and jeng.add_request(pending[0], max_new=8) is not None:
            pending.pop(0)
        want.update(jeng.tick())
    assert rep["requests"] == n and rep["finished"] == want
    assert rep["tokens"] == sum(len(v) for v in want.values())
    assert rep["tokens_per_s"] > 0


def test_main_parses_its_arguments(capsys):
    rep = tserve.main(["--arch", "top-tagging-lstm", "--mode", "nonstatic",
                       "--requests", "5", "--reuse", "2", "--device", "cpu"])
    assert rep["served"] == 5 and rep["mode"] == "nonstatic"
    assert rep["fixed_point"] is False
    lm = tserve.main(["--arch", "mamba2-780m", "--requests", "3", "--device",
                      "cpu"])
    assert lm["requests"] == 3
    out = capsys.readouterr().out
    assert "[serve] top-tagging-lstm mode=nonstatic fp=off on CPU" in out
    assert "paired FPGA design point" in out
    assert "[serve] mamba2-780m (tiny) on CPU: 3 requests" in out


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "top-tagging-gru", "--requests", "8", "--fixed-point", "--device",
         "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests" in out.stdout
    assert "fp=16,6" in out.stdout


def test_drivers_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tserve.serve_rnn("top-tagging-gru", n_requests=1),
                 lambda: tserve.serve_lm("gemma-2b", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from repro_torch.examples import quickstart

    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(steps=1)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports(name):
    """Each example is a module of the package (``python -m
    repro_torch.examples.<name>``) with a ``main``; what it may import is
    checked with every module in ``tests/test_torch_package.py``."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert callable(mod.train_tagger if name == "_common" else mod.main)


def test_train_tagger_matches_benchmarks_common(monkeypatch):
    """The examples' ``train_tagger`` is ``benchmarks/common.py``'s
    protocol: 3 steps from ``repro``'s seed-0 weights land within the
    train-step tolerance of ``tests/test_torch_training.py``."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import common as bcommon
    from repro_torch.examples import _common

    monkeypatch.setattr(bcommon, "_CACHE", {})
    arch, steps = "top-tagging-gru", 3
    _, _, want = bcommon.train_tagger(arch, steps=steps)
    _, _, got = _common.train_tagger(
        arch, steps=steps, device="cpu",
        params=params_from_jax(_jparams(arch), "cpu"))
    for k, w in want.items():
        w = np.asarray(w)
        assert float(np.abs(got[k].numpy() - w).max()) <= 1e-2 * 5e-3 * steps
    assert _common.dataset_for("quickdraw-lstm").__name__ == \
        bcommon.dataset_for("quickdraw-lstm").__name__


def test_quickstart_runs_reduced(capsys):
    from repro_torch.examples import quickstart

    rep = quickstart.main(steps=3, device="cpu", events=200)
    assert 0.0 <= rep["auc_float"] <= 1.0 and 0.0 <= rep["auc_ap16_6"] <= 1.0
    b = rep["benchmark"]
    assert b["batch"] == 1 and np.isfinite(b["latency_s"])
    d = JEngine(jget_config("top-tagging-gru"), _jparams("top-tagging-gru"),
                mode="static", fp=JFixedPointConfig(16, 6)).fpga_design(
                    strategy="latency")
    assert rep["fpga_latency_us"] == d.latency_min_us
    assert rep["fpga_ii"] == d.ii_cycles and rep["nonstatic_ii"] == 1
    assert "serving batch-1 latency (CPU)" in capsys.readouterr().out


def test_quantization_scan_runs_reduced():
    from repro_torch.examples import quantization_scan

    scan = quantization_scan.main(steps=2, device="cpu", events=100)
    assert sorted(scan) == [6, 8, 10, 12]
    for curve in scan.values():
        assert [fb for fb, _ in curve] == list(quantization_scan.FRAC_BITS)
        assert all(np.isfinite(r) and r > 0 for _, r in curve)


def test_lm_pretrain_runs_reduced(tmp_path):
    from repro_torch.examples import lm_pretrain

    rep = lm_pretrain.main(steps=2, arch="gemma-2b", device="cpu",
                           checkpoint_dir=str(tmp_path), resume_steps=2,
                           batch=2, seq_len=16)
    assert np.isfinite(rep["loss"]) and np.isfinite(rep["resumed_loss"])
    assert (tmp_path / "step_000000004").is_dir()


def test_streaming_scenarios_runs_reduced():
    from repro_torch.examples import streaming_scenarios

    acc = streaming_scenarios.main(events=24, steps=2, device="cpu")
    assert sorted(acc) == ["stress", "ticks", "trigger"]
    for per_key in acc.values():
        assert sum(c["submitted"] for c in per_key.values()) == 24


# ---------------------------------------------------------------------------
# a dropped engine frees its memory without the cycle collector
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cycle_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_dropped_rnn_engine_is_freed_at_once(no_cycle_collector):
    """An engine that served every path (predict, predict_one, a flush,
    benchmark) dies when its last reference goes: its executors hold no
    reference back to it."""
    cfg = get_config("top-tagging-gru")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    eng = RNNServingEngine(cfg, params, max_batch=4, device="cpu")
    x = np.random.RandomState(0).randn(
        3, cfg.rnn.seq_len, cfg.rnn.input_size).astype(np.float32)
    eng.predict(x)
    eng.predict_one(x[0])
    eng.submit(x[1])
    eng.flush(force=True)
    eng.benchmark(2, iters=1)
    refs = [weakref.ref(eng), weakref.ref(eng.model)]
    del eng
    assert [r() is None for r in refs] == [True, True]


def test_dropped_lm_engine_is_freed_at_once(no_cycle_collector):
    """An LM engine with a plain, a scheduled and a speculative key served
    dies with its decoders, speculative decoders and KV caches when its
    last reference goes."""
    cfg = tiny_config(get_config("gemma-2b"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    eng = LMServingEngine(cfg, params, max_batch=2, max_seq=32, device="cpu")
    eng.add_request([1, 2, 3], max_new=3)
    eng.add_request([1, 2, 3], max_new=3,
                    schedule=KernelSchedule(reuse_factor=1))
    eng.add_request([1, 2, 3], max_new=3, spec=SpecConfig(k=2))
    eng.run_to_completion()
    decs = list(eng._decoders.values())
    assert len(decs) == 3 and all(d.traces == 1 for d in decs[:2])
    spec = [d.spec_dec for d in decs if d.spec_dec is not None]
    assert len(spec) == 1 and spec[0].verify_traces == 1
    refs = ([weakref.ref(eng)] + [weakref.ref(d) for d in decs + spec]
            + [weakref.ref(t) for d in decs for t in d.cache.values()])
    del eng, decs, spec
    assert all(r() is None for r in refs), sum(r() is not None for r in refs)
