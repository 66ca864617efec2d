"""The port as a package: what it imports, where it runs, what it refuses.

  * No module of ``repro_torch`` and not ``chip_smoke.py`` imports ``jax``,
    any module of ``repro`` or ``benchmarks`` (checked in a fresh interpreter, and in the
    sources' import statements).
  * Entry points (the engines, ``autotune.measure_points`` and a measured
    ``autotune.select``) run on ``"cuda"`` unless told otherwise, and raise
    where there is no CUDA device instead of carrying on on the CPU.
  * The kernel backends run every float schedule (static, non-static,
    pipeline, ``hoist_reuse`` > 1) and the fixed-point datapaths;
    ``backend="xla"`` runs every mode.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.config import FixedPointConfig as JFixedPoint  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_kernel_inputs  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.config import FixedPointConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.kernels import fixed_point as tfxp  # noqa: E402
from repro_torch.kernels import lstm_scan as tlstm  # noqa: E402
from repro_torch.kernels import quantized as tquant  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models.init import ParamSpec, init_param  # noqa: E402
from repro_torch.models.rnn_tagger import (RNNTagger, param_specs,  # noqa: E402
                                           params_from_jax)
from repro_torch.serving import RNNServingEngine  # noqa: E402
from repro_torch.serving.engine import EngineClosedError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent


def test_no_jax_or_repro_in_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro",
                                           "benchmarks"), \
                f"{path.name} imports {n}"


#: serving robustness: the modules the port keeps beside its engines
ROBUSTNESS = ("compile_cache", "faults", "replica", "router", "streaming")


@pytest.mark.parametrize("name", ROBUSTNESS)
def test_robustness_module_imports_alone_without_jax(name):
    code = (f"import sys\nimport repro_torch.serving.{name}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_exports_what_repro_exports():
    """``repro_torch.serving`` exports every public name of
    ``repro.serving``."""
    import types

    import repro.serving as jserving

    import repro_torch.serving as tserving

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    missing = public(jserving) - public(tserving)
    assert not missing, sorted(missing)


def _tagger(name="top-tagging-gru"):
    cfg = get_config(name)
    specs = param_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    return cfg, {k: init_param(s, gen) for k, s in specs.items()}


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tagger()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNNServingEngine(cfg, params)               # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNNServingEngine(cfg, params, device="cuda")
    assert RNNServingEngine(cfg, params, device="cpu").impl == "pallas"


def test_measurement_asks_for_cuda(monkeypatch):
    """``measure_points`` and a measured ``select`` time on "cuda" unless
    told otherwise, and raise where there is no CUDA device instead of
    timing the plain versions on the CPU."""
    from repro_torch import autotune as at

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _tagger()
    target = at.DesignTarget(objective="latency")
    spec = at.SpaceSpec(reuse_factors=(1,))
    top = at.explore(cfg, target, spec).feasible[:2]
    before = dict(cuda.LAUNCHES)
    for call in (lambda: at.measure_points(cfg, top),
                 lambda: at.measure_points(cfg, top, device="cuda"),
                 lambda: at.select(cfg, target, spec, measure_top_k=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert cuda.LAUNCHES == before
    # the analytic selection needs no device; the CPU is asked for by name
    assert at.select(cfg, target, spec).key == top[0].key
    walls = at.measure_points(cfg, top, batch=2, iters=1, device="cpu")
    assert sorted(walls) == sorted(p.key for p in top)
    assert cuda.LAUNCHES == before


def test_kernel_wrapper_never_falls_back():
    """Dispatch goes by the tensor's device: a CPU tensor runs the plain
    version without touching CUDA; a device with no kernel raises."""
    xs, W, U, b = (torch.from_numpy(np.array(a)) for a in
                   make_kernel_inputs("lstm", B=2, T=3, H=8))
    xi = torch.ones(4, 6, dtype=torch.int8)
    wi = torch.ones(6, 8, dtype=torch.int8)
    fp = FixedPointConfig(8, 3)
    before = dict(cuda.LAUNCHES)
    out = tlstm.lstm_scan_kernel(xs, W, U, b)
    assert out.shape == (2, 8) and cuda.LAUNCHES == before
    assert tquant.quant_matmul_kernel(xi, wi).eq(6).all()
    assert tfxp.fixed_point_kernel(xs, fp).shape == xs.shape
    assert cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tlstm.lstm_scan_kernel(xs.to("meta"), W.to("meta"), U.to("meta"),
                               b.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tquant.quant_matmul_kernel(xi.to("meta"), wi.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfxp.fixed_point_kernel(xs.to("meta"), fp)


@pytest.mark.parametrize("sched", (
    KernelSchedule(mode="nonstatic"), KernelSchedule(mode="pipeline"),
    KernelSchedule(hoist_input=True, hoist_reuse=2),
    KernelSchedule(mode="nonstatic", backend="pallas_interpret")),
    ids=lambda s: s.key())
def test_unported_modes_raise_on_kernel_backends(sched):
    """The schedules the first slice of the port refused on a kernel
    backend now run there: the scan matches repro's kernel path, and the
    engine (per request and as its default) matches its own reference."""
    cfg, params = _tagger()
    inputs = make_kernel_inputs("gru", B=2, T=3, H=8)
    xs, W, U, b = (torch.from_numpy(np.array(a)) for a in inputs)
    jsched = JSchedule(**{**sched.__dict__, "backend": "pallas_interpret"})
    want = np.asarray(jops.gru_scan(*inputs, schedule=jsched))
    got = ops.gru_scan(xs, W, U, b, schedule=sched).numpy()
    assert np.abs(got - want).max() <= CONFORMANCE_TOL["float32"]
    x = np.random.RandomState(0).randn(2, 20, 6).astype(np.float32)
    ref = RNNServingEngine(cfg, params, device="cpu", impl="xla").predict(x)
    eng = RNNServingEngine(cfg, params, device="cpu", max_batch=4)
    for out in (eng.predict(x, schedule=sched),
                RNNServingEngine(cfg, params, device="cpu", schedule=sched
                                 ).predict(x)):
        assert np.abs(out - ref).max() <= CONFORMANCE_TOL["float32"]


@pytest.mark.parametrize("mode", ("nonstatic", "pipeline"))
@pytest.mark.parametrize("cell", ("lstm", "gru"))
def test_xla_backend_runs_every_mode(cell, mode):
    """With impl="xla" every mode runs, as in repro (held to its engine)."""
    name = f"top-tagging-{cell}"
    jcfg = jget_config(name)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(1)).items()}
    x = np.random.RandomState(0).randn(3, 20, 6).astype(np.float32)
    got = RNNServingEngine(get_config(name), params_from_jax(jparams, "cpu"),
                           impl="xla", mode=mode, device="cpu",
                           max_batch=4).predict(x)
    want = JEngine(jcfg, jparams, impl="xla", mode=mode,
                   max_batch=4).predict(x)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= CONFORMANCE_TOL["float32"]


def test_fixed_point_serves_and_keys_match_repro():
    """``fp`` serves on the engine (as its default and per request), each
    (schedule, fp) pair under repro's key."""
    from repro.kernels.schedule import schedule_key as jkey
    from repro_torch.kernels.schedule import schedule_key as tkey

    cfg, params = _tagger()
    x = np.random.RandomState(0).randn(2, 20, 6).astype(np.float32)
    fp = FixedPointConfig(8, 3)
    eng = RNNServingEngine(cfg, params, device="cpu", fp=fp)
    out = eng.predict(x)
    assert out.shape == (2, 1) and np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, RNNServingEngine(cfg, params, device="cpu").predict(x, fp=fp))
    wide = RNNServingEngine(cfg, params, device="cpu").predict(
        x, fp=FixedPointConfig())
    assert np.abs(wide - out).max() > 0      # another datapath, another key
    for sched in (KernelSchedule(), KernelSchedule(mode="pipeline")):
        for f, jf in ((FixedPointConfig(), JFixedPoint()),
                      (fp, JFixedPoint(8, 3)),
                      (FixedPointConfig(8, 4, saturation="wrap"),
                       JFixedPoint(8, 4, saturation="wrap"))):
            assert tkey(sched, f) == jkey(sched, jf)
    assert list(eng._infer_cache) == [tkey(eng.resolved_schedule, fp)]


def test_closed_engine_refuses_work():
    cfg, params = _tagger()
    eng = RNNServingEngine(cfg, params, device="cpu", max_batch=4)
    req = eng.submit(np.zeros((20, 6), np.float32))
    assert [r.req_id for r in eng.close()] == [req.req_id]
    assert req.status == "answered" and eng.closed and eng.close() == []
    for call in (lambda: eng.predict(np.zeros((1, 20, 6), np.float32)),
                 lambda: eng.predict_one(np.zeros((20, 6), np.float32)),
                 lambda: eng.submit(np.zeros((20, 6), np.float32))):
        with pytest.raises(EngineClosedError):
            call()


def test_seeded_init_is_deterministic_and_keras_shaped():
    cfg = get_config("flavor-tagging-lstm")
    a = RNNTagger(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = RNNTagger(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = RNNTagger(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    for k in a.weights:
        assert torch.equal(a.weights[k], b.weights[k])
    assert not torch.equal(a.weights["rnn/kernel"], c.weights["rnn/kernel"])
    U = a.weights["rnn/recurrent"]                     # [h, 4h]: orthonormal rows
    eye = torch.eye(U.shape[0])
    assert torch.allclose(U @ U.T, eye, atol=1e-5)
    W = a.weights["rnn/kernel"]
    std = 1.0 / np.sqrt(W.shape[0])
    assert float(W.abs().max()) <= 2 * std + 1e-6      # truncated at 2 sigma
    assert float(a.weights["rnn/bias"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown init"):
        init_param(ParamSpec((2,), "bogus"), torch.Generator())


def test_params_from_jax_keeps_the_layout():
    jcfg = jget_config("quickdraw-gru")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jparams, "cpu")
    for k, v in jparams.items():
        assert tparams[k].dtype == torch.float32
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
    assert tparams["rnn/bias"].shape == (2, 3 * 128)
    bad = dict(jparams, **{"rnn/bias": np.zeros(3 * 128, np.float32)})
    with pytest.raises(ValueError, match="Keras layout"):
        params_from_jax(bad, "cpu")
    with pytest.raises(KeyError):
        params_from_jax({"head/w": np.zeros((2, 2))}, "cpu")
    with pytest.raises(ValueError, match="expected"):
        RNNTagger(get_config("quickdraw-lstm").replace(name="q"),
                  {k: v for k, v in tparams.items()}, device="cpu")


def test_launch_arguments_are_checked_before_any_launch():
    """``cuda.require`` runs before a kernel launch; it needs no GPU."""
    xs = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    w = torch.zeros(4, 8)
    assert cuda.require("k", torch.bfloat16, xs=xs, W=w) == xs.device
    with pytest.raises(TypeError, match="activations"):
        cuda.require("k", torch.float16, W=w)
    with pytest.raises(TypeError, match="xs must be torch.float32"):
        cuda.require("k", torch.float32, xs=xs, W=w)
    with pytest.raises(TypeError, match="W must be torch.float32"):
        cuda.require("k", torch.bfloat16, xs=xs, W=w.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda.require("k", torch.float32, W=w.t())
    with pytest.raises(ValueError, match="expected"):
        cuda.require("k", torch.float32, W=w, U=w.to("meta"))
    # the integer kernels' check
    xi = torch.zeros(4, 8, dtype=torch.int8)
    assert cuda.require_int8("k", x=xi, w=xi.t().contiguous()) == xi.device
    with pytest.raises(TypeError, match="w must be torch.int8"):
        cuda.require_int8("k", x=xi, w=xi.int())
    with pytest.raises(ValueError, match="contiguous"):
        cuda.require_int8("k", x=xi, w=xi.t())
    with pytest.raises(ValueError, match="expected"):
        cuda.require_int8("k", x=xi, w=xi.to("meta"))


def test_build_needs_nvcc_and_names_libraries_by_source(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "kernels")
    assert set(cuda.SIGNATURES) == {"rnn_scan", "reuse_matmul", "quantized",
                                    "decode_matmul", "rglru_scan", "hadamard"}
    paths = {n: cuda.library_path(n) for n in cuda.SIGNATURES}
    for name, path in paths.items():
        assert path == cuda.library_path(name)
        assert path.parent == tmp_path / "kernels"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (cuda.CSRC / f"{name}.cu").exists()
        # every library reports its own errors, and every kernel it exports
        # has a launch counter
        assert "kernel_error_string" in cuda.SIGNATURES[name]
    assert len(set(paths.values())) == 6
    # a route's entry point counts under its kernel: gru_scan_hoisted past
    # the cluster kernel's H runs through gru_scan_hoisted_block
    kernels = {fn.removesuffix("_block") for sigs in cuda.SIGNATURES.values()
               for fn in sigs
               if fn not in ("kernel_error_string", "scan_rows_per_block",
                             "cluster_scan_resident",
                             "cluster_zx_scan_resident", "col_matmul_layout",
                             "reuse_matmul_layout", "quant_matmul_layout",
                             "rglru_scan_layout")}
    assert kernels == set(cuda.LAUNCHES) and len(kernels) == 13
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()
    assert not (tmp_path / "kernels").exists()
