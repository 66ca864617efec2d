"""The port's conformance harness (``repro_torch.testing``) against
``repro.testing``, on the CPU.

  * ``tiny_config`` equal to ``repro``'s field by field for every config
    the port carries (the attention chunks and ``remat`` of the sequence
    forward included);
  * ``make_kernel_inputs`` / ``make_quantized_inputs``: the same numpy
    draws as ``repro``'s, bit for bit, in float32 and bfloat16 (float64 ->
    bfloat16 rounds as ``jnp.asarray`` rounds, checked at values where a
    single rounding and a rounding through float32 differ);
  * the numpy quantized goldens equal to ``repro``'s on the same inputs;
  * ``assert_schedule_conformance`` / ``assert_quantized_conformance`` on
    the port's ``ops.SCHEDULED_KERNELS`` over every mode, R and dtype, and
    raising on a kernel that is off;
  * ``serving_golden`` within ``CONFORMANCE_TOL`` of ``repro``'s, and
    ``assert_serving_conformance`` on a CPU engine.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro import testing as jtesting  # noqa: E402
from repro.config import FixedPointConfig as JFixedPoint  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402

from repro_torch import testing as ttesting  # noqa: E402
from repro_torch.config import (PORT_ONLY_FIELDS,  # noqa: E402
                                FixedPointConfig, ModelConfig)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.serving import RNNServingEngine  # noqa: E402

PORTED = ("gemma-2b", "stablelm-3b", "deepseek-coder-33b", "nemotron-4-340b",
          "mamba2-780m", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
          "recurrentgemma-9b", "whisper-medium", "phi-3-vision-4.2b",
          "top-tagging-lstm", "quickdraw-gru")
DTYPES = ("float32", "bfloat16")
SHAPES = {"lstm": dict(B=3, T=5, F=4, H=8), "gru": dict(B=5, T=4, F=3, H=12),
          "rglru": dict(B=2, T=9, H=20), "reuse_matmul": dict(M=9, K=20, N=12)}
SCAN_SCHEDULES = {
    "static": dict(), "static_hoist": dict(hoist_input=True),
    "nonstatic": dict(mode="nonstatic"), "pipeline": dict(mode="pipeline")}


def _bits(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if "bfloat16" in str(a.dtype) else a


def _same_bits(got, want):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("arch", PORTED)
def test_tiny_config_equals_repro(arch):
    got = ttesting.tiny_config(get_config(arch))
    want = jtesting.tiny_config(jget_config(arch))
    for f in dataclasses.fields(ModelConfig):
        g = getattr(got, f.name)
        if f.name in PORT_ONLY_FIELDS:      # repro has none of them
            assert g == f.default, (arch, f.name, g)
            continue
        w = getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, (arch, f.name, g, w)


def test_constants_equal_repro():
    assert ttesting.CONFORMANCE_TOL == jtesting.CONFORMANCE_TOL
    nat, jnat = ttesting.native_fp_configs(), jtesting.native_fp_configs()
    assert {k: dataclasses.asdict(v) for k, v in nat.items()} == \
        {k: dataclasses.asdict(v) for k, v in jnat.items()}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_make_kernel_inputs_bit_for_bit(kernel, dtype, seed):
    for shapes in ({}, SHAPES[kernel]):
        got = ttesting.make_kernel_inputs(kernel, dtype=dtype, seed=seed,
                                          device="cpu", **shapes)
        want = jtesting.make_kernel_inputs(kernel, dtype=dtype, seed=seed,
                                           **shapes)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            _same_bits(g, w)


def test_bfloat16_rounding_of_float64_draws():
    """Values whose float64 -> bfloat16 rounding differs between one
    rounding and a rounding through float32: the port rounds as
    ``jnp.asarray`` does."""
    half = 2.0 ** -8                                      # bf16 half-ulp at 1
    x = np.array([1 + half + 2 ** -30, 1 + half - 2 ** -30, 1 + 3 * half
                  - 2 ** -30, -(1 + half + 2 ** -40), 3.0e-39, 1e38 * 3.3],
                 np.float64)
    got = ttesting._tensor(x, torch.bfloat16, "cpu")
    _same_bits(got, jnp.asarray(x, dtype=jnp.bfloat16))


@pytest.mark.parametrize("fp", ["int8", "int4"])
@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_quantized_inputs_and_goldens_equal_repro(kernel, fp):
    tfp = ttesting.native_fp_configs()[fp]
    jfp = JFixedPoint(**dataclasses.asdict(tfp))
    got = ttesting.make_quantized_inputs(kernel, tfp, seed=3, device="cpu",
                                         **SHAPES[kernel])
    want = jtesting.make_quantized_inputs(kernel, jfp, seed=3,
                                          **SHAPES[kernel])
    for g, w in zip(got, want):
        _same_bits(g, w)
    _same_bits(ttesting.QUANTIZED_GOLDENS[kernel](*got, tfp),
               jtesting.QUANTIZED_GOLDENS[kernel](*want, jfp))


def _scan_schedules():
    for kw in SCAN_SCHEDULES.values():
        for reuse in (1, 4):
            yield KernelSchedule(reuse_factor=reuse, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["lstm", "gru"])
def test_schedule_conformance_sweep(kernel, dtype):
    for s in _scan_schedules():
        ttesting.assert_schedule_conformance(kernel, s, dtype=dtype,
                                             device="cpu", **SHAPES[kernel])


@pytest.mark.parametrize("dtype", DTYPES)
def test_schedule_conformance_rglru_and_matmul(dtype):
    for reuse in (1, 2, 4):
        s = KernelSchedule(reuse_factor=reuse)
        ttesting.assert_schedule_conformance("rglru", s, dtype=dtype,
                                             device="cpu", **SHAPES["rglru"])
        ttesting.assert_schedule_conformance("reuse_matmul", s, dtype=dtype,
                                             device="cpu", M=9, K=20, N=16)


def test_schedule_conformance_raises_on_a_kernel_that_is_off(monkeypatch):
    scan, golden = ops.SCHEDULED_KERNELS["gru"]

    def off(*args, **kw):
        return scan(*args, **kw) + 1e-3

    monkeypatch.setitem(ops.SCHEDULED_KERNELS, "gru", (off, golden))
    with pytest.raises(AssertionError, match="diverged from golden model"):
        ttesting.assert_schedule_conformance("gru", KernelSchedule(),
                                             device="cpu", **SHAPES["gru"])


@pytest.mark.parametrize("fp", ["int8", "int4"])
def test_quantized_conformance(fp):
    tfp = ttesting.native_fp_configs()[fp]
    for kernel in sorted(SHAPES):
        for reuse in (1, 4):
            if kernel == "reuse_matmul" and SHAPES[kernel]["N"] % reuse:
                continue
            ttesting.assert_quantized_conformance(
                kernel, KernelSchedule(reuse_factor=reuse), tfp, seed=1,
                device="cpu", **SHAPES[kernel])


@pytest.mark.parametrize("fp", [None, FixedPointConfig(16, 6)],
                         ids=["float", "ap16_6"])
@pytest.mark.parametrize("arch", ["top-tagging-gru", "flavor-tagging-lstm"])
def test_serving_golden_and_conformance(arch, fp):
    cfg = get_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    x = np.random.RandomState(2).randn(5, 4, cfg.rnn.input_size).astype(
        np.float32)
    got = ttesting.serving_golden(cfg, params, x, fp=fp)
    jfp = None if fp is None else JFixedPoint(**dataclasses.asdict(fp))
    want = jtesting.serving_golden(
        jget_config(arch), {k: jnp.asarray(v.numpy())
                            for k, v in params.items()}, x, fp=jfp)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= ttesting.CONFORMANCE_TOL["float32"]
    eng = RNNServingEngine(cfg, params, device="cpu", max_batch=8)
    for s in (None, KernelSchedule(reuse_factor=4),
              KernelSchedule(mode="pipeline")):
        ttesting.assert_serving_conformance(eng, x, schedule=s, fp=fp)
