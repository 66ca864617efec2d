"""The port's non-static and pipeline schedules and its reuse-tiled matmuls
against the JAX package, on the CPU.

On a CPU tensor the kernel path runs each CUDA kernel's plain version (the
same R-tiled arithmetic); it is held to ``repro``'s Pallas kernels in
interpret mode (``backend="pallas_interpret"``, as ``repro``'s own tests run
them), to ``repro``'s references and to its engine.  Inputs come from
``repro.testing.make_kernel_inputs`` (numpy, seeded) and cross as numpy.

Tolerance: ``CONFORMANCE_TOL`` x max(1, |want|): 3e-5 for float32 (the
accumulation order of the products differs between XLA and PyTorch), 2e-2
for bfloat16 (values round at 2^-8).  Shapes stay small (T <= 8, H = 20)
so that JAX's interpret mode stays cheap.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import gru_scan as jgru  # noqa: E402
from repro.kernels import lstm_scan as jlstm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import reuse_matmul as jrm  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_kernel_inputs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import gru_scan as tgru  # noqa: E402
from repro_torch.kernels import lstm_scan as tlstm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import reuse_matmul as trm  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.kernels.schedule import schedule_key  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.serving import RNNServingEngine  # noqa: E402

CELLS = ("lstm", "gru")
DTYPES = ("float32", "bfloat16")


def to_torch(a) -> "torch.Tensor":
    """A JAX array as a CPU tensor of the same dtype (bf16 values are exact
    in f32, so they cross as f32)."""
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def assert_close(got, want, dtype: str = "float32") -> None:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    limit = CONFORMANCE_TOL[dtype] * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"max_err={err:.3e} > {limit:.3e}"


# -- the kernel modules against the Pallas kernels they replace ------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reuse", (1, 2, 4))
@pytest.mark.parametrize("kernel", ("col_matmul", "reuse_matmul"))
def test_matmul_kernel_matches_pallas(kernel, reuse, dtype):
    x, w = make_kernel_inputs("reuse_matmul", M=32, K=64, N=48, dtype=dtype,
                              seed=reuse)
    if kernel == "col_matmul":       # the weight operand is f32
        w = w.astype(jax.numpy.float32)
        pallas, wrapper = jrm.col_matmul_pallas, trm.col_matmul_kernel
    else:
        pallas, wrapper = jrm.reuse_matmul_pallas, trm.reuse_matmul_kernel
    before = dict(cuda.LAUNCHES)
    got = wrapper(to_torch(x), to_torch(w), reuse=reuse)
    assert got.dtype == to_torch(x).dtype
    assert_close(got, pallas(x, w, reuse=reuse, block_m=8, interpret=True),
                 dtype)
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"


@pytest.mark.parametrize("kernel", ("col_matmul", "reuse_matmul"))
def test_matmul_kernel_checks_before_launch(kernel):
    wrapper = getattr(trm, f"{kernel}_kernel")
    x, w = torch.zeros(8, 12), torch.zeros(12, 20)
    with pytest.raises(ValueError, match="reuse"):
        wrapper(x, w, reuse=7)
    with pytest.raises(ValueError, match="not a matrix product"):
        wrapper(x, w[:-1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wrapper(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("reuse", (1, 4))
@pytest.mark.parametrize("cell", CELLS)
def test_pipeline_kernel_matches_pallas(cell, reuse, out_dtype):
    xs, W, U, b = make_kernel_inputs(cell, B=8, T=7, F=6, H=20, seed=4)
    zx = (np.asarray(xs).reshape(-1, 6) @ np.asarray(W)).reshape(8, 7, -1)
    odt = getattr(jax.numpy, out_dtype)
    tdt = getattr(torch, out_dtype)
    before = dict(cuda.LAUNCHES)
    if cell == "lstm":
        zx = zx.astype(np.float32)
        want = jlstm.lstm_scan_pipeline_pallas(
            jax.numpy.asarray(zx), U, b, block_batch=8, reuse=reuse,
            interpret=True, out_dtype=odt)
        args = (torch.from_numpy(zx), to_torch(U), to_torch(b))
        wrapper = tlstm.lstm_scan_pipeline_kernel
    else:
        zx = (zx + np.asarray(b)[0]).astype(np.float32)
        want = jgru.gru_scan_pipeline_pallas(
            jax.numpy.asarray(zx), U, b[1], block_batch=8, reuse=reuse,
            interpret=True, out_dtype=odt)
        args = (torch.from_numpy(zx), to_torch(U),
                to_torch(b)[1].contiguous())
        wrapper = tgru.gru_scan_pipeline_kernel
    got = wrapper(*args, reuse=reuse, out_dtype=tdt)
    assert got.dtype == tdt
    assert_close(got, want, out_dtype)
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wrapper(*(a.to("meta") for a in args), reuse=reuse)


# -- the scheduled entry points -------------------------------------------

SCHEDULES = {
    "nonstatic-R2": dict(mode="nonstatic", reuse_factor=2),
    "nonstatic-R4-hoist": dict(mode="nonstatic", reuse_factor=4,
                               hoist_input=True),
    "nonstatic-hoist-hr2": dict(mode="nonstatic", hoist_input=True,
                                hoist_reuse=2),
    "pipeline-R1": dict(mode="pipeline"),
    "pipeline-R2": dict(mode="pipeline", reuse_factor=2),
    "pipeline-R4": dict(mode="pipeline", reuse_factor=4),
    "static-hoist-hr2": dict(hoist_input=True, hoist_reuse=2),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", tuple(SCHEDULES))
@pytest.mark.parametrize("cell", CELLS)
def test_scan_modes_match_pallas_interpret_and_ref(cell, name, dtype):
    inputs = make_kernel_inputs(cell, B=4, T=5, F=6, H=20, dtype=dtype)
    kw = dict(SCHEDULES[name], block_batch=8)
    got = tops.SCHEDULED_KERNELS[cell][0](*map(to_torch, inputs),
                                          schedule=KernelSchedule(**kw))
    assert got.dtype == to_torch(inputs[0]).dtype
    js = JSchedule(backend="pallas_interpret", **kw)
    assert_close(got, jops.SCHEDULED_KERNELS[cell][0](*inputs, schedule=js),
                 dtype)
    assert_close(got, jops.SCHEDULED_KERNELS[cell][1](*inputs), dtype)


@pytest.mark.parametrize("name", ("nonstatic-R4-hoist", "pipeline-R4"))
@pytest.mark.parametrize("cell", CELLS)
def test_scan_modes_ragged_batch(cell, name):
    """B=9: the pipeline pads to the batch granule and cuts back; the
    non-static blocks pad each product's rows, as in repro."""
    inputs = make_kernel_inputs(cell, B=9, T=5, F=6, H=20, seed=3)
    kw = dict(SCHEDULES[name], block_batch=8)
    got = tops.SCHEDULED_KERNELS[cell][0](*map(to_torch, inputs),
                                          schedule=KernelSchedule(**kw))
    assert got.shape == (9, 20)
    js = JSchedule(backend="pallas_interpret", **kw)
    assert_close(got, jops.SCHEDULED_KERNELS[cell][0](*inputs, schedule=js))
    assert_close(got, jops.SCHEDULED_KERNELS[cell][1](*inputs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reuse", (1, 4))
def test_reuse_matmul_entry_point(reuse, dtype):
    """``ops.reuse_matmul`` with a bare ``reuse``, a kernel schedule and an
    xla schedule, against repro's on M = 20 (padded to the row granule)."""
    x, w = make_kernel_inputs("reuse_matmul", M=20, K=64, N=48, dtype=dtype,
                              seed=5)
    tx, tw = to_torch(x), to_torch(w)
    fn, ref = tops.SCHEDULED_KERNELS["reuse_matmul"]
    want = jops.reuse_matmul(x, w, reuse=reuse)
    assert_close(fn(tx, tw, reuse=reuse), want, dtype)
    s = KernelSchedule(reuse_factor=reuse)
    got = fn(tx, tw, schedule=s)
    assert got.dtype == tx.dtype and got.shape == (20, 48)
    assert_close(got, jops.reuse_matmul(
        x, w, schedule=JSchedule(reuse_factor=reuse,
                                 backend="pallas_interpret")), dtype)
    assert_close(fn(tx, tw, schedule=s.replace(backend="xla")),
                 jops.SCHEDULED_KERNELS["reuse_matmul"][1](x, w), dtype)
    assert_close(ref(tx, tw), want, dtype)
    # the native int8 route (quant_matmul) equals repro's bit for bit: an
    # exact integer product, requantized once
    from repro.config import FixedPointConfig as JFixedPoint
    from repro_torch.config import FixedPointConfig

    got = fn(tx, tw, schedule=s, fp=FixedPointConfig(8, 3))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jops.reuse_matmul(
            x, w, schedule=JSchedule(reuse_factor=reuse,
                                     backend="pallas_interpret"),
            fp=JFixedPoint(8, 3)), np.float32))


# -- the engine ------------------------------------------------------------


@pytest.fixture(scope="module", params=("top-tagging-lstm",
                                        "top-tagging-gru"))
def tagger(request):
    name = request.param
    jcfg = jget_config(name)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(2)).items()}
    x = np.random.RandomState(11).randn(5, 20, 6).astype(np.float32)
    return name, jcfg, jparams, x


@pytest.mark.parametrize("sched", (
    KernelSchedule(mode="nonstatic", block_batch=8),
    KernelSchedule(mode="nonstatic", hoist_input=True, block_batch=8),
    KernelSchedule(mode="pipeline", reuse_factor=4, block_batch=8)),
    ids=lambda s: s.key())
def test_engine_modes_match_repro_engine(tagger, sched):
    """predict and submit/flush on the port's kernel path against repro's
    engine."""
    name, jcfg, jparams, x = tagger
    eng = RNNServingEngine(get_config(name), params_from_jax(jparams, "cpu"),
                           device="cpu", max_batch=8, schedule=sched)
    ref = JEngine(jcfg, jparams, impl="xla", max_batch=8)
    want = np.asarray(ref.predict(x))
    assert_close(eng.predict(x), want)
    reqs = eng.serve(list(x))
    assert all(q.status == "answered" for q in reqs)
    assert_close(np.stack([q.result for q in reqs]), want)
    assert eng.trace_count(schedule_key(sched)) == 1
