"""The port's fixed-point datapaths against the JAX package's, on the CPU.

Covers the quantizer and its kernel (``fixed_point``), the integer packers
and the integer product (``quant_matmul``), the native int8/int4 scans, the
ap_fixed emulation through the layer and the tagger, the quantized
``ops.reuse_matmul``, PTQ and the engine with ``fp=``.  On a CPU tensor the
kernel path runs each CUDA kernel's plain version.  Inputs come from numpy
seeds (``repro.testing.make_quantized_inputs``: weights PTQ'd onto the
grid) and cross as numpy.

Tolerances:
  * bitwise for the quantizer, the packers and the integer product, against
    ``repro`` (Pallas in interpret mode where it has a kernel);
  * bitwise for native against emulation inside the port (the rescaled
    int32 accumulator equals the f32 product of on-grid operands exactly);
  * bitwise against ``repro`` for the scans, the layer and the quantized
    matmul: every value they return lies on the grid, and on these seeds
    PyTorch's sigmoid / tanh never move an activation across a rounding
    tie of XLA's;
  * ``OUT_ATOL`` (1e-6) for tagger and engine outputs against ``repro``:
    the output sigmoid / softmax, which hls4ml does not quantize, may
    differ from XLA's by an f32 ulp.  The one nonzero difference on these
    seeds is 6.0e-8, one ulp of the ap_fixed<16,6> top-tagging LSTM
    tagger's output sigmoid.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import FixedPointConfig as JFP  # noqa: E402
from repro.core.quant import fixed_point as jfx  # noqa: E402
from repro.core.quant import ptq as jptq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quantized as jq  # noqa: E402
from repro.kernels.fixed_point import fixed_point_pallas  # noqa: E402
from repro.kernels.schedule import schedule_key as jkey  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import rnn_tagger as jtagger  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import (make_quantized_inputs,  # noqa: E402
                           quantized_golden_gru, quantized_golden_lstm,
                           quantized_golden_reuse_matmul)

from repro_torch.config import FixedPointConfig as TFP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.quant import fixed_point as tfx  # noqa: E402
from repro_torch.core.quant import ptq as tptq  # noqa: E402
from repro_torch.core.rnn.layer import rnn_layer  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.kernels.fixed_point import (edge_values,  # noqa: E402
                                             fixed_point_kernel,
                                             fixed_point_plain)
from repro_torch.kernels.schedule import KernelSchedule, schedule_key  # noqa: E402,E501
from repro_torch.models.rnn_tagger import RNNTagger, params_from_jax  # noqa: E402,E501
from repro_torch.serving import RNNServingEngine  # noqa: E402

#: the seven-config grid of tests/test_quantization.py (paper, native,
#: trn / wrap corners)
GRID = ((16, 6, "rnd", "sat"), (8, 3, "rnd", "sat"), (4, 2, "rnd", "sat"),
        (12, 4, "rnd", "sat"), (16, 6, "trn", "sat"), (8, 4, "rnd", "wrap"),
        (10, 3, "trn", "wrap"))
#: native configs: int8 storage (8,3), (6,2) and nibble-packed (4,2), (3,1)
NATIVE = ((8, 3), (6, 2), (4, 2), (3, 1))
INT8, INT4 = (8, 3), (4, 2)


def fps(w, i, rounding="rnd", saturation="sat"):
    """The same config in both packages."""
    return (JFP(w, i, rounding=rounding, saturation=saturation),
            TFP(w, i, rounding=rounding, saturation=saturation))


def gid(c):
    return "ap" + "_".join(str(v) for v in c)


def bits(a) -> np.ndarray:
    """Raw bits of a float32 / bfloat16 array (torch or JAX)."""
    if isinstance(a, torch.Tensor):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return a.contiguous().view(view).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def to_torch(a) -> "torch.Tensor":
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def sample(shape, dtype, seed=0, spread=12.0):
    """Seeded values spread over several grids' rails, with exact ties
    (multiples of 1/64) and both signs of zero."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * spread).astype(np.float32)
    x.flat[::7] = np.round(x.flat[::7] * 64) / 64
    x.flat[0], x.flat[1] = 0.0, -0.0
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, to_torch(j)


#: tagger / engine outputs against repro: an f32 ulp of the unquantized
#: output activation (module docstring)
OUT_ATOL = 1e-6


def matches_repro(got, want, atol=0.0):
    """max |got - want| <= atol; atol 0 asks for equal values."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= atol, f"max_err={err:.3e} > {atol:.1e}"
    return err


# -- 1. the fixed-point module, bitwise against repro ----------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("cfg", GRID, ids=gid)
def test_quantizer_bitwise(cfg, dtype):
    jfp, tfp = fps(*cfg)
    xj, xt = sample((64, 48), dtype, seed=cfg[0])
    got = tfx.quantize(xt, tfp)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(bits(got), bits(jfx.quantize(xj, jfp)))
    xn = np.asarray(xj, np.float32)
    np.testing.assert_array_equal(bits(tfx.quantize_np(xn, tfp)),
                                  bits(jfx.quantize_np(xn, jfp)))
    assert tfx.grid_constants(tfp) == jfx.grid_constants(jfp)
    assert tfx.is_native_int(tfp) == jfx.is_native_int(jfp)
    for k, n in ((7, 12), (8, 12)):
        assert (tfx.packed_weight_bytes(k, n, tfp)
                == jfx.packed_weight_bytes(k, n, jfp))
    assert tfx.fixed_point_error_bound(tfp) == jfx.fixed_point_error_bound(jfp)
    # a diagnostic mean: f32 summation order differs (1e-6)
    assert abs(float(tfx.saturates(xt, tfp))
               - float(jfx.saturates(xj, jfp))) <= 1e-6
    if tfx.is_native_int(tfp):
        ints = tfx.to_ints(xt, tfp)
        assert ints.dtype == torch.int8
        np.testing.assert_array_equal(ints.numpy(),
                                      np.asarray(jfx.to_ints(xj, jfp)))
        np.testing.assert_array_equal(
            bits(tfx.from_ints(ints, tfp)),
            bits(jfx.from_ints(jnp.asarray(ints.numpy()), jfp)))


@pytest.mark.parametrize("k", (5, 8), ids=("odd_K", "even_K"))
@pytest.mark.parametrize("cfg", NATIVE, ids=gid)
def test_pack_unpack_bitwise(cfg, k):
    jfp, tfp = fps(*cfg)
    wj, wt = sample((k, 12), "float32", seed=k, spread=2.0)
    packed = tq.pack_ints(wt, tfp)
    jpacked = jq.pack_ints(wj, jfp)
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert tq.packed_nbytes(packed) == jq.packed_nbytes(jpacked) \
        == tfx.packed_weight_bytes(k, 12, tfp)
    un = tq.unpack_ints(packed, tfp, k)
    np.testing.assert_array_equal(un.numpy(),
                                  np.asarray(jq.unpack_ints(jpacked, jfp, k)))
    np.testing.assert_array_equal(un.numpy(), tfx.to_ints(wt, tfp).numpy())


# -- 2. the fixed_point kernel's plain version and ops.fixed_point ---------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("cfg", GRID, ids=gid)
def test_fixed_point_matches_pallas(cfg, dtype):
    jfp, tfp = fps(*cfg)
    xj, xt = sample((32, 40), dtype, seed=3 + cfg[1])
    want = fixed_point_pallas(xj, jfp, block=16, interpret=True)
    before = dict(cuda.LAUNCHES)
    np.testing.assert_array_equal(bits(fixed_point_plain(xt, tfp)),
                                  bits(want))
    np.testing.assert_array_equal(bits(fixed_point_kernel(xt, tfp)),
                                  bits(want))
    x3j, x3t = sample((4, 6, 40), dtype, seed=5)
    np.testing.assert_array_equal(bits(ops.fixed_point(x3t, tfp)),
                                  bits(jops.fixed_point(x3j, jfp)))
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fixed_point_kernel(xt.to("meta"), tfp)


def bits_nan(a) -> np.ndarray:
    """Raw bits with every NaN as one pattern: NaN positions count, NaN
    payloads and signs do not."""
    f = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)
    b = bits(a).copy()
    b[np.isnan(f)] = -1
    return b


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("cfg", GRID, ids=gid)
def test_fixed_point_plain_at_edge_values(cfg, dtype):
    """The plain version (the port's ``quantize``, which the kernel is held
    to on the card) at ``edge_values`` against ``repro``'s Pallas kernel
    in interpret mode and its ``quantize``: bit for bit, NaN positions
    equal.  XLA on the CPU flushes f32 subnormal inputs to zero; the port
    does not (nor does IEEE arithmetic).  At a subnormal input the port is
    held to ``repro``'s float64 host quantizer ``quantize_np``, and
    ``repro``'s device result to the port's or to that of the zero the
    flush leaves (they differ where trn floors a negative subnormal to
    -2^-F)."""
    jfp, tfp = fps(*cfg)
    xt = edge_values(tfp).to(getattr(torch, dtype)).reshape(1, -1).repeat(8, 1)
    xf = xt.float().numpy()
    xj = jnp.asarray(xf, dtype)
    got = fixed_point_plain(xt, tfp)
    assert got.dtype == xt.dtype
    sub = (xf != 0) & (np.abs(xf) < np.finfo(np.float32).tiny)
    assert sub.any() and np.isnan(xf).any() and np.isinf(xf).any()
    host = to_torch(jnp.asarray(jfx.quantize_np(xf, jfp), dtype))
    flushed = jfx.quantize(jnp.asarray(np.copysign(0.0, xf), dtype), jfp)
    for want in (fixed_point_pallas(xj, jfp, block=8, interpret=True),
                 jfx.quantize(xj, jfp)):
        np.testing.assert_array_equal(bits_nan(got)[~sub],
                                      bits_nan(want)[~sub])
        np.testing.assert_array_equal(bits(got)[sub], bits(host)[sub])
        w = bits(want)[sub]
        assert np.all((w == bits(got)[sub]) | (w == bits(flushed)[sub]))


# -- 3. the integer product ------------------------------------------------


@pytest.mark.parametrize("cfg", (INT8, INT4), ids=gid)
@pytest.mark.parametrize("reuse", (1, 2, 4))
def test_quant_matmul_plain_exact(reuse, cfg):
    """Exactly the int32 of repro's kernel in interpret mode; the int4
    weight has an odd K and goes through pack / unpack first."""
    jfp, tfp = fps(*cfg)
    rng = np.random.RandomState(reuse)
    K = 7 if cfg == INT4 else 24
    lo, hi = (-8, 8) if cfg == INT4 else (-128, 128)
    x = rng.randint(lo, hi, (16, K)).astype(np.int8)
    w = (rng.randint(lo, hi, (K, 16)) / tfp.scale).astype(np.float32)
    wq = tq.unpack_ints(tq.pack_ints(torch.from_numpy(w), tfp), tfp, K)
    want = np.asarray(jq.quant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wq.numpy()), reuse=reuse, block_m=8,
        interpret=True))
    before = dict(cuda.LAUNCHES)
    got = tq.quant_matmul_kernel(torch.from_numpy(x), wq, reuse=reuse)
    assert got.dtype == torch.int32 and cuda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tq.quant_matmul_plain(torch.from_numpy(x), wq, reuse=reuse).numpy(),
        want)


def test_quant_matmul_checks_before_launch():
    x, w = torch.zeros(8, 12, dtype=torch.int8), torch.zeros(12, 20,
                                                             dtype=torch.int8)
    with pytest.raises(ValueError, match="reuse"):
        tq.quant_matmul_kernel(x, w, reuse=3)
    with pytest.raises(ValueError, match="not a matrix product"):
        tq.quant_matmul_kernel(x, w[:-1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tq.quant_matmul_kernel(x.to("meta"), w.to("meta"))
    # the kernel stages only its tiles: a 512 x 1024 int8 weight (past a
    # block's 227 KiB of shared memory) is accepted
    big = torch.ones(512, 1024, dtype=torch.int8)
    out = tq.quant_matmul_kernel(torch.ones(2, 512, dtype=torch.int8), big,
                                 reuse=4)
    assert out.dtype == torch.int32 and bool((out == 512).all())


# -- 4. native scans -------------------------------------------------------


def scan_inputs(cell, jfp, seed=0):
    inputs = make_quantized_inputs(cell, jfp, B=9, T=8, F=6, H=20, seed=seed)
    return inputs, [torch.from_numpy(np.array(a)) for a in inputs]


@pytest.mark.parametrize("cfg", (INT8, INT4), ids=("int8", "int4"))
@pytest.mark.parametrize("reuse", (1, 2))
@pytest.mark.parametrize("mode", ("static", "nonstatic"))
@pytest.mark.parametrize("cell", ("lstm", "gru"))
def test_native_scan(cell, mode, reuse, cfg):
    jfp, tfp = fps(*cfg)
    jin, tin = scan_inputs(cell, jfp, seed=reuse)
    scan = ops.lstm_scan if cell == "lstm" else ops.gru_scan
    sched = KernelSchedule(reuse_factor=reuse, mode=mode)
    got = scan(*tin, schedule=sched, fp=tfp)
    # bitwise: the port's own emulation on the same (CPU) device
    emu = scan(*tin, schedule=sched.replace(backend="xla"), fp=tfp)
    np.testing.assert_array_equal(bits(got), bits(emu))
    # one grid step: repro's emulation (bitwise equal to its native route
    # in its own tests) and the numpy integer golden model
    want = jops._emulated_scan_jit(*jin, cell=cell, fp=jfp)
    matches_repro(got, want)
    golden = quantized_golden_lstm if cell == "lstm" else quantized_golden_gru
    matches_repro(got, golden(*jin, jfp))


@pytest.mark.parametrize("cell", ("lstm", "gru"))
def test_native_scan_never_hoists(cell):
    """A hoisted or pipeline schedule runs the same per-step structure."""
    jfp, tfp = fps(*INT8)
    _, tin = scan_inputs(cell, jfp, seed=5)
    scan = ops.lstm_scan if cell == "lstm" else ops.gru_scan
    want = scan(*tin, schedule=KernelSchedule(), fp=tfp)
    for sched in (KernelSchedule(hoist_input=True),
                  KernelSchedule(mode="pipeline", reuse_factor=2)):
        np.testing.assert_array_equal(bits(scan(*tin, schedule=sched,
                                                fp=tfp)), bits(want))
    assert "-hoist" in schedule_key(KernelSchedule(hoist_input=True), tfp)


# -- 5. emulated configs through the layer and the tagger ------------------

EMULATED = ((16, 6, "rnd", "sat"), (16, 6, "trn", "sat"),
            (8, 4, "rnd", "wrap"), (10, 3, "trn", "wrap"))


@pytest.fixture(scope="module", params=("top-tagging-lstm",
                                        "top-tagging-gru"))
def tagger(request):
    name = request.param
    jcfg = jget_config(name)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(2)).items()}
    x = np.random.RandomState(11).randn(5, 20, 6).astype(np.float32)
    return name, jcfg, jparams, x


@pytest.mark.parametrize("cfg", EMULATED, ids=gid)
def test_emulated_fp_layer_and_tagger(tagger, cfg):
    name, jcfg, jparams, x = tagger
    jfp, tfp = fps(*cfg)
    qj = jptq.ptq_quantize_model(jparams, jfp)
    qt = params_from_jax({k: np.asarray(v) for k, v in qj.items()}, "cpu")
    rnn = get_config(name).rnn
    h = rnn_layer(rnn, torch.from_numpy(x), qt["rnn/kernel"],
                  qt["rnn/recurrent"], qt["rnn/bias"], fp=tfp,
                  impl="pallas")
    from repro.core.rnn.layer import rnn_layer as jlayer

    matches_repro(h, jlayer(jcfg.rnn, jnp.asarray(x), qj["rnn/kernel"],
                            qj["rnn/recurrent"], qj["rnn/bias"], fp=jfp,
                            impl="xla"))
    model = RNNTagger(get_config(name), qt, device="cpu")
    want = jtagger.forward(jcfg, qj, jnp.asarray(x), fp=jfp, impl="xla")
    before = dict(cuda.LAUNCHES)
    for impl in ("pallas", "xla"):
        matches_repro(model(torch.from_numpy(x), fp=tfp, impl=impl), want,
                      OUT_ATOL)
    assert cuda.LAUNCHES == before


@pytest.mark.parametrize("cfg", (INT8, INT4), ids=("int8", "int4"))
def test_native_fp_through_the_tagger(tagger, cfg):
    name, jcfg, jparams, x = tagger
    jfp, tfp = fps(*cfg)
    qj = jptq.ptq_quantize_model(jparams, jfp)
    model = RNNTagger(get_config(name), params_from_jax(
        {k: np.asarray(v) for k, v in qj.items()}, "cpu"), device="cpu")
    xt = torch.from_numpy(x)
    got = model(xt, fp=tfp, impl="pallas")
    np.testing.assert_array_equal(bits(got),
                                  bits(model(xt, fp=tfp, impl="xla")))
    matches_repro(got, jtagger.forward(jcfg, qj, jnp.asarray(x), fp=jfp,
                                       impl="xla"), OUT_ATOL)
    lengths = torch.tensor([20, 3, 11, 20, 1])
    for impl in ("pallas", "xla"):
        matches_repro(model(xt, fp=tfp, impl=impl, lengths=lengths),
                      jtagger.forward(jcfg, qj, jnp.asarray(x), fp=jfp,
                                      impl="xla",
                                      lengths=jnp.asarray(lengths.numpy())),
                      OUT_ATOL)


# -- 6. the quantized scheduled matmul -------------------------------------


@pytest.mark.parametrize("cfg", (INT8, INT4), ids=("int8", "int4"))
@pytest.mark.parametrize("reuse", (1, 2, 4))
def test_reuse_matmul_native_bitwise(reuse, cfg):
    jfp, tfp = fps(*cfg)
    rng = np.random.RandomState(reuse)
    x = (rng.randn(12, 20) * 2).astype(np.float32)
    w = (rng.randn(20, 16) * 0.5).astype(np.float32)
    got = ops.reuse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           schedule=KernelSchedule(reuse_factor=reuse),
                           fp=tfp)
    np.testing.assert_array_equal(
        bits(got), bits(quantized_golden_reuse_matmul(x, w, jfp)))


def test_reuse_matmul_emulated_fp():
    jfp, tfp = fps(16, 6)
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32).astype(np.float32)
    w = (rng.randn(32, 24) * 0.3).astype(np.float32)
    from repro.kernels.schedule import KernelSchedule as JSchedule

    for sched, jsched in ((KernelSchedule(reuse_factor=2),
                           JSchedule(reuse_factor=2, block_batch=8,
                                     backend="pallas_interpret")),
                          (KernelSchedule(backend="xla"),
                           JSchedule(backend="xla"))):
        got = ops.reuse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               schedule=sched, fp=tfp)
        matches_repro(got, jops.reuse_matmul(jnp.asarray(x), jnp.asarray(w),
                                             schedule=jsched, fp=jfp))


# -- 7. PTQ ----------------------------------------------------------------


@pytest.mark.parametrize("cfg", GRID[:3], ids=gid)
def test_ptq_quantize_model_matches_repro(cfg):
    jfp, tfp = fps(*cfg)
    jparams = {k: np.asarray(v) for k, v in build_model(
        jget_config("flavor-tagging-gru")).init(jax.random.PRNGKey(0)).items()}
    want = jptq.ptq_quantize_model(jparams, jfp)
    got = tptq.ptq_quantize_model(params_from_jax(jparams, "cpu"), tfp)
    from_np = tptq.ptq_quantize_model(jparams, tfp)
    for k in jparams:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
        np.testing.assert_array_equal(bits(from_np[k]), bits(want[k]))


def test_auc_matches_repro():
    rng = np.random.RandomState(0)
    scores = np.round(rng.rand(200), 2)             # many ties
    labels = (rng.rand(200) < 0.4).astype(np.int32)
    assert tptq.binary_auc(scores, labels) == jptq.binary_auc(scores, labels)
    probs = rng.dirichlet(np.ones(3), size=120)
    y = rng.randint(0, 3, 120)
    assert (tptq.multiclass_mean_auc(probs, y)
            == jptq.multiclass_mean_auc(probs, y))
    assert np.isnan(tptq.binary_auc(scores, np.zeros(200)))


def test_auc_scan_on_the_port_tagger():
    """Paper Fig. 2 protocol on the port's tagger: AUC ratios per integer
    bits, equal to repro's."""
    name = "top-tagging-gru"
    jcfg = jget_config(name)
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(4)
    x = rng.randn(40, 20, 6).astype(np.float32)
    y = (rng.rand(40) < 0.5).astype(np.int32)
    kw = dict(integer_bits=(6,), fractional_bits=(4, 10))
    got = tptq.auc_scan(get_config(name), tptq.tagger_forward,
                        params_from_jax(jparams, "cpu"), x, y, **kw)
    want = jptq.auc_scan(jcfg, jtagger.forward, jparams, x, y, **kw)
    assert list(got) == list(want)
    for (fb, r), (jfb, jr) in zip(got[6], want[6]):
        assert fb == jfb and r == jr


# -- 8. the engine ---------------------------------------------------------


@pytest.mark.parametrize("cfg", (INT8, INT4, (16, 6)),
                         ids=("int8", "int4", "ap16_6"))
def test_engine_serves_fp(tagger, cfg):
    name, jcfg, jparams, x = tagger
    jfp, tfp = fps(*cfg)
    qj = jptq.ptq_quantize_model(jparams, jfp)
    qt = params_from_jax({k: np.asarray(v) for k, v in qj.items()}, "cpu")
    eng = RNNServingEngine(get_config(name), qt, device="cpu", fp=tfp,
                           max_batch=8, ragged="mask")
    ref = JEngine(jcfg, qj, impl="xla", fp=jfp, max_batch=8)
    want = np.asarray(ref.predict(x))
    matches_repro(eng.predict(x), want, OUT_ATOL)
    matches_repro(eng.predict(x, schedule=KernelSchedule(reuse_factor=4)),
                  want, OUT_ATOL)
    matches_repro(np.stack([eng.predict_one(x[i]) for i in range(3)]),
                  want[:3], OUT_ATOL)
    reqs = eng.serve(list(x))
    assert all(r.status == "answered" for r in reqs)
    matches_repro(np.stack([r.result for r in reqs]), want, OUT_ATOL)
    ragged = [x[0][:7], x[1], x[2][:13]]
    matches_repro(np.stack(eng.predict_ragged(ragged)),
                  np.stack(ref.predict_ragged(ragged)), OUT_ATOL)
    # one executor per (schedule, fp) key, and the keys are repro's
    sched = eng.resolved_schedule
    key = schedule_key(sched, tfp)
    from repro.kernels.schedule import KernelSchedule as JSchedule

    assert key == jkey(JSchedule(**sched.__dict__), jfp)
    assert key in eng._infer_cache and eng.trace_count(key) == 1
    assert eng.one_trace_count(key) == 1
    assert eng.serve_report()[key]["fp"] == tfp
    # on a float engine, a request's fp gets its own key
    flt = RNNServingEngine(get_config(name), qt, device="cpu", max_batch=8)
    flt.predict(x)
    matches_repro(flt.predict(x, fp=tfp), want, OUT_ATOL)
    assert sorted(flt._infer_cache) == sorted({schedule_key(sched),
                                                key})
    assert all(flt.trace_count(k) == 1 for k in flt._infer_cache)
