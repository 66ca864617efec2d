"""One event's answer does not depend on the batch it rides in, on the CPU.

``repro`` holds ``predict_one(x) == predict(x[None])[0]`` and the flushed
result bit for bit (``tests/test_decode_schedule.py``); the router, the
streaming pipeline and the compile cache all rest on it.  Here the port is
held to ``predict_one(X[i]) == predict(X[i:i+1])[0] == predict(X)[i] ==
submit x B + flush`` bit for bit, for the six taggers at their published
widths and a cut sequence (``T_CUT`` steps), in every float mode
(static, static + hoist, pipeline, non-static) at R in {1, 4}, and for
the three fixed-point configs of the paper's grid (``ap_fixed<16,6>``
emulated, ``<8,3>`` and ``<4,2>`` native) at static R in {1, 4}.  On CPU
tensors the kernel path runs the kernels' plain versions, whose products
(``kernels/ref.py::matmul``) sum each output in k order and whose
sigmoid (``ref.sigmoid``) has the same bits at every position; MKL's
``matmul`` and ``torch.sigmoid`` do not, which is what this file catches.
The served answers are also held to ``repro``'s engine within
``CONFORMANCE_TOL``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import build_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import RNNServingEngine as JEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL  # noqa: E402

from repro_torch.config import FixedPointConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models.rnn_tagger import params_from_jax  # noqa: E402
from repro_torch.serving import RNNServingEngine  # noqa: E402

TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
T_CUT = 4                     # timesteps: the depth the CPU runs
BATCH = 16                    # predict(X) rows and the flush's max_batch
ROWS = (0, 5, BATCH - 1)      # the rows followed through every shape
MODES = {"static": {}, "static_hoist": {"hoist_input": True},
         "pipeline": {"mode": "pipeline"}, "nonstatic": {"mode": "nonstatic"}}
FPS = {"ap16_6": FixedPointConfig(16, 6), "ap8_3": FixedPointConfig(8, 3),
       "ap4_2": FixedPointConfig(4, 2)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module", params=TAGGERS)
def served(request):
    """(name, port engine, repro engine, payloads) at T_CUT steps."""
    name = request.param
    jcfg = jget_config(name)
    jcfg = dataclasses.replace(jcfg, rnn=dataclasses.replace(
        jcfg.rnn, seq_len=T_CUT))
    jparams = {k: np.asarray(v) for k, v in
               build_model(jcfg).init(jax.random.PRNGKey(0)).items()}
    tcfg = get_config(name)
    tcfg = dataclasses.replace(tcfg, rnn=dataclasses.replace(
        tcfg.rnn, seq_len=T_CUT))
    eng = RNNServingEngine(tcfg, params_from_jax(jparams, "cpu"),
                           device="cpu", max_batch=BATCH)
    x = np.random.RandomState(11).randn(
        BATCH, T_CUT, tcfg.rnn.input_size).astype(np.float32)
    return name, eng, JEngine(jcfg, jparams, impl="xla"), x


def _every_shape(eng, x, sched, fp):
    """predict(X) and the flushed results, and for each of ROWS its
    predict_one and predict(x[None])[0]."""
    full = eng.predict(x, schedule=sched, fp=fp)
    reqs = [eng.submit(x[i], schedule=sched, fp=fp) for i in range(len(x))]
    eng.flush(force=True)
    assert all(q.status == "answered" for q in reqs)
    flushed = np.stack([q.result for q in reqs])
    np.testing.assert_array_equal(_bits(flushed), _bits(full))
    for i in ROWS:
        one = eng.predict_one(x[i], schedule=sched, fp=fp)
        p1 = eng.predict(x[i:i + 1], schedule=sched, fp=fp)[0]
        np.testing.assert_array_equal(_bits(one), _bits(full[i]))
        np.testing.assert_array_equal(_bits(p1), _bits(full[i]))
    return full


@pytest.mark.parametrize("reuse", (1, 4))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_float_answer_same_bits_in_every_batch(served, mode, reuse):
    _, eng, jeng, x = served
    sched = KernelSchedule(reuse_factor=reuse, **MODES[mode])
    full = _every_shape(eng, x, sched, None)
    want = jeng.predict(x)
    tol = CONFORMANCE_TOL["float32"] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(full - want).max()) <= tol


@pytest.mark.parametrize("reuse", (1, 4))
@pytest.mark.parametrize("fp", sorted(FPS))
def test_fixed_point_answer_same_bits_in_every_batch(served, fp, reuse):
    _, eng, _, x = served
    _every_shape(eng, x, KernelSchedule(reuse_factor=reuse), FPS[fp])


@pytest.mark.parametrize("K", (3, 6, 20, 120, 128, 512))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_ref_matmul_rows_same_bits_at_every_M(K, dtype):
    """A row of ``ref.matmul`` has the same bits at M in {1, 8, 9, 256},
    and the product keeps ``repro``'s tolerance against float64."""
    g = torch.Generator().manual_seed(K)
    a = torch.randn(256, K, generator=g).to(dtype)
    w = (torch.randn(K, 96, generator=g) / K ** 0.5).to(dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    full = ref.matmul(a, w)
    for M in (1, 8, 9):
        got = ref.matmul(a[:M].clone(), w)
        assert torch.equal(got.view(bits), full[:M].view(bits))
    want = a.double() @ w.double()
    tol = CONFORMANCE_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    err = float((full.double() - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max()))


def test_ref_sigmoid_same_bits_at_every_position():
    """``ref.sigmoid`` of a row is the same bits alone and inside a larger
    tensor (``torch.sigmoid``'s vector and scalar formulas differ), and
    equals ``torch.sigmoid`` within one f32 ulp scale."""
    g = torch.Generator().manual_seed(5)
    for n in (3, 20, 50, 120, 128):
        x = torch.randn(300, n, generator=g) * 4
        full = ref.sigmoid(x)
        for M in (1, 7, 9, 33):
            assert torch.equal(ref.sigmoid(x[:M].clone()), full[:M])
        assert float((full - torch.sigmoid(x)).abs().max()) <= 1.2e-7
