"""The port's scan kernels against the JAX package, on the CPU.

On a CPU tensor the port's kernel path runs each CUDA kernel's plain version
(the same R-tiled arithmetic); it is held to ``repro``'s Pallas kernels in
interpret mode (``backend="pallas_interpret"``, as ``repro``'s own tests
run them) and to ``repro``'s ``lax.scan`` references.  Inputs come from
``repro.testing.make_kernel_inputs`` (numpy, seeded) and cross as numpy.

Tolerance: ``CONFORMANCE_TOL`` x max(1, |want|): 3e-5 for float32 (the
accumulation order of the gate products differs between XLA and PyTorch),
2e-2 for bfloat16 (inputs round at 2^-8).  The JAX package's own
hoisted == in-loop LSTM bit-match does not hold on its CPU backend, so the
port claims no bitwise equality between its hoisted and in-loop paths.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import gru_scan as jgru  # noqa: E402
from repro.kernels import lstm_scan as jlstm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_kernel_inputs  # noqa: E402

from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import gru_scan as tgru  # noqa: E402
from repro_torch.kernels import lstm_scan as tlstm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402

CELLS = ("lstm", "gru")
DTYPES = ("float32", "bfloat16")


def to_torch(a) -> "torch.Tensor":
    """A JAX array as a CPU tensor of the same dtype (bf16 values are exact
    in f32, so they cross as f32)."""
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def assert_close(got, want, dtype: str) -> float:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    limit = CONFORMANCE_TOL[dtype] * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"max_err={err:.3e} > {limit:.3e}"
    return err


def schedules(reuse: int, hoist: bool, bb: int = 8):
    kw = dict(reuse_factor=reuse, block_batch=bb, hoist_input=hoist)
    return JSchedule(backend="pallas_interpret", **kw), KernelSchedule(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hoist", (False, True), ids=("inloop", "hoist"))
@pytest.mark.parametrize("reuse", (1, 2, 4))
@pytest.mark.parametrize("cell", CELLS)
def test_scan_matches_pallas_interpret_and_ref(cell, reuse, hoist, dtype):
    inputs = make_kernel_inputs(cell, B=4, T=12, F=6, H=20, dtype=dtype)
    js, ts = schedules(reuse, hoist)
    got = tops.SCHEDULED_KERNELS[cell][0](*map(to_torch, inputs), schedule=ts)
    assert got.dtype == to_torch(inputs[0]).dtype
    assert_close(got, jops.SCHEDULED_KERNELS[cell][0](*inputs, schedule=js),
                 dtype)
    assert_close(got, jops.SCHEDULED_KERNELS[cell][1](*inputs), dtype)


@pytest.mark.parametrize("hoist", (False, True), ids=("inloop", "hoist"))
@pytest.mark.parametrize("cell", CELLS)
def test_scan_ragged_batch(cell, hoist):
    """B=9 is padded to the batch granule and cut back, as in repro."""
    inputs = make_kernel_inputs(cell, B=9, T=8, F=6, H=20, seed=3)
    js, ts = schedules(4, hoist)
    got = tops.SCHEDULED_KERNELS[cell][0](*map(to_torch, inputs), schedule=ts)
    assert got.shape == (9, 20)
    assert_close(got, jops.SCHEDULED_KERNELS[cell][0](*inputs, schedule=js),
                 "float32")
    assert_close(got, jops.SCHEDULED_KERNELS[cell][1](*inputs), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", CELLS)
def test_xla_backend_is_the_reference(cell, dtype):
    """backend="xla" runs the port's golden model, held to repro's."""
    inputs = make_kernel_inputs(cell, B=5, T=10, F=6, H=20, dtype=dtype,
                                seed=1)
    got = tops.SCHEDULED_KERNELS[cell][0](
        *map(to_torch, inputs), schedule=KernelSchedule(backend="xla"))
    want_fn = jref.lstm_scan_ref if cell == "lstm" else jref.gru_scan_ref
    torch_ref = tref.lstm_scan_ref if cell == "lstm" else tref.gru_scan_ref
    assert_close(got, want_fn(*inputs), dtype)
    assert_close(torch_ref(*map(to_torch, inputs)), want_fn(*inputs), dtype)


@pytest.mark.parametrize("reuse", (1, 4))
@pytest.mark.parametrize("hoist", (False, True), ids=("inloop", "hoist"))
@pytest.mark.parametrize("cell", CELLS)
def test_kernel_module_matches_pallas_kernel(cell, hoist, reuse):
    """Each kernel module's wrapper on a CPU tensor (its plain version)
    against the Pallas kernel it replaces, called directly."""
    xs, W, U, b = make_kernel_inputs(cell, B=8, T=9, F=6, H=20, seed=2)
    txs, tW, tU, tb = map(to_torch, (xs, W, U, b))
    before = dict(cuda.LAUNCHES)
    if not hoist:
        pallas = jlstm.lstm_scan_pallas if cell == "lstm" \
            else jgru.gru_scan_pallas
        wrapper = tlstm.lstm_scan_kernel if cell == "lstm" \
            else tgru.gru_scan_kernel
        want = pallas(xs, W, U, b, block_batch=8, reuse=reuse,
                      interpret=True)
        got = wrapper(txs, tW, tU, tb, reuse=reuse)
    else:
        zx = np.asarray(xs).reshape(-1, 6) @ np.asarray(W)
        zx = zx.reshape(8, 9, -1).astype(np.float32)
        if cell == "lstm":
            want = jlstm.lstm_scan_hoisted_pallas(
                jax.numpy.asarray(zx), U, b, block_batch=8, reuse=reuse,
                interpret=True)
            got = tlstm.lstm_scan_hoisted_kernel(torch.from_numpy(zx), tU,
                                                 tb, reuse=reuse)
        else:
            zx = zx + np.asarray(b)[0]
            want = jgru.gru_scan_hoisted_pallas(
                jax.numpy.asarray(zx), U, b[1], block_batch=8, reuse=reuse,
                interpret=True)
            got = tgru.gru_scan_hoisted_kernel(torch.from_numpy(zx), tU,
                                               tb[1].contiguous(),
                                               reuse=reuse)
    assert_close(got, want, "float32")
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"


@pytest.mark.parametrize("cell", CELLS)
def test_kernel_wrapper_checks_shapes(cell):
    xs, W, U, b = map(to_torch, make_kernel_inputs(cell, B=2, T=3, H=8))
    wrapper = tlstm.lstm_scan_kernel if cell == "lstm" \
        else tgru.gru_scan_kernel
    with pytest.raises(ValueError, match="reuse"):
        wrapper(xs, W, U, b, reuse=5)
    with pytest.raises(ValueError):
        wrapper(xs, W, U[:, :-1], b)
    with pytest.raises(ValueError):
        wrapper(xs[..., :-1], W, U, b)
