"""The tiled product kernels (``col_matmul``, ``quant_matmul``), the launch
path they share with every kernel, and the static scans' route past the
cluster kernel's H, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; it is held to
``repro``'s Pallas kernel in interpret mode at ragged shapes (M in {1, 9},
K in {3, 20}, N/R = 15): ``quant_matmul`` bit for bit, ``col_matmul`` within
``CONFORMANCE_TOL`` x max(1, |want|) (3e-5 float32: the order of the f32
sums differs; 2e-2 bfloat16: x rounds at 2^-8).  The route past H = 128
(``col_matmul`` of every step's input side, then the hoisted scan) is held
to ``repro``'s in-loop Pallas scans at H = 160.  The kernels themselves
run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gru_scan as jgru  # noqa: E402
from repro.kernels import lstm_scan as jlstm  # noqa: E402
from repro.kernels import quantized as jq  # noqa: E402
from repro.kernels import reuse_matmul as jrm  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_kernel_inputs  # noqa: E402

from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import gru_scan as tgru  # noqa: E402
from repro_torch.kernels import lstm_scan as tlstm  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.kernels import reuse_matmul as trm  # noqa: E402
from repro_torch.kernels import scan_layout as sl  # noqa: E402

RAGGED = [(M, K) for M in (1, 9) for K in (3, 20)]
#: N = 60 in R = 4 tiles of 15 columns, and in one tile
RAGGED_N, REUSES = 60, (1, 4)


def assert_close(got, want, dtype: str) -> None:
    got = np.asarray(got.float().numpy(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    limit = CONFORMANCE_TOL[dtype] * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"max_err={err:.3e} > {limit:.3e}"


def to_torch(a) -> "torch.Tensor":
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


# -- 1. col_matmul and quant_matmul at ragged shapes ------------------------


@pytest.mark.parametrize("reuse", REUSES)
@pytest.mark.parametrize("M,K", RAGGED)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_col_matmul_ragged_matches_pallas(dtype, M, K, reuse):
    rng = np.random.RandomState(M * 100 + K)
    x = jnp.asarray(rng.randn(M, K), dtype=dtype)
    w = jnp.asarray(rng.randn(K, RAGGED_N) / np.sqrt(K), dtype=jnp.float32)
    want = jrm.col_matmul_pallas(x, w, reuse=reuse, block_m=M,
                                 interpret=True)
    before = dict(cuda.LAUNCHES)
    got = trm.col_matmul_kernel(to_torch(x), to_torch(w), reuse=reuse)
    assert got.dtype == to_torch(x).dtype
    assert_close(got, want, dtype)
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"


@pytest.mark.parametrize("reuse", REUSES)
@pytest.mark.parametrize("M,K", RAGGED)
@pytest.mark.parametrize("lim", (128, 8), ids=("int8", "int4"))
def test_quant_matmul_ragged_bitwise(lim, M, K, reuse):
    rng = np.random.RandomState(M * 100 + K + lim)
    x = rng.randint(-lim, lim, (M, K)).astype(np.int8)
    w = rng.randint(-lim, lim, (K, RAGGED_N)).astype(np.int8)
    want = np.asarray(jq.quant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), reuse=reuse, block_m=M,
        interpret=True))
    before = dict(cuda.LAUNCHES)
    got = tq.quant_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                 reuse=reuse)
    assert got.dtype == torch.int32 and cuda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reuse", REUSES)
def test_quant_matmul_takes_a_weight_past_shared_memory(reuse):
    """A 512 x 1024 int8 weight (512 KiB, past a block's 227 KiB) is taken:
    the kernel stages only its tiles, and the wrapper has no size limit."""
    rng = np.random.RandomState(reuse)
    x = rng.randint(-128, 128, (16, 512)).astype(np.int8)
    w = rng.randint(-128, 128, (512, 1024)).astype(np.int8)
    got = tq.quant_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                 reuse=reuse)
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))
    assert not hasattr(tq, "MAX_SMEM_BYTES")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tq.quant_matmul_kernel(torch.from_numpy(x).to("meta"),
                               torch.from_numpy(w).to("meta"), reuse=reuse)


# -- 2. the static scans past the cluster kernel's H ------------------------


@pytest.mark.parametrize("hidden,route", [
    (1, "cluster"), (20, "cluster"), (128, "cluster"), (129, "hoisted"),
    (160, "hoisted"), (256, "hoisted")])
def test_scan_route(hidden, route):
    """The cluster kernel up to MAX_CLUSTER_HIDDEN (= 128: 16 U rows on
    each of 8 lanes), col_matmul and the hoisted kernel past it; the
    cluster layout still refuses a larger H."""
    assert sl.MAX_CLUSTER_HIDDEN == sl.MAX_K * sl.K_SPLITS[-1] == 128
    assert sl.scan_route(hidden) == route
    if route == "hoisted":
        with pytest.raises(ValueError, match="no cluster layout"):
            sl.scan_layout(8, hidden, 3, "lstm")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("reuse", REUSES)
@pytest.mark.parametrize("cell", ("lstm", "gru"))
def test_composed_scan_matches_pallas(cell, reuse, dtype):
    """The H > 128 route's function, col_matmul_plain then the hoisted
    plain scan, against repro's in-loop Pallas kernel at H = 160."""
    xs, W, U, b = make_kernel_inputs(cell, B=9, T=5, F=6, H=160,
                                     dtype=dtype, seed=reuse)
    pallas = jlstm.lstm_scan_pallas if cell == "lstm" \
        else jgru.gru_scan_pallas
    want = pallas(xs, W, U, b, block_batch=9, reuse=reuse, interpret=True)
    composed = tlstm.lstm_scan_composed if cell == "lstm" \
        else tgru.gru_scan_composed
    # the kernel path computes every product from f32 weights (ops casts)
    tW, tU, tb = (to_torch(a).float() for a in (W, U, b))
    before = dict(cuda.LAUNCHES)
    got = composed(to_torch(xs), tW, tU, tb, reuse=reuse)
    assert got.dtype == to_torch(xs).dtype
    assert_close(got, want, dtype)
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"


# -- 3. the launch path ------------------------------------------------------


class CountingLibrary:
    def __init__(self):
        self.resolved, self.calls = [], []

    def __getattr__(self, name):
        self.resolved.append(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def test_launch_resolves_each_function_once(monkeypatch):
    """cuda.launch resolves a C function once (no lock, no lookup on later
    launches), appends the stream and counts every launch."""
    lib = CountingLibrary()
    opened = []

    def library(name):
        opened.append(name)
        return lib
    monkeypatch.setattr(cuda, "library", library)
    monkeypatch.setattr(cuda, "stream_ptr", lambda device: 1234)
    monkeypatch.setattr(cuda, "_fns", {})
    monkeypatch.setitem(cuda.LAUNCHES, "col_matmul", 0)
    for i in range(3):
        cuda.launch("reuse_matmul", "col_matmul", torch.device("cpu"), i)
    assert opened == ["reuse_matmul"] and lib.resolved == ["col_matmul"]
    assert lib.calls == [("col_matmul", (i, 1234)) for i in range(3)]
    assert cuda.LAUNCHES["col_matmul"] == 3


def test_launch_raises_on_an_error_and_does_not_count(monkeypatch):
    class Refusing:
        def col_matmul(self, *args):
            return 1

        def kernel_error_string(self, err):
            return b"invalid argument"
    monkeypatch.setattr(cuda, "library", lambda name: Refusing())
    monkeypatch.setattr(cuda, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(cuda, "_fns", {})
    monkeypatch.setitem(cuda.LAUNCHES, "col_matmul", 0)
    with pytest.raises(RuntimeError, match="CUDA error 1: invalid argument"):
        cuda.launch("reuse_matmul", "col_matmul", torch.device("cpu"))
    assert cuda.LAUNCHES["col_matmul"] == 0


def test_layout_exports_are_declared():
    """chip_smoke.py reads each product's launch layout from its library."""
    for lib, fn in (("reuse_matmul", "col_matmul_layout"),
                    ("reuse_matmul", "reuse_matmul_layout"),
                    ("quantized", "quant_matmul_layout")):
        restype, argtypes = cuda.SIGNATURES[lib][fn]
        assert len(argtypes) == 5


# -- 4. reuse_matmul's hand-off to its C entry point -----------------------


def record_launches(monkeypatch, device):
    calls = []
    monkeypatch.setattr(cuda, "require", lambda *a, **k: device)
    monkeypatch.setattr(cuda, "launch", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("reuse", REUSES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("M,K,N", [(256, 128, 512), (1, 60, 3), (9, 60, 20)])
def test_reuse_matmul_hands_the_shape_to_the_c_entry_point(M, K, N, dtype,
                                                           reuse,
                                                           monkeypatch):
    """The C call gets every argument of its signature: x, w, the bf16
    flag, out and (M, K, N, R) as given, a ragged M and N unpadded (the
    tiled kernel masks both edges)."""
    x, w = torch.zeros(M, K, dtype=dtype), torch.zeros(K, N, dtype=dtype)
    calls = record_launches(monkeypatch, x.device)
    out = trm.launch_reuse_matmul(x, w, reuse)
    assert out.shape == (M, N) and out.dtype == dtype
    ((lib, fn, dev, *args), kw), = calls
    assert (lib, fn, kw) == ("reuse_matmul", "reuse_matmul", {})
    # every C argument but the stream, which cuda.launch appends
    assert len(args) == len(cuda.SIGNATURES[lib][fn][1]) - 1
    assert args[:4] == [x.data_ptr(), w.data_ptr(),
                        int(dtype == torch.bfloat16), out.data_ptr()]
    assert args[4:] == [M, K, N, reuse]


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_reuse_matmul_refuses_mixed_operands_before_any_launch(
        x_dtype, w_dtype, monkeypatch):
    """x and w are both f32 or both bf16 (the Pallas kernel's contract):
    mixed operands raise on any device, and the launch path refuses them
    before it calls the library."""
    x, w = torch.zeros(9, 8, dtype=x_dtype), torch.zeros(8, 20, dtype=w_dtype)
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a, **k: calls.append(a))
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        trm.reuse_matmul_kernel(x, w, reuse=2)
    with pytest.raises(TypeError, match="w must be"):
        trm.launch_reuse_matmul(x, w, 2)
    assert calls == []
