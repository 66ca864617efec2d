"""The scan path's weight residency, on the CPU.

``ops.lstm_scan`` / ``ops.gru_scan`` on a kernel schedule take their f32,
contiguous W, U and b from ``ops.RESIDENT_WEIGHTS`` (packed once per weights
identity and version), as ``repro`` packs them through its
``_scan_weights_resident``.  A second call hits the cache, an in-place
update of a weight misses it and repacks, and the outputs follow the
weights.  Inputs come from ``repro.testing.make_kernel_inputs`` (numpy,
seeded) and cross as numpy; outputs are held to ``repro``'s Pallas kernels
in interpret mode at ``CONFORMANCE_TOL`` x max(1, |want|).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_kernel_inputs  # noqa: E402

from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402

SHAPES = {"B": 4, "T": 5, "F": 6, "H": 8}


def to_torch(a) -> "torch.Tensor":
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def assert_close(got, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    limit = CONFORMANCE_TOL[dtype] * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"max_err={err:.3e} > {limit:.3e}"


def repro_scan(cell, mode, args):
    """``repro``'s scan on the numpy copies of the port's tensors."""
    xs, W, U, b = (jax.numpy.asarray(a) for a in args)
    sched = JSchedule(mode=mode, backend="pallas_interpret")
    return getattr(jops, f"{cell}_scan")(xs, W, U, b, schedule=sched)


def as_jax(tensors, dtype: str):
    return tuple(jax.numpy.asarray(t.float().numpy(), dtype) for t in tensors)


@pytest.mark.parametrize("cell,mode,dtype", [
    *((c, m, "bfloat16") for c in ("lstm", "gru")
      for m in ("static", "nonstatic", "pipeline")),
    ("lstm", "static", "float32"), ("gru", "static", "float32")])
def test_scan_weights_pack_once_and_repack_after_an_update(cell, mode, dtype):
    inputs = make_kernel_inputs(cell, dtype=dtype, seed=3, **SHAPES)
    xs, W, U, b = (to_torch(a) for a in inputs)
    scan = getattr(ops, f"{cell}_scan")
    sched = KernelSchedule(mode=mode)
    cache = ops.RESIDENT_WEIGHTS
    before = dict(cuda.LAUNCHES)

    first = scan(xs, W, U, b, schedule=sched)
    hits, misses = cache.hits, cache.misses
    second = scan(xs, W, U, b, schedule=sched)
    assert (cache.hits, cache.misses) == (hits + 1, misses)
    assert torch.equal(first, second)
    assert_close(first, repro_scan(cell, mode, inputs), dtype)

    with torch.no_grad():
        U.mul_(0.5)
    third = scan(xs, W, U, b, schedule=sched)
    assert cache.misses == misses + 1
    assert not torch.equal(third, first)
    assert_close(third, repro_scan(cell, mode, as_jax((xs, W, U, b), dtype)),
                 dtype)
    assert cuda.LAUNCHES == before, "a CPU tensor must not launch a kernel"


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_scan_weights_pack_to_f32(dtype):
    """f32 contiguous weights come back as the same tensors; bf16 weights
    as their exact f32 copies."""
    rng = np.random.RandomState(0)
    W, U, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
               for s in ((6, 32), (8, 32), (32,)))
    packed = ops._scan_weights_resident("lstm", W, U, b)
    assert all(p.dtype == torch.float32 and p.is_contiguous()
               for p in packed)
    assert all(torch.equal(p, s.float()) for p, s in zip(packed, (W, U, b)))
    assert all((p is s) == (dtype == torch.float32)
               for p, s in zip(packed, (W, U, b)))
    assert ops._scan_weights_resident("lstm", W, U, b) is packed
    assert ops._scan_weights_resident("gru", W, U, b) is not packed
