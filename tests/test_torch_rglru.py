"""The port's RG-LRU recurrence and Hadamard product against the JAX
package's, on the CPU.

Covers ``ops.rglru_scan`` in every mode and fp route, ``ops.hadamard``,
the two references, the ``rglru_scan`` / ``hadamard`` kernel wrappers and
``ops.SCHEDULED_KERNELS``.  ``repro`` runs its Pallas kernels in interpret
mode (``backend="pallas_interpret"``); on a CPU tensor the port's kernel
path runs each CUDA kernel's plain version.  Inputs come from
``repro.testing.make_kernel_inputs`` / ``make_quantized_inputs`` and cross
as numpy.

Tolerances:
  * float recurrence: ``CONFORMANCE_TOL`` (3e-5 float32, 2e-2 bfloat16)
    times max(1, max |reference|) against ``repro``'s ``ops.rglru_scan``
    and ``ref.rglru_scan_ref``.  Not bit for bit in float32: XLA's CPU
    backend contracts ``a * h + bx`` into one fused multiply-add (``repro``'s
    outputs equal a chain rounded once per step), while the port rounds the
    product and then the sum, as its CUDA kernel does on the card.  So the
    port is held bit for bit to a numpy float32 chain that rounds twice,
    and in bfloat16 bit for bit to ``repro`` (the f32 state's last-ulp
    differences vanish in the bf16 output on these seeds);
  * the native fp route: ``err == 0.0`` against
    ``repro.testing.quantized_golden_rglru`` and bit for bit against
    ``repro``'s native route, signed zeros included;
  * the emulation: bit for bit against ``repro``'s (on-grid products are
    exact, so the fused multiply-add changes nothing there);
  * native against emulation: equal as values only; the emulation gives
    -0.0 where a state rounds to zero from below, the native route +0.0;
  * ``hadamard``: bit for bit and the same dtype as ``repro``'s.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import FixedPointConfig as JFP  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.testing import (CONFORMANCE_TOL, make_kernel_inputs,  # noqa: E402
                           make_quantized_inputs, quantized_golden_rglru)

from repro_torch.config import FixedPointConfig as TFP  # noqa: E402
from repro_torch.core.quant.fixed_point import \
    fixed_point_error_bound  # noqa: E402
from repro_torch.kernels import cuda, ops, ref  # noqa: E402
from repro_torch.kernels import hadamard as thad  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402

MODES = ("static", "nonstatic", "pipeline")
#: (B, T, W): repro's own case, and a ragged width (R = 4 gives bw = 50)
SHAPES = ((3, 9, 128), (5, 7, 200))
DTYPES = ("float32", "bfloat16")
NATIVE = ((8, 3), (4, 2))


def scheds(R, mode="static", backend="pallas_interpret", **kw):
    """The same schedule in both packages (the port maps every backend but
    "xla" to its kernel path)."""
    return (JSchedule(reuse_factor=R, mode=mode, backend=backend, **kw),
            KernelSchedule(reuse_factor=R, mode=mode, backend=backend, **kw))


def to_torch(x):
    """A jax array as a torch tensor of the same dtype (bf16 through f32,
    exactly)."""
    dt = getattr(torch, jnp.dtype(x.dtype).name)
    return torch.from_numpy(np.array(x, np.float32)).to(dt)


def f32(x):
    """A jax array or torch tensor as a float32 numpy array (exact from
    bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def same_bits(got, want):
    got, want = f32(got), f32(want)
    return got.shape == want.shape and np.array_equal(got.view(np.int32),
                                                      want.view(np.int32))


def close(got, want, dtype):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, err


def two_roundings(a, bx):
    """The recurrence in numpy float32, the product and the sum rounded
    separately (numpy fuses nothing)."""
    a, bx = f32(a), f32(bx)
    h = np.zeros((a.shape[0], a.shape[2]), np.float32)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return np.stack(hs, axis=1)


def sid(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# ops.rglru_scan, float
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=sid)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", (1, 2, 4))
@pytest.mark.parametrize("mode", MODES)
def test_rglru_scan_matches_repro(mode, R, dtype, shape):
    B, T, W = shape
    a, bx = make_kernel_inputs("rglru", B=B, T=T, H=W, dtype=dtype, seed=R)
    js, ts = scheds(R, mode)
    got = ops.rglru_scan(to_torch(a), to_torch(bx), schedule=ts)
    want = jops.rglru_scan(a, bx, schedule=js)
    golden = jref.rglru_scan_ref(a, bx)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, W)
    close(got, want, dtype)
    close(got, golden, dtype)
    if dtype == "bfloat16":
        assert same_bits(got, want)
    else:   # the reason is in the module docstring: XLA fuses an FMA
        want32 = two_roundings(a, bx)
        assert np.array_equal(f32(got).view(np.int32), want32.view(np.int32))
    # the port's own reference is the same chain
    assert same_bits(ref.rglru_scan_ref(to_torch(a), to_torch(bx)), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_scan_ref_matches_repro(dtype):
    a, bx = make_kernel_inputs("rglru", B=4, T=11, H=24, dtype=dtype)
    got = ref.rglru_scan_ref(to_torch(a), to_torch(bx))
    want = jref.rglru_scan_ref(a, bx)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, dtype)
    # a bf16 a with an f32 bx: the state is f32 and the output in a's dtype
    mixed = ref.rglru_scan_ref(to_torch(a).bfloat16(), to_torch(bx).float())
    assert mixed.dtype == torch.bfloat16
    close(mixed, jref.rglru_scan_ref(a.astype(jnp.bfloat16),
                                     bx.astype(jnp.float32)), "bfloat16")


@pytest.mark.parametrize("mode,R", [("static", 1), ("static", 4),
                                    ("nonstatic", 2)])
def test_rglru_hoist_input_is_a_noop(mode, R):
    """``hoist_input`` changes no bit; pipeline mode (which forces the
    hoist) runs the same unrolled chain as non-static mode."""
    a, bx = (to_torch(v) for v in make_kernel_inputs("rglru", B=3, T=9,
                                                     H=128))
    plain = KernelSchedule(reuse_factor=R, mode=mode)
    got = ops.rglru_scan(a, bx, schedule=plain.replace(hoist_input=True))
    assert same_bits(got, ops.rglru_scan(a, bx, schedule=plain))
    if mode == "nonstatic":
        assert same_bits(got, ops.rglru_scan(
            a, bx, schedule=plain.replace(mode="pipeline")))


def test_resolve_honours_schedule_block_batch():
    """As ``tests/test_schedule_conformance.py``'s test of ``repro``: a
    caller's ``schedule.block_batch`` survives dispatch."""
    s = KernelSchedule(block_batch=64)
    assert ops._resolve(s, None).block_batch == 64
    assert ops._resolve(s, None, default_bb=8).block_batch == 64
    assert ops._resolve(None, None, default_bb=8).block_batch == 8
    assert ops._resolve(s, 16).block_batch == 16


@pytest.mark.parametrize("B,W,kw,tiles", [
    (3, 128, {}, (3, 128, False)),
    (20, 64, {}, (8, 64, False)),
    (20, 64, {"block_batch": 4}, (4, 64, False)),
    (20, 64, {"schedule": KernelSchedule(block_batch=16)}, (16, 64, False)),
    (5, 200, {"schedule": KernelSchedule(reuse_factor=4)}, (5, 50, True)),
    (5, 200, {"schedule": KernelSchedule(reuse_factor=2)}, (5, 100, True)),
    (8, 4096, {"schedule": KernelSchedule()}, (8, 128, False)),
    (8, 4096, {"schedule": KernelSchedule(reuse_factor=2)}, (8, 128, True)),
    (8, 4096, {"schedule": KernelSchedule(reuse_factor=4)}, (8, 128, True)),
    (8, 4096, {"schedule": KernelSchedule(reuse_factor=4),
               "block_width": 256}, (8, 256, True)),
], ids=lambda v: str(v) if not isinstance(v, dict) else "-".join(
    f"{k}{getattr(x, 'reuse_factor', x)}" for k, x in v.items()))
def test_rglru_static_tiles(monkeypatch, B, W, kw, tiles):
    """Static mode hands the kernel repro's tiles: bb = min(block_batch,
    B) (the schedule's, else 8), bw = min(block_width, ceil(W / R)), the
    width tiles serial at R > 1."""
    seen = []

    def spy(a, bx, *, block_batch, block_width, serial_width):
        seen.append((block_batch, block_width, serial_width))
        return trg.rglru_scan_plain(a, bx)

    monkeypatch.setattr(ops, "rglru_scan_kernel", spy)
    a = torch.rand(B, 3, W)
    assert same_bits(ops.rglru_scan(a, a, **kw), ref.rglru_scan_ref(a, a))
    assert seen == [tiles]


# ---------------------------------------------------------------------------
# rglru_layout: the model of the kernel's launch layout
# ---------------------------------------------------------------------------

PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
#: small ragged shapes, and W = 1001: a row stride off the 16-byte grid
LAYOUT_SHAPES = ((4, 12, 20), (9, 12, 200), (3, 37, 1001))


def pid(pair):
    return "/".join(str(d)[6:] for d in pair)


def tile_kwargs(R, B, W):
    """The tiles ``ops.rglru_scan`` hands the kernel at reuse factor R."""
    bb, bw, serial = ops.rglru_tiles(KernelSchedule(reuse_factor=R), B, W)
    return {"block_batch": bb, "block_width": bw, "serial_width": serial}


def covered(lay, B, W):
    """How often the kernel's blocks cover each (row, column): on the ring,
    block k owns channels [c0, c0 + cols) (those below W) of row
    k // ceil(W / cols), c0 = (k % ceil(W / cols)) * cols; on the register
    window, thread i owns channels [c, c + vec) of row b, i = b * (W / vec)
    + c / vec, and ids past B * W / vec idle."""
    hits = np.zeros((B, W), np.int64)
    if lay.ring:
        col_blocks = -(-W // lay.cols)
        for k in range(lay.blocks):
            c0 = (k % col_blocks) * lay.cols
            hits[k // col_blocks, c0:c0 + lay.cols] += 1
        return hits
    nv = W // lay.vec
    ids = np.arange(lay.blocks * lay.threads)
    ids = ids[ids < B * nv]
    for i in range(lay.vec):
        np.add.at(hits, (ids // nv, (ids % nv) * lay.vec + i), 1)
    return hits


@pytest.mark.parametrize("pair", PAIRS, ids=pid)
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=sid)
def test_rglru_layout_covers_every_channel_once(shape, pair):
    """At every R and at operand offsets on and off the 16-byte grid, the
    blocks cover every (row, column) exactly once: on the ring where a
    tensor map can describe a and bx, else on the register window with a
    vector that W and every operand's offset allow."""
    B, _, W = shape
    sizes = [torch.empty((), dtype=d).element_size() for d in pair]
    sizes.append(sizes[0])
    routes = set()
    for offsets in ((0, 0, 0), (0, 0, 8), (4, 0, 8), (2, 2, 2), (0, 6, 12)):
        offsets = tuple(o - o % s for o, s in zip(offsets, sizes))
        for R in (1, 2, 4):
            lay = trg.rglru_layout(B, W, *pair, offsets=offsets,
                                   **tile_kwargs(R, B, W))
            ring = (offsets[0] == offsets[1] == 0
                    and all(W * s % 16 == 0 for s in sizes))
            assert lay.ring == ring
            routes.add(lay.ring)
            assert (covered(lay, B, W) == 1).all()
            if ring:   # one block a row's run of cols channels
                assert lay.blocks == B * -(-W // lay.cols)
                assert lay.threads == lay.cols + trg.PRODUCER
                assert lay.cols in (32, 64, 128) and lay.tc <= 256
                assert lay.cols * min(sizes) % 16 == 0   # a TMA box row
                assert lay.tc * lay.cols * sum(sizes[:2]) <= trg.STAGE_BYTES
                assert lay.stages == trg.STAGES
            else:      # no block idle: the last one holds work
                assert (lay.blocks - 1) * lay.threads < B * W // lay.vec
                assert W % lay.vec == 0 and lay.vec * max(sizes) <= 16
                assert all(o % (lay.vec * s) == 0
                           for o, s in zip(offsets, sizes))
                assert lay.threads % 32 == 0
                assert lay.threads <= trg.MAX_THREADS
                assert (lay.stages, lay.smem_bytes) == (0, 0)
    # a row stride off the 16-byte grid never takes the ring; an odd one
    # leaves the window one element a thread
    assert routes == ({0, 1} if W * max(sizes) % 16 == 0 and W * min(sizes)
                      % 16 == 0 else {0})
    if W % 2:
        assert trg.rglru_layout(B, W, *pair).vec == 1


@pytest.mark.parametrize("pair", PAIRS, ids=pid)
@pytest.mark.parametrize("shape", LAYOUT_SHAPES + ((8, 2048, 4096),
                                                   (1, 2048, 4096)), ids=sid)
def test_rglru_layout_is_one_at_every_r(shape, pair):
    """R names the passes only: the tiles of R = 1, 2 and 4 give one
    layout, which the wrapper's ``layout_of`` reads off the tensors."""
    B, T, W = shape
    lays = {trg.rglru_layout(B, W, *pair, **tile_kwargs(R, B, W))
            for R in (1, 2, 4)}
    assert len(lays) == 1
    if T <= 64:
        a = torch.rand(B, T, W).to(pair[0])
        bx = torch.rand(B, T, W).to(pair[1])
        assert trg.layout_of(a, bx, torch.empty_like(a)) == lays.pop()


@pytest.mark.parametrize("pair", PAIRS, ids=pid)
def test_rglru_layout_fills_the_card(pair):
    """At recurrentgemma-9b's width (8, 2048, 4096) the ring gives every
    one of the H100's 132 SMs blocks (256 of 128 channels, two an SM);
    one sequence (B = 1) spreads over 128 blocks of 32 channels; so does
    the register window at that width; no layout takes shared memory past
    a block's 232,448 bytes."""
    sa, sb = (torch.empty((), dtype=d).element_size() for d in pair)
    # a stage of 32 KiB (24 KiB for a mixed pair: tc stays a power of two)
    tc, tc1 = {8: (32, 128), 4: (64, 256), 6: (32, 128)}[sa + sb]
    lay = trg.rglru_layout(8, 4096, *pair)
    assert lay.ring and lay.blocks >= trg.SMS
    assert (lay.cols, lay.tc, lay.stages, lay.threads, lay.blocks) == (
        128, tc, 3, 160, 256)
    assert lay.smem_bytes == 3 * (tc * 128 * (sa + sb) + 16)
    one = trg.rglru_layout(1, 4096, *pair)
    assert (one.cols, one.tc, one.stages, one.threads, one.blocks) == (
        32, tc1, 3, 64, 128)
    win = trg.rglru_layout(8, 4096, *pair, offsets=(2, 2, 2))
    assert not win.ring and win.vec == 1 and win.blocks >= trg.SMS
    for B, W in ((8, 4096), (1, 4096), (256, 4096), (4096, 4096), (3, 1001),
                 (1, 8), (2, 16)):
        for off in ((0, 0, 0), (2, 2, 2)):
            lay = trg.rglru_layout(B, W, *pair, offsets=off)
            assert lay.smem_bytes <= 232_448 and lay.smem_bytes <= trg.MAX_SMEM
            if not lay.ring:
                assert lay.unroll >= trg.GROUPS
                assert lay.unroll % trg.GROUPS == 0
    # the window's loads fit the register budget: 64 steps of one f32 each
    assert trg.rglru_layout(8, 4096, offsets=(4, 4, 4)).unroll == 64
    assert trg.rglru_layout(1024, 4096, offsets=(0, 0, 4)).vec == 1
    wide = trg.rglru_layout(1024, 4096, offsets=(8, 8, 8))
    assert (wide.vec, wide.unroll) == (2, 32)


def test_rglru_layout_refuses_bad_shapes():
    with pytest.raises(ValueError, match="rglru_layout"):
        trg.rglru_layout(0, 8)
    with pytest.raises(ValueError, match="rglru_layout"):
        trg.rglru_layout(2, 8, block_width=0)


# ---------------------------------------------------------------------------
# ops.rglru_scan, fixed point
# ---------------------------------------------------------------------------


def fp_pair(w, i):
    return JFP(w, i), TFP(w, i)


@pytest.mark.parametrize("w,i", NATIVE, ids=lambda v: str(v))
def test_rglru_native_matches_golden_and_repro(w, i):
    jfp, tfp = fp_pair(w, i)
    a, bx = make_quantized_inputs("rglru", jfp, B=3, T=9, H=128)
    js, ts = scheds(2)
    got = ops.rglru_scan(to_torch(a), to_torch(bx), schedule=ts, fp=tfp)
    golden = quantized_golden_rglru(a, bx, jfp)
    assert float(np.abs(f32(got) - golden).max()) == 0.0
    want = jops.rglru_scan(a, bx, schedule=js, fp=jfp)
    assert same_bits(got, want)
    # the native route never gives -0.0
    assert not (np.signbit(f32(got)) & (f32(got) == 0)).any()


@pytest.mark.parametrize("w,i", NATIVE, ids=lambda v: str(v))
def test_rglru_native_equals_emulation_in_value(w, i):
    jfp, tfp = fp_pair(w, i)
    a, bx = (to_torch(v) for v in make_quantized_inputs("rglru", jfp, B=3,
                                                        T=9, H=128))
    _, ts = scheds(2)
    native = ops.rglru_scan(a, bx, schedule=ts, fp=tfp)
    emulated = ops.rglru_scan(a, bx, schedule=ts.replace(backend="xla"),
                              fp=tfp)
    assert torch.equal(native, emulated)        # as values: -0.0 == +0.0
    neg = torch.signbit(emulated) & (emulated == 0)
    assert bool(neg.any())        # the emulation's -0.0 exist on this seed
    assert not bool((torch.signbit(native) & (native == 0)).any())


@pytest.mark.parametrize("w,i,backend,mode", [
    (16, 6, "pallas_interpret", "static"),
    (16, 6, "pallas_interpret", "nonstatic"),
    (16, 6, "xla", "static"),
    (8, 3, "xla", "static"),
    (4, 2, "xla", "pipeline"),
])
def test_rglru_emulation_matches_repro(w, i, backend, mode):
    """Every non-native config, and a native one on ``backend="xla"``, runs
    the emulation: bit for bit ``repro``'s, signed zeros included."""
    jfp, tfp = fp_pair(w, i)
    a, bx = make_quantized_inputs("rglru", jfp, B=5, T=7, H=200, seed=3)
    js, ts = scheds(2, mode, backend)
    got = ops.rglru_scan(to_torch(a), to_torch(bx), schedule=ts, fp=tfp)
    want = jops.rglru_scan(a, bx, schedule=js, fp=jfp)
    assert same_bits(got, want)
    err = float(np.abs(f32(got) - quantized_golden_rglru(a, bx, jfp)).max())
    assert err <= 2 * fixed_point_error_bound(tfp)


def test_rglru_emulation_keeps_a_dtype():
    jfp, tfp = fp_pair(16, 6)
    a, bx = make_kernel_inputs("rglru", B=2, T=5, H=16, dtype="bfloat16")
    got = ops.rglru_scan(to_torch(a), to_torch(bx), fp=tfp)
    want = jops.rglru_scan(a, bx, fp=jfp)
    assert got.dtype == torch.bfloat16
    assert same_bits(got, want)


# ---------------------------------------------------------------------------
# ops.hadamard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37,), (1500, 200), (3, 5, 64)], ids=sid)
@pytest.mark.parametrize("dtype", DTYPES)
def test_hadamard_matches_repro(shape, dtype):
    rng = np.random.RandomState(len(shape))
    a = jnp.asarray(rng.randn(*shape), dtype)
    b = jnp.asarray(rng.randn(*shape), dtype)
    got = ops.hadamard(to_torch(a), to_torch(b))
    want = jops.hadamard(a, b)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    assert same_bits(got, want)
    assert same_bits(ref.hadamard_ref(to_torch(a), to_torch(b)),
                     jref.hadamard_ref(a, b))


def test_hadamard_mixed_dtypes_raise_in_both_packages():
    a = np.ones((4, 8), np.float32)
    with pytest.raises(ValueError):
        jops.hadamard(jnp.asarray(a, jnp.bfloat16), jnp.asarray(a))
    for dev in ("cpu", "meta"):
        with pytest.raises(TypeError, match="both float32 or both bfloat16"):
            ops.hadamard(torch.ones(4, 8, dtype=torch.bfloat16, device=dev),
                         torch.ones(4, 8, device=dev))


# ---------------------------------------------------------------------------
# The wrappers and the table
# ---------------------------------------------------------------------------


def test_scheduled_kernels_match_repro():
    assert list(ops.SCHEDULED_KERNELS) == list(jops.SCHEDULED_KERNELS)
    assert ops.SCHEDULED_KERNELS["rglru"] == (ops.rglru_scan,
                                              ref.rglru_scan_ref)


def test_wrappers_run_plain_on_cpu_without_counting():
    cuda.reset_launches()
    a = torch.rand(3, 6, 40)
    bx = torch.randn(3, 6, 40).bfloat16()
    got = trg.rglru_scan_kernel(a, bx, block_batch=2, block_width=16,
                                serial_width=True)
    assert same_bits(got, trg.rglru_scan_plain(a, bx))
    assert same_bits(got, ref.rglru_scan_ref(a, bx))
    x = torch.randn(7, 9)
    assert same_bits(thad.hadamard_kernel(x, x), thad.hadamard_plain(x, x))
    assert same_bits(thad.hadamard_kernel(x, x), x * x)
    assert cuda.LAUNCHES["rglru_scan"] == 0 and cuda.LAUNCHES["hadamard"] == 0


def test_wrappers_refuse_bad_arguments():
    a = torch.rand(2, 3, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trg.rglru_scan_kernel(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="one \\[B, T, W\\] shape"):
        trg.rglru_scan_kernel(a, a[:, :2])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trg.rglru_scan_kernel(a.double(), a)
    with pytest.raises(ValueError, match="tiles"):
        trg.rglru_scan_kernel(a, a, block_width=0)
    x = torch.rand(4, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        thad.hadamard_kernel(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="one \\[N, M\\] shape"):
        thad.hadamard_kernel(x, x[:2])
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        thad.hadamard_kernel(x.half(), x.half())
