"""The port's single-step decode kernels against the JAX package's, on the
CPU.

Covers ``kernels/decode_step.py`` (``decode_matmul``, the residency
helpers, ``rnn_decode_step``), ``kernels/quantized.quantized_decode_step``
and the residency cache of ``kernels/ops.py``.  On a CPU tensor a kernel
schedule runs the ``decode_matmul`` CUDA kernel's plain version; ``repro``
runs its Pallas kernel in interpret mode.  Inputs come from numpy seeds
and cross as numpy.

Tolerances (times max(1, max |reference|)): ``CONFORMANCE_TOL`` (3e-5
float32, 2e-2 bfloat16) for float products and steps, where the two
packages sum in different orders; bit for bit for the fixed-point steps on
PTQ'd weights, as PR 13's scans (every value lies on the grid, and on these
seeds no activation crosses a rounding tie), and for native == emulation
inside the port.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import FixedPointConfig as JFP  # noqa: E402
from repro.core.rnn.cells import initial_state as jinitial_state  # noqa: E402
from repro.kernels import decode_step as jds  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.testing import CONFORMANCE_TOL, make_quantized_inputs  # noqa: E402

from repro_torch.config import FixedPointConfig as TFP  # noqa: E402
from repro_torch.core.rnn.cells import initial_state  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.kernels import decode_step as tds  # noqa: E402
from repro_torch.kernels.quantized import quantized_decode_step  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402

#: fp configs of the step tests: none, the paper's emulated ap_fixed<16,6>,
#: the native int8 ap_fixed<8,3>
FPS = {"float": None, "ap16_6": (16, 6), "ap8_3": (8, 3)}


def sched(R, backend="pallas_interpret"):
    """The same schedule in both packages."""
    return (JSchedule(reuse_factor=R, block_batch=8, backend=backend),
            KernelSchedule(reuse_factor=R, block_batch=8, backend=backend))


def close(got, want, dtype="float32"):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, err


def as_np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# decode_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", [1, 2, 4, 5, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matmul_matches_repro(R, dtype):
    """Ragged M = 3 (repro pads it to 8 rows), N = 80 in R tiles: N/R is
    16 or 8 columns, under a bf16 vector width at R = 10."""
    rng = np.random.RandomState(0)
    x, w = rng.randn(3, 26), rng.randn(26, 80)
    js, ts = sched(R)
    want = jds.decode_matmul(jnp.asarray(x, jnp.dtype(dtype)),
                             jnp.asarray(w, jnp.dtype(dtype)), schedule=js)
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, dtype=torch.float32).to(tdt)
    wt = torch.tensor(w, dtype=torch.float32).to(tdt)
    before = dict(cuda.LAUNCHES)
    got = tds.decode_matmul(xt, wt, schedule=ts)
    assert got.dtype == tdt and cuda.LAUNCHES == before
    close(as_np(got), np.asarray(want, np.float32), dtype)
    # the plain version repeats the kernel's column tiles: every R agrees
    # with R = 1 (each column one full-K float32 reduction)
    np.testing.assert_array_equal(
        as_np(tds.decode_matmul_plain(xt, wt, reuse=R)),
        as_np(tds.decode_matmul_plain(xt, wt, reuse=1)))


@pytest.mark.parametrize("schedule", [None, sched(4, "xla")[1]],
                         ids=["none", "xla"])
def test_decode_matmul_xla_backend_is_plain_dot(schedule):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 12).astype(np.float32)
    w = rng.randn(12, 24).astype(np.float32)
    got = tds.decode_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            schedule=schedule)
    close(got.numpy(), np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w))))
    # mixed dtypes promote as jnp.dot does
    mixed = tds.decode_matmul(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w), schedule=schedule)
    assert mixed.dtype == torch.float32


def test_decode_matmul_degenerate_tiles_and_mixed_dtypes():
    """R = N (one column per pass) matches repro; a bf16 x on f32 weights
    is refused, as repro's Pallas kernel refuses it, on every device."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 26).astype(np.float32)
    w = rng.randn(26, 80).astype(np.float32)
    js, ts = sched(80)
    close(tds.decode_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            schedule=ts).numpy(),
          np.asarray(jds.decode_matmul(jnp.asarray(x), jnp.asarray(w),
                                       schedule=js)))
    with pytest.raises(ValueError):
        jds.decode_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                          schedule=js)
    xb = torch.from_numpy(x).bfloat16()
    for dev in ("cpu", "meta"):
        with pytest.raises(TypeError, match="both float32 or both bfloat16"):
            tds.decode_matmul_kernel(xb.to(dev), torch.from_numpy(w).to(dev),
                                     reuse=4)


def test_decode_matmul_refuses_bad_arguments():
    x, w = torch.zeros(3, 8), torch.zeros(8, 12)
    with pytest.raises(ValueError, match="does not divide"):
        tds.decode_matmul_kernel(x, w, reuse=5)
    with pytest.raises(ValueError, match="not a matrix product"):
        tds.decode_matmul_kernel(x, torch.zeros(7, 12))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tds.decode_matmul_kernel(x.to("meta"), w.to("meta"))
    # the schedule's reuse factor degrades to a divisor of N (gcd)
    out = tds.decode_matmul(x, w, schedule=KernelSchedule(reuse_factor=8))
    assert out.shape == (3, 12)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        tds.decode_matmul_kernel(x.double(), w.double())


def gemma_products(cut: int = 8):
    """gemma-2b's four per-token products (K, N) from the port's config,
    K and N cut by ``cut`` with their K/N ratios kept."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma-2b")
    d, hd = cfg.d_model, cfg.head_dim
    full = {"qkv": (d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
            "o": (cfg.n_heads * hd, d), "gate_up": (d, 2 * cfg.d_ff),
            "down": (cfg.d_ff, d)}
    return {k: (K // cut, N // cut) for k, (K, N) in full.items()}


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("prod", ["qkv", "o", "gate_up", "down"])
def test_decode_matmul_matches_repro_at_gemma_products(prod, R):
    """bf16 at gemma-2b's per-token products cut by 8 (M = 4, q|k|v also at
    the ragged M = 3) against repro's interpret-mode kernel."""
    K, N = gemma_products()[prod]
    rng = np.random.RandomState(11)
    for M in ((4, 3) if prod == "qkv" else (4,)):
        x, w = rng.randn(M, K), rng.randn(K, N) / np.sqrt(K)
        js, ts = sched(R)
        want = jds.decode_matmul(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16), schedule=js)
        got = tds.decode_matmul(
            torch.tensor(x, dtype=torch.float32).bfloat16(),
            torch.tensor(w, dtype=torch.float32).bfloat16(), schedule=ts)
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        close(as_np(got), np.asarray(want, np.float32), "bfloat16")


#: (M, K, N, bf16) at which the layout is checked: gemma-2b's products at
#: full size (M = 4, q|k|v also 3), the taggers' decode-step products (f32,
#: M = 1 and 256), ragged and very wide shapes
LAYOUT_SHAPES = (
    [(M, K, N, True) for K, N in gemma_products(1).values() for M in (4,)]
    + [(3, 2048, 2560, True)]
    + [(M, K, N, False) for M in (1, 256)
       for K, N in ((6, 80), (20, 80), (6, 60), (20, 60), (6, 480),
                    (120, 480), (6, 360), (120, 360), (3, 512), (128, 512),
                    (3, 384), (128, 384))]
    + [(3, 26, 80, True), (9, 300, 96, False), (2, 5000, 64, True),
       (1, 65536, 8, False), (4, 64, 2 ** 22, True)])


def walk(lay, M, K, N, R):
    """How often the kernel's threads multiply x[m, k] by w[k, n], as the
    kernel carves the layout: block b is m tile b % m_tiles, then column
    block, then K split; its K warp kw takes chunks kw, kw + k_warps, ...
    of the split's run, and every tile r of its columns."""
    cover = np.zeros((M, N, K), np.uint8)
    ns = N // R
    bcols = lay.warps * 32 * lay.vec
    for b in range(lay.blocks):
        mt, rest = b % lay.m_tiles, b // lay.m_tiles
        cb, split = rest % lay.col_blocks, rest // lay.col_blocks
        k0 = split * lay.chunks_per_split * lay.chunk
        run = min(K - k0, lay.chunks_per_split * lay.chunk)
        rows = slice(mt * lay.rows, min(M, (mt + 1) * lay.rows))
        c0, c1 = cb * bcols, min(ns, (cb + 1) * bcols)
        for kw in range(lay.k_warps):
            for c in range(kw, -(-run // lay.chunk), lay.k_warps):
                ks = slice(k0 + c * lay.chunk,
                           k0 + min((c + 1) * lay.chunk, run))
                for r in range(R):
                    cover[rows, r * ns + c0:r * ns + c1, ks] += 1
    return cover


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("M,K,N,bf16", [s for s in LAYOUT_SHAPES
                                        if s[0] * s[1] * s[2] <= 2 ** 26])
def test_decode_layout_covers_every_product_once(M, K, N, bf16, R):
    lay = tds.decode_layout(M, K, N, R, bf16)
    cover = walk(lay, M, K, N, R)
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("M,K,N,bf16", LAYOUT_SHAPES)
def test_decode_layout_chunks_do_not_depend_on_R(M, K, N, bf16):
    """The chunk, hence every column's summation order, is the same at every
    R (and M): R = 1 and R = 4 give the same bits by construction."""
    chunk = tds.chunk_rows(K, N, bf16)
    for R in (1, 2, 4, 8):
        if N % R == 0:
            lay = tds.decode_layout(M, K, N, R, bf16)
            assert lay.chunk == chunk and lay.chunks == -(-K // chunk)
    assert tds.decode_layout(1, K, N, 1, bf16).chunk == chunk


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("M,K,N,bf16", LAYOUT_SHAPES)
def test_decode_layout_fits_the_card(M, K, N, bf16, R):
    lay = tds.decode_layout(M, K, N, R, bf16)
    run = min(K, lay.chunks_per_split * lay.chunk)
    assert lay.blocks <= 2 ** 31 - 1 and lay.threads <= 256
    assert lay.smem_bytes <= tds.SMEM_LIMIT
    assert lay.rows * run * 4 <= tds.MAX_X_BYTES
    assert lay.rows in tds.ROWS and lay.warps in tds.WARPS
    assert lay.k_warps in tds.K_WARPS
    assert lay.vec == ((8 if bf16 else 4) if (N // R) % (8 if bf16 else 4)
                       == 0 else 1)
    assert lay.launches == (2 if lay.splits > 1 else 1)
    # R = 4's tiles give a quarter of the column blocks: it takes at least
    # as many splits as R = 1 where K has the chunks for it
    if R == 4:
        assert lay.splits >= min(tds.decode_layout(M, K, N, 1, bf16).splits,
                                 lay.chunks) or lay.blocks >= tds.SMS


@pytest.mark.parametrize("M,K,N,R,dtype", [
    (4, 2048, 2560, 4, torch.bfloat16), (4, 2048, 32768, 1, torch.bfloat16),
    (256, 128, 512, 1, torch.float32), (1, 20, 60, 4, torch.float32)])
def test_launch_hands_the_layout_to_the_c_entry_point(M, K, N, R, dtype,
                                                      monkeypatch):
    x, w = torch.zeros(M, K, dtype=dtype), torch.zeros(K, N, dtype=dtype)
    calls = []
    monkeypatch.setattr(cuda, "require", lambda *a, **k: x.device)
    monkeypatch.setattr(cuda, "launch", lambda *a, **k: calls.append(a))
    out = tds.launch_decode(x, w, R)
    assert out.shape == (M, N) and out.dtype == dtype
    (lib, fn, dev, *args), = calls
    assert (lib, fn) == ("decode_matmul", "decode_matmul")
    # every C argument but the stream, which cuda.launch appends
    assert len(args) == len(cuda.SIGNATURES[lib][fn][1]) - 1
    lay = tds.decode_layout(M, K, N, R, dtype == torch.bfloat16)
    assert args[2] == int(dtype == torch.bfloat16)
    assert args[5:9] == [M, K, N, R] and tuple(args[9:]) == lay.c_args()
    # a workspace exactly where more than one split shares K
    assert (args[4] != 0) == (lay.splits > 1)


# ---------------------------------------------------------------------------
# rnn_decode_step
# ---------------------------------------------------------------------------


def _step_inputs(cell, fp):
    """PTQ'd weights for fixed point (native == emulation needs them on
    the grid), raw ones otherwise; B = 3, F = 6, H = 12."""
    jfp = None if fp is None else JFP(*fp)
    shapes = dict(B=3, T=2, F=6, H=12, seed=4)
    if jfp is None:
        from repro.testing import make_kernel_inputs

        xs, W, U, b = make_kernel_inputs(cell, **shapes)
    else:
        xs, W, U, b = make_quantized_inputs(cell, jfp, **shapes)
    return jfp, tuple(np.array(v) for v in (xs, W, U, b))


def _flat(state):
    return state if isinstance(state, tuple) else (state,)


@pytest.mark.parametrize("fp_name", list(FPS))
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_decode_step_matches_repro(cell, R, fp_name):
    """Two chained steps (the state feeds back) on a kernel schedule:
    float steps within 3e-5, fixed-point steps (emulated ap_fixed<16,6>,
    native int8 ap_fixed<8,3>) bit for bit."""
    fp = FPS[fp_name]
    jfp, (xs, W, U, b) = _step_inputs(cell, fp)
    tfp = None if fp is None else TFP(*fp)
    js, ts = sched(R)
    jstate = jinitial_state(cell, 3, 12, jnp.float32)
    tstate = initial_state(cell, 3, 12)
    jw = tuple(jnp.asarray(v) for v in (W, U, b))
    tw = tuple(torch.from_numpy(v) for v in (W, U, b))
    for t in range(2):
        jh, jstate = jds.rnn_decode_step(cell, jnp.asarray(xs[:, t]), jstate,
                                         *jw, schedule=js, fp=jfp)
        th, tstate = tds.rnn_decode_step(cell, torch.from_numpy(xs[:, t]),
                                         tstate, *tw, schedule=ts, fp=tfp)
        for got, want in zip((th,) + _flat(tstate),
                             (jh,) + _flat(jstate)):
            if fp is None:
                close(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_decode_step_bf16_matches_repro(cell):
    from repro.testing import make_kernel_inputs

    inputs = make_kernel_inputs(cell, B=3, T=2, F=6, H=12, dtype="bfloat16",
                                seed=5)
    js, ts = sched(2)
    jstate = jinitial_state(cell, 3, 12, jnp.bfloat16)
    tstate = initial_state(cell, 3, 12, torch.bfloat16)
    tw = tuple(torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
               for v in inputs)
    for t in range(2):
        jh, jstate = jds.rnn_decode_step(cell, inputs[0][:, t], jstate,
                                         *inputs[1:], schedule=js)
        th, tstate = tds.rnn_decode_step(cell, tw[0][:, t], tstate, *tw[1:],
                                         schedule=ts)
        assert th.dtype == torch.bfloat16
        close(as_np(th), np.asarray(jh, np.float32), "bfloat16")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_native_step_equals_emulation_in_the_port(cell):
    """ap_fixed<8,3> on a kernel schedule (int32 gate products) equals the
    same step on backend="xla" (the f32 emulation) bit for bit, and the
    ap_fixed<16,6> step on a kernel schedule equals its xla step within
    3e-5 (on the CPU, where the kernel's plain version runs, bit for bit)."""
    for fp, exact in (((8, 3), True), ((16, 6), False)):
        _, (xs, W, U, b) = _step_inputs(cell, fp)
        tw = tuple(torch.from_numpy(v) for v in (W, U, b))
        st_k = st_x = initial_state(cell, 3, 12)
        for t in range(2):
            x = torch.from_numpy(xs[:, t])
            h_k, st_k = tds.rnn_decode_step(cell, x, st_k, *tw,
                                            schedule=sched(4)[1], fp=TFP(*fp))
            h_x, st_x = tds.rnn_decode_step(cell, x, st_x, *tw,
                                            schedule=sched(4, "xla")[1],
                                            fp=TFP(*fp))
            if exact:
                np.testing.assert_array_equal(h_k.numpy(), h_x.numpy())
            else:
                close(h_k.numpy(), h_x.numpy())
    with pytest.raises(ValueError, match="not a native int"):
        quantized_decode_step(cell, x, st_k, *tw, fp=TFP(16, 6))


def test_native_step_packs_weights_once():
    """The native step's int8 weights come from the residency cache: a
    second step hits, an in-place update of W repacks."""
    _, (xs, W, U, b) = _step_inputs("lstm", (8, 3))
    tw = tuple(torch.from_numpy(v) for v in (W, U, b))
    cache = ops.RESIDENT_WEIGHTS
    x = torch.from_numpy(xs[:, 0])
    st = initial_state("lstm", 3, 12)
    fp = TFP(8, 3)
    h1, _ = quantized_decode_step("lstm", x, st, *tw, fp=fp)
    hits = cache.hits
    h2, _ = quantized_decode_step("lstm", x, st, *tw, fp=fp)
    assert cache.hits == hits + 2
    np.testing.assert_array_equal(h1.numpy(), h2.numpy())
    misses = cache.misses
    tw[0].mul_(0.0)
    h3, _ = quantized_decode_step("lstm", x, st, *tw, fp=fp)
    assert cache.misses == misses + 1
    assert not torch.equal(h3, h1)


# ---------------------------------------------------------------------------
# Weight residency
# ---------------------------------------------------------------------------


def test_residency_returns_the_same_pack_until_the_source_changes():
    w = torch.from_numpy(np.random.RandomState(0).randn(6, 4, 8)
                         .astype(np.float32))
    s = KernelSchedule(reuse_factor=2)
    a = tds.resident_matrix(w, schedule=s, tag="t")
    assert a is tds.resident_matrix(w, schedule=s, tag="t")
    assert a.shape == (6, 32)
    c = tds.resident_matrix(w, schedule=s.replace(reuse_factor=4), tag="t")
    assert c is not a and torch.equal(c, a)
    before = a.clone()
    w.add_(1.0)                                  # in place: version bumps
    d = tds.resident_matrix(w, schedule=s, tag="t")
    assert d is not a
    np.testing.assert_array_equal(d.numpy(), before.numpy() + 1.0)
    assert tds.resident_matrix(w, schedule=s, tag="t") is d


def test_residency_fused_identity_and_staleness():
    rng = np.random.RandomState(1)
    w1, w2, w3 = (torch.from_numpy(rng.randn(6, 8).astype(np.float32))
                  for _ in range(3))
    s = KernelSchedule(reuse_factor=2)
    f1 = tds.resident_fused((w1, w2), schedule=s, dtype=torch.bfloat16)
    assert f1 is tds.resident_fused((w1, w2), schedule=s,
                                    dtype=torch.bfloat16)
    assert f1.shape == (6, 16) and f1.dtype == torch.bfloat16
    f2 = tds.resident_fused((w1, w3), schedule=s, dtype=torch.bfloat16)
    assert f2 is not f1
    np.testing.assert_array_equal(f2[:, 8:].float().numpy(),
                                  w3.bfloat16().float().numpy())


def test_residency_eviction_is_bounded_by_count_and_bytes():
    cache = ops.WeightResidency(max_entries=4)
    arrs = [torch.full((2, 2), float(i)) for i in range(8)]
    for a in arrs:
        cache.get(a, "k", lambda a=a: a * 2)
    assert len(cache) == 4
    cache.get(arrs[-1], "k", lambda: arrs[-1] * 2)
    assert cache.hits == 1
    # each packed payload is 64 bytes; a 160-byte budget holds two entries
    cache = ops.WeightResidency(max_entries=100, max_bytes=160)
    arrs = [torch.full((4, 4), float(i)) for i in range(5)]
    for a in arrs:
        cache.get(a, "k", lambda a=a: {"w": [a * 2]})
    assert len(cache) == 2 and cache.bytes == 128
    # a pack over the byte bound is returned but not kept
    big = cache.get(torch.zeros(8, 8), "k", lambda: torch.zeros(8, 8))
    assert big.shape == (8, 8) and len(cache) == 0 and cache.bytes == 0


def test_residency_never_caches_unversioned_sources():
    cache = ops.WeightResidency()
    w = np.ones((2, 2), np.float32)
    first = cache.get(w, "k", lambda: torch.from_numpy(w * 2))
    w[...] = 5.0
    second = cache.get(w, "k", lambda: torch.from_numpy(w * 2))
    assert len(cache) == 0
    np.testing.assert_array_equal(first.numpy(), 2 * np.ones((2, 2)))
    np.testing.assert_array_equal(second.numpy(), 10 * np.ones((2, 2)))
    with torch.inference_mode():
        t = torch.ones(2, 2)                     # no version counter
    cache.get(t, "k", lambda: t * 2)
    assert len(cache) == 0 and cache.misses == 0
