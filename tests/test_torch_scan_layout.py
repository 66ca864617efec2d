"""The cluster layout of the in-loop static scan kernels (``lstm_scan`` /
``gru_scan``) and of the zx mode (both hoisted scans and both pipeline
scans), and the zx scans' routes by H:
``repro_torch.kernels.scan_layout``.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to its
plain version there, and checks that the C launcher refuses bad layouts);
these tests check, on the CPU, the layout at every tagger's shapes (with
the CPU's residency model in place of the card's answer), that the layout
follows the residency it is given, the R passes' column split, and that
the wrappers refuse a bad shape before any launch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import TAGGERS, get_config
from repro_torch.kernels import cuda
from repro_torch.kernels import gru_scan as tgru
from repro_torch.kernels import lstm_scan as tlstm
from repro_torch.kernels import scan_layout as sl
from repro_torch.kernels.schedule import KernelSchedule

SCHED = KernelSchedule()


def padded(B: int) -> int:
    """The rows ``ops._static_scan`` hands the kernel for B requests."""
    g = min(SCHED.block_batch, max(8, B))
    return -(-B // g) * g


def shapes(tag):
    r = get_config(tag).rnn
    return r.cell, r.hidden, r.input_size, (4 if r.cell == "lstm" else 3)


def owned_units(H, C):
    """The hidden units CTA c of a cluster owns: [c*u, (c+1)*u), u =
    ceil(H/C), as the kernel carves them."""
    u = sl.units_per_cta(H, C)
    return [range(min(c * u, H), min((c + 1) * u, H)) for c in range(C)]


@pytest.mark.parametrize("reuse", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 8, 9, 256])
@pytest.mark.parametrize("tag", sorted(TAGGERS))
def test_layout_fits_the_card(tag, batch, reuse):
    cell, H, fin, G = shapes(tag)
    B = padded(batch)
    R = SCHED.replace(reuse_factor=reuse).effective_reuse(G * H)
    lay = sl.scan_layout(B, H, fin, cell, R)
    C, bt, ks, threads, smem, clusters = lay
    assert smem <= 232_448 and smem == sl.smem_bytes(cell, H, fin, C, ks, bt)
    assert C in (1, 2, 4, 8)
    # every hidden unit owned by exactly one CTA, every CTA owns one
    owned = [j for units in owned_units(H, C) for j in units]
    assert sorted(owned) == list(range(H))
    assert all(len(units) > 0 for units in owned_units(H, C))
    # every unit has its k_split lanes, which hold all H of its U rows
    # (at most MAX_K each); warps are whole and a unit's lanes never
    # straddle two warps
    u = sl.units_per_cta(H, C)
    assert ks in sl.K_SPLITS and ks * sl.MAX_K >= H and 32 % ks == 0
    assert threads % 32 == 0 and u * ks <= threads <= sl.MAX_THREADS
    assert bt in sl.ROWS and bt * fin <= sl.X_PER_THREAD * threads
    # the grid: whole clusters covering every row, one wave at B = 256
    # (every cluster resident at once); at predict_one's B = 8 a cluster a
    # row
    assert clusters * bt >= B > (clusters - 1) * bt
    assert lay.ctas == clusters * C and lay.ctas % C == 0
    if B in (8, 256):
        assert clusters <= sl.model_resident(lay)
    if B <= 9:
        assert (bt, clusters) == (1, B)


@pytest.mark.parametrize("reuse", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tag", sorted(TAGGERS))
def test_passes_cover_every_gate_column_once(tag, reuse):
    cell, H, fin, G = shapes(tag)
    # the R the scan runs: the schedule degrades R to a divisor of G*h
    reuse = SCHED.replace(reuse_factor=reuse).effective_reuse(G * H)
    C = sl.scan_layout(256, H, fin, cell, reuse).cluster
    gw = G * H // reuse
    # pass p: the columns g*H + j in [p*gw, (p+1)*gw) of each CTA's units
    cols = [[[g * H + j for j in units for g in range(G)
              if p * gw <= g * H + j < (p + 1) * gw]
             for units in owned_units(H, C)] for p in range(reuse)]
    flat = [n for p in cols for cta in p for n in cta]
    assert sorted(flat) == list(range(G * H))
    for p, ctas in enumerate(cols):
        assert sum(map(len, ctas)) == gw
        for units, cta in zip(owned_units(H, C), ctas):
            assert all(n % H in units for n in cta)


def test_layout_prefers_least_work_in_one_wave():
    # QuickDraw LSTM at B = 256: 32 clusters of 8 CTAs, 8 rows x 16 units,
    # two CTAs an SM
    lay = sl.scan_layout(256, 128, 3, "lstm")
    assert (lay.cluster, lay.rows, lay.ctas) == (8, 8, 256)
    assert lay.clusters <= sl.model_resident(lay)
    # B = 8: 8 clusters of 8, a row and 16 units a CTA
    lay = sl.scan_layout(8, 128, 3, "gru")
    assert (lay.cluster, lay.rows, lay.clusters) == (8, 1, 8)
    # a batch beyond one wave takes the fewest waves
    lay = sl.scan_layout(100_000, 128, 3, "lstm")

    def waves(x):
        return -(-x.clusters // sl.model_resident(x))

    for C in sl.CLUSTERS:
        for rows in sl.ROWS:
            other = sl._candidate(100_000, 128, 3, "lstm", C, rows)
            if other is not None:
                assert waves(lay) <= waves(other)
    # H beyond 16 U rows x 8 lanes a unit has no layout
    sl.scan_layout(8, 128, 3, "gru")
    with pytest.raises(ValueError, match="no cluster layout"):
        sl.scan_layout(8, 129, 3, "gru")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_layout_follows_the_residency_it_is_given(cell):
    # top tagging at B = 256: the model holds 264 clusters of 4 one-warp
    # CTAs at once; a card that holds fewer (an H100 answers 248) gets
    # smaller clusters in one wave, never a second wave
    lay = sl.scan_layout(256, 20, 6, cell)
    assert (lay.cluster, lay.rows, lay.clusters) == (4, 1, 256)

    def tight(x):
        return 248 if x.cluster == 4 and x.rows == 1 else sl.model_resident(x)

    lay = sl.scan_layout(256, 20, 6, cell, resident=tight)
    assert lay.clusters <= tight(lay)
    assert (lay.cluster, lay.rows) == (2, 1)
    # a cluster shape the card never holds is never chosen
    lay = sl.scan_layout(8, 128, 3, cell,
                         resident=lambda x: 0 if x.cluster == 8 else 64)
    assert lay.cluster == 4
    with pytest.raises(ValueError, match="resident"):
        sl.scan_layout(8, 128, 3, cell, resident=lambda x: 0)


@pytest.mark.parametrize("kw,match", [
    ({"B": 0}, "B=0"), ({"cell": "rnn"}, "cell"), ({"reuse": 3}, "reuse"),
    ({"reuse": 0}, "reuse")])
def test_layout_rejects_bad_arguments(kw, match):
    args = {"B": 8, "hidden": 128, "fin": 3, "cell": "lstm", "reuse": 1}
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        sl.scan_layout(**args)


def inputs(cell, B=9, T=5, fin=3, H=20, seed=0):
    rng = np.random.RandomState(seed)
    G = 4 if cell == "lstm" else 3
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    b = rng.randn(*((G * H,) if cell == "lstm" else (2, G * H))) * 0.1
    return (t(rng.randn(B, T, fin)), t(rng.randn(fin, G * H) / 2),
            t(rng.randn(H, G * H) / 5), t(b))


@pytest.fixture
def no_launch(monkeypatch):
    def launch(*args):
        raise AssertionError(f"launched {args[:2]}")
    monkeypatch.setattr(cuda, "launch", launch)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wrapper_rejects_a_bad_shape_before_any_launch(cell, no_launch):
    xs, W, U, b = inputs(cell)
    kern = tlstm.lstm_scan_kernel if cell == "lstm" else tgru.gru_scan_kernel
    with pytest.raises(ValueError):
        kern(xs, W[:, :-1], U, b)                  # gate width
    with pytest.raises(ValueError):
        kern(xs[..., :2], W, U, b)                 # in vs W
    with pytest.raises(ValueError):
        kern(xs, W, U, b, reuse=7)                 # R does not divide G*h
    with pytest.raises(ValueError):
        kern(xs.to("meta"), W, U, b)               # no kernel for the device


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_launch_hands_the_layout_to_the_c_entry_point(cell, monkeypatch):
    xs, W, U, b = inputs(cell, B=256, T=4, fin=3, H=128)
    calls, asked = [], []

    def resident(c, bf16, reuse, lay):
        asked.append((c, bf16, reuse, lay))
        return sl.model_resident(lay)

    monkeypatch.setattr(cuda, "require", lambda *a, **k: xs.device)
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(sl, "card_resident", resident)
    sl.card_layout.cache_clear()
    try:
        out = sl.launch_scan(cell, xs, W, U, b, 4)
        n_asked = len(asked)
        sl.launch_scan(cell, xs, W, U, b, 4)
    finally:
        sl.card_layout.cache_clear()
    assert out.shape == (256, 128) and out.dtype == xs.dtype
    # the card is asked about every candidate once per shape, then the
    # layout is remembered
    assert n_asked == len(asked) > 0
    assert {a[:3] for a in asked} == {(cell, False, 4)}
    (lib, kernel, dev, *args), _ = calls
    assert (lib, kernel) == ("rnn_scan", f"{cell}_scan")
    # every C argument but the stream, which cuda.launch appends
    assert len(args) == len(cuda.SIGNATURES[lib][kernel][1]) - 1
    assert args[6:11] == [256, 4, 3, 128, 4]
    assert tuple(args[11:]) == tuple(sl.scan_layout(256, 128, 3, cell))[:5]


class FakeLibrary:
    def __init__(self, answer):
        self.answer, self.calls = answer, []

    def cluster_scan_resident(self, *args):
        self.calls.append(args)
        return self.answer

    def kernel_error_string(self, err):
        return b"invalid argument" if err == 1 else b"other"


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_card_resident_asks_the_c_library(cell, monkeypatch):
    lay = sl.scan_layout(256, 128, 3, cell)
    fake = FakeLibrary(37)
    monkeypatch.setattr(cuda, "library", lambda name: fake)
    assert sl.card_resident(cell, True, 4, lay) == 37
    assert fake.calls == [(int(cell == "gru"), 1, 4, *lay[:5])]
    assert len(fake.calls[0]) == len(
        cuda.SIGNATURES["rnn_scan"]["cluster_scan_resident"][1])
    fake.answer = -1                 # -cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="invalid argument"):
        sl.card_resident(cell, False, 1, lay)


@pytest.mark.parametrize("reuse", [1, 4])
@pytest.mark.parametrize("batch", [8, 9, 256])
@pytest.mark.parametrize("tag", sorted(TAGGERS))
def test_hoisted_layout_fits_the_card(tag, batch, reuse):
    """The layout of the cluster kernel's zx mode (both cells' hoisted
    and pipeline scans): no x side, zx buffers of [rows, G, u]
    in the shared memory (G from the cell), the same rules."""
    cell, H, fin, G = shapes(tag)
    B = padded(batch)
    R = SCHED.replace(reuse_factor=reuse).effective_reuse(G * H)
    lay = sl.scan_layout(B, H, fin, cell, R, hoisted=True)
    C, bt, ks, threads, smem, clusters = lay
    assert smem <= 232_448
    assert smem == sl.smem_bytes(cell, H, 0, C, ks, bt, hoisted=True)
    # the formula the kernel carves: 2 mbarriers | b_rec [u, 4] |
    # h [2, 16 k_split, h_stride] | zx [3, rows, G, u], f32
    u = sl.units_per_cta(H, C)
    assert smem == 4 * (4 + u * 4 + 2 * 16 * ks * sl.h_stride(bt)
                        + 3 * bt * G * u)
    owned = [j for units in owned_units(H, C) for j in units]
    assert sorted(owned) == list(range(H))
    assert ks in sl.K_SPLITS and ks * sl.MAX_K >= H
    assert threads % 32 == 0 and u * ks <= threads <= sl.MAX_THREADS
    assert clusters * bt >= B > (clusters - 1) * bt
    if B in (8, 256):
        assert clusters <= sl.model_resident(lay)
    if B <= 9:
        assert (bt, clusters) == (1, B)
    # fin plays no part in the hoisted layout
    assert sl.scan_layout(B, H, 0, cell, R, hoisted=True) == lay


def hoisted_inputs(B, T, H, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (t(rng.randn(B, T, 3 * H)), t(rng.randn(H, 3 * H) / 5),
            t(rng.randn(3 * H) * 0.1))


@pytest.mark.parametrize("hidden", [20, 120, 128, 256])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gru_scan_hoisted_routes_by_hidden(hidden, out_dtype, monkeypatch):
    """H <= MAX_CLUSTER_HIDDEN: the cluster entry point with its hoisted
    layout; past it the block kernel's entry point, counted as the same
    kernel."""
    B, T, R = 256, 4, 4
    zx, U, b_rec = hoisted_inputs(B, T, hidden)
    calls = []

    def launch(*args, **kw):
        calls.append((args, kw))

    monkeypatch.setattr(cuda, "require", lambda *a, **k: zx.device)
    monkeypatch.setattr(cuda, "launch", launch)
    monkeypatch.setattr(sl, "card_resident",
                        lambda c, bf16, reuse, lay, hoisted=False:
                        sl.model_resident(lay))
    sl.card_layout.cache_clear()
    try:
        out = sl.launch_hoisted_scan("gru_scan_hoisted", zx, U, b_rec, R,
                                     out_dtype)
    finally:
        sl.card_layout.cache_clear()
    assert out.shape == (B, hidden) and out.dtype == out_dtype
    (args, kw), = calls
    lib, fn, dev, *cargs = args
    bf16 = int(out_dtype == torch.bfloat16)
    assert len(cargs) == len(cuda.SIGNATURES[lib][fn][1]) - 1
    assert cargs[4:9] == [bf16, B, T, hidden, R]
    if hidden <= sl.MAX_CLUSTER_HIDDEN:
        assert (lib, fn, kw) == ("rnn_scan", "gru_scan_hoisted", {})
        lay = sl.scan_layout(B, hidden, 0, "gru", R, hoisted=True)
        assert tuple(cargs[9:]) == tuple(lay)[:5]
    else:
        assert (lib, fn) == ("rnn_scan", "gru_scan_hoisted_block")
        assert kw == {"count_as": "gru_scan_hoisted"}


def test_hoisted_residency_asks_the_zx_kernel(monkeypatch):
    lay = sl.scan_layout(256, 128, 0, "gru", hoisted=True)
    fake = FakeLibrary(37)
    asked = []
    fake.cluster_zx_scan_resident = lambda *a: asked.append(a) or 21
    monkeypatch.setattr(cuda, "library", lambda name: fake)
    assert sl.card_resident("gru", False, 4, lay, hoisted=True) == 21
    assert asked == [(1, 0, 4, *lay[:5])] and fake.calls == []
    assert len(asked[0]) == len(
        cuda.SIGNATURES["rnn_scan"]["cluster_zx_scan_resident"][1])


def zx_inputs(cell, B, T, H, seed=0):
    """zx [B, T, G*H], U [H, G*H] and the LSTM's b [4H] or the GRU's b_rec
    [3H], f32."""
    rng = np.random.RandomState(seed)
    G = 4 if cell == "lstm" else 3
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (t(rng.randn(B, T, G * H)), t(rng.randn(H, G * H) / 5),
            t(rng.randn(G * H) * 0.1))


def record_launches(monkeypatch, device):
    """Patch the launch path so that no card is needed: returns the list
    of (args, kwargs) of every ``cuda.launch`` and the list of residency
    questions (cell, bf16, reuse, layout, hoisted) the layout asked."""
    calls, asked = [], []

    def resident(c, bf16, reuse, lay, hoisted=False):
        asked.append((c, bf16, reuse, lay, hoisted))
        return sl.model_resident(lay)

    monkeypatch.setattr(cuda, "require", lambda *a, **k: device)
    monkeypatch.setattr(cuda, "launch",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(sl, "card_resident", resident)
    return calls, asked


@pytest.mark.parametrize("hidden", [20, 120, 128, 256])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["lstm_scan_hoisted", "lstm_scan_pipeline",
                                    "gru_scan_pipeline"])
def test_zx_scans_route_by_hidden(kernel, out_dtype, hidden, monkeypatch):
    """``lstm_scan_hoisted`` and both pipeline scans route as
    ``gru_scan_hoisted`` does: H <= MAX_CLUSTER_HIDDEN takes the cluster
    entry point with its hoisted layout (a pipeline's at R = 4 is its
    cell's hoisted scan's at R = 1, the one-pass instance it runs), a
    larger H the block kernel's ``_block`` entry point, counted as the
    kernel."""
    cell = kernel.split("_")[0]
    B, T, R = 256, 4, 4
    zx, U, b = zx_inputs(cell, B, T, hidden)
    calls, asked = record_launches(monkeypatch, zx.device)
    sl.card_layout.cache_clear()
    try:
        out = sl.launch_hoisted_scan(kernel, zx, U, b, R, out_dtype)
        if kernel.endswith("_pipeline"):
            sl.launch_hoisted_scan(f"{cell}_scan_hoisted", zx, U, b, 1,
                                   out_dtype)
    finally:
        sl.card_layout.cache_clear()
    assert out.shape == (B, hidden) and out.dtype == out_dtype
    (args, kw), *rest = calls
    lib, fn, dev, *cargs = args
    bf16 = int(out_dtype == torch.bfloat16)
    assert len(cargs) == len(cuda.SIGNATURES[lib][fn][1]) - 1
    assert cargs[4:9] == [bf16, B, T, hidden, R]
    if hidden <= sl.MAX_CLUSTER_HIDDEN:
        assert (lib, fn, kw) == ("rnn_scan", kernel, {})
        pipeline = kernel.endswith("_pipeline")
        lay = sl.scan_layout(B, hidden, 0, cell, 1 if pipeline else R,
                             hoisted=True)
        assert tuple(cargs[9:]) == tuple(lay)[:5]
        assert asked and all(a[:3] == (cell, bool(bf16), 1 if pipeline
                                       else R) and a[4] for a in asked)
        if pipeline:
            # the same layout as its cell's hoisted scan at R = 1, at the
            # same B
            (hargs, _), = rest
            assert (hargs[1] == f"{cell}_scan_hoisted"
                    and hargs[-5:] == args[-5:])
    else:
        assert (lib, fn) == ("rnn_scan", f"{kernel}_block")
        assert kw == {"count_as": kernel} and not asked


@pytest.mark.parametrize("kernel,cell_id,reuse_asked", [
    ("lstm_scan_hoisted", 0, 4), ("gru_scan_hoisted", 1, 4),
    ("lstm_scan_pipeline", 0, 1), ("gru_scan_pipeline", 1, 1)])
def test_zx_residency_asks_for_the_instance_that_runs(
        kernel, cell_id, reuse_asked, monkeypatch):
    """On the card the layout of a zx scan at R = 4 asks
    ``cluster_zx_scan_resident`` about the instance the launch runs: cell 0
    for the LSTM, and the one-pass instance (reuse 1) for a pipeline,
    which runs it at every R; never the in-loop kernel's query."""
    cell = kernel.split("_")[0]
    zx, U, b = zx_inputs(cell, 256, 4, 128)
    fake = FakeLibrary(37)
    asked = []
    fake.cluster_zx_scan_resident = lambda *a: asked.append(a) or 37
    calls = []
    monkeypatch.setattr(cuda, "library", lambda name: fake)
    monkeypatch.setattr(cuda, "require", lambda *a, **k: zx.device)
    monkeypatch.setattr(cuda, "launch",
                        lambda *a, **kw: calls.append((a, kw)))
    sl.card_layout.cache_clear()
    try:
        sl.launch_hoisted_scan(kernel, zx, U, b, 4, torch.bfloat16)
    finally:
        sl.card_layout.cache_clear()
    assert asked and fake.calls == []
    n_args = len(cuda.SIGNATURES["rnn_scan"]["cluster_zx_scan_resident"][1])
    for a in asked:
        assert len(a) == n_args and a[:3] == (cell_id, 1, reuse_asked)
    # every candidate layout was asked about, and the launch took one of
    # them
    ((_, fn, _, *cargs), _), = calls
    assert fn == kernel and tuple(cargs[-5:]) in {a[3:] for a in asked}
