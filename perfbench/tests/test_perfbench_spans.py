"""The span metrics, ``idle_by_span`` and the clock check on windows of
known program spans and device intervals; a window on the CPU with the
program's recording on; and one short traced window on the card."""

import dataclasses

import numpy as np
import pytest

from perfbench import spans, spec
from perfbench.spans import SpanWindow, brackets, idle_by_span
from repro_torch.tracing import Span

CELL = spec.resolve("quickdraw-lstm.bulk")
SCAN = "void cluster_scan_kernel<0, false, float, float, 8, 8, true>(...)"
#: one request's spans, ns from its harness span's start: (name, start,
#: end, parent)
TREE = [("engine.predict", 10, 990, -1), ("engine.stage", 100, 150, 0),
        ("engine.h2d", 150, 300, 0), ("model.forward", 310, 600, 0),
        ("rnn.scan", 320, 400, 3), ("model.head", 400, 600, 3),
        ("engine.d2h", 620, 980, 0)]
#: its device operations
OPS = [("Memcpy HtoD (Pageable -> Device)", "memcpy", 160, 290),
       (SCAN, "kernel", 330, 700), ("col_matmul_kernel", "kernel", 700, 720),
       ("Memcpy DtoH (Device -> Pageable)", "memcpy", 900, 970)]
STARTS = [0, 1100]                      # two calls of 1000 ns


def window(shift=0, late=0, with_spans=True, device=True):
    """Two calls; the program's spans moved by ``shift``; the second
    call's device operations stamped ``late`` ns late.  Each operation was
    issued 5 ns into its call's root span."""
    spans_, dev, issued = [], [], []
    for k, c in enumerate(STARTS):
        base = len(spans_)
        for name, s, e, parent in TREE:
            counters = {"rows": 2048, "launches": 4, "builds": k} \
                if parent < 0 else {}
            spans_.append(Span(name, c + s + shift, c + e + shift,
                               parent if parent < 0 else base + parent, k,
                               counters))
        for name, kind, s, e in OPS:
            dev.append((name, kind, c + s + k * late, c + e + k * late))
            issued.append(c + 15 + shift)
    starts = np.array(STARTS, np.int64)
    return SpanWindow(CELL.cfg, CELL.traffic, starts, starts + 1000, 2048,
                      7.5, device, dev if device else [],
                      spans=spans_ if with_spans else [],
                      issued=issued if device else [])


def read(name, win):
    return spec.reader(name).read(win)


def test_span_readers():
    win = window()
    assert read("engine_self_us.bulk", win) == pytest.approx(
        (980 - 50 - 150 - 290 - 360) * 1e-3)
    assert read("input_host_ms.bulk", win) == pytest.approx(200e-6)
    assert read("launch_host_ms.bulk", win) == pytest.approx(290e-6)
    assert read("output_wait_ms.bulk", win) == pytest.approx(360e-6)
    assert read("launches_per_call.bulk", win) == 4
    assert read("rebuilds.bulk", win) == 1
    assert set(spans.read_span_metrics(win)) == set(spans.METRICS)
    assert spans.outside_calls(win) == {"outside": 0, "worst_us": 0.0}
    assert spans.span_medians(win) == pytest.approx({
        "engine (self)": 0.13, "engine.stage": 0.05, "engine.h2d": 0.15,
        "model.forward": 0.29, "rnn.scan": 0.08, "model.head": 0.2,
        "engine.d2h": 0.36})


@pytest.mark.parametrize("case", ["no spans", "the parent's Window"])
def test_nothing_to_read(case):
    win = window(with_spans=False)
    if case == "the parent's Window":
        win = spans.Window(CELL.cfg, CELL.traffic, win.starts, win.ends,
                           2048, 7.5, True, win.device)
    for name in spans.METRICS:
        assert read(name, win) is None
    assert spans.read_span_metrics(win) == {}
    assert brackets(win) is None
    assert idle_by_span(win) == [["harness", pytest.approx(
        win.window_s - win.busy_s())]]


def test_idle_by_span_adds_up_with_the_busy_time():
    win = window()
    idle = dict(idle_by_span(win))
    want = {"harness": 140, "engine.d2h": 380, "engine.predict": 220,
            "engine.stage": 100, "engine.h2d": 40, "model.forward": 20,
            "rnn.scan": 20}
    assert idle == {k: pytest.approx(v * 1e-9) for k, v in want.items()}
    assert sum(idle.values()) + win.busy_s() == pytest.approx(win.window_s)


def test_brackets_hold():
    got = brackets(window())
    assert got == {"ops": 8, "breaches": 0, "worst_us": 0.0,
                   "shift_us": [pytest.approx(-0.01), pytest.approx(0.01)],
                   "calls_moved": 0, "moved_max_us": 0.0,
                   "breaches_after": 0, "calls_unmended": 0}


@pytest.mark.parametrize("shift, late, want", [
    # the spans 30 ns late against every device stamp: each call's copy
    # in and scan start before their spans; moving the spans back 20 ns
    # (the least of 20-40) mends every bracket
    (30, 0, {"breaches": 4, "worst_us": 0.02, "shift_us": [-0.04, -0.02],
             "calls_moved": 2, "moved_max_us": 0.02}),
    # the second call's device stamps 25 ns late (a device clock that
    # drifts): its copy back ends 15 ns after its span; no one shift of
    # every span mends both calls, moving the second call's 15 ns does
    (0, 25, {"breaches": 1, "worst_us": 0.015, "shift_us": [0.015, 0.01],
             "calls_moved": 1, "moved_max_us": 0.015}),
])
def test_brackets_broken(shift, late, want):
    win = window(shift=shift, late=late)
    got = brackets(win)
    assert got == {"ops": 8, "breaches_after": 0, "calls_unmended": 0,
                   **{k: pytest.approx(v) for k, v in want.items()}}
    drift = spans.bracket_drift(win, slices=2)
    assert [d[0] for d in drift] == pytest.approx(
        [(-10 - shift) * 1e-3, (-10 - shift + late) * 1e-3])
    # the moved stamps keep the busy time and re-split the idle time
    moved = dataclasses.replace(win, device=spans.aligned(win))
    assert moved.busy_s() == pytest.approx(win.busy_s())
    assert brackets(moved)["breaches"] == 0


def test_operations_belong_to_the_call_that_issued_them():
    win = window()
    assert spans.op_calls(win).tolist() == [0] * 4 + [1] * 4
    # stamps the trace could not link, or outside every request, pair
    # with none
    issued = list(win.issued)
    issued[0], issued[5] = None, 1050
    odd = dataclasses.replace(win, issued=issued)
    assert spans.op_calls(odd).tolist() == [-1, 0, 0, 0, 1, -1, 1, 1]
    assert brackets(odd)["ops"] == 6


def small_cell():
    t = dict(CELL.traffic, events_per_call=16, pool_events=64,
             check_calls=2)
    return dataclasses.replace(CELL, traffic=t)


@pytest.mark.parametrize("tracer", [True, False])
def test_a_recorded_window_on_the_cpu(monkeypatch, tracer):
    import torch

    if not tracer:                      # a program older than its tracer
        monkeypatch.setattr(spans, "program_tracing", lambda: None)
    r = spans.run_traced(small_cell(), 2**31 + 5, 0.3, torch.device("cpu"),
                         profile=False)
    assert r["correct"], r["metrics"]
    m = r["metrics"]
    if not tracer:
        assert not set(m) & set(spans.METRICS)
        assert r["roots_outside_calls"] is None
        return
    assert set(spans.METRICS) <= set(m)
    assert m["launches_per_call.bulk"]["value"] == 0     # no card
    assert m["rebuilds.bulk"]["value"] == 0
    assert r["roots_outside_calls"]["outside"] == 0
    assert {"engine (self)", "model.forward", "engine.d2h"} <= \
        set(r["span_p50_us"])


def test_a_call_whose_device_clock_jumps_stays_unmended():
    win = window()
    dev = list(win.device)
    name, kind, s, e = dev[7]                   # the second copy back,
    dev[7] = (name, kind, s + 200, e + 200)     # stamped 200 ns late
    got = brackets(dataclasses.replace(win, device=dev))
    # the middle of its empty range leaves its copy in, scan and copy back
    assert (got["breaches_after"], got["calls_unmended"]) == (3, 1)


@pytest.mark.card
def test_a_traced_window_on_the_card(card):
    r = spans.run_traced(CELL, 2**31 + 11, 3.0, card)
    assert r["correct"]
    for name in spans.METRICS:
        assert r["metrics"][name]["value"] is not None, name
    assert r["metrics"]["launches_per_call.bulk"]["value"] == 4
    assert r["metrics"]["rebuilds.bulk"]["value"] == 0
    assert r["roots_outside_calls"]["outside"] == 0
    # every copy and kernel is tied to its call; the device clock may
    # drift against the host (PERF.md §6), but a breach the per-call mend
    # leaves must fall in a call the clock jumped inside, rare in a window
    b = r["brackets"]
    assert b["ops"] == 14 * r["attempted"], b
    assert b["calls_unmended"] <= r["attempted"] // 100, b
    assert sum(v for _, v in r["breakdown"]["idle_by_span"]) > 0
