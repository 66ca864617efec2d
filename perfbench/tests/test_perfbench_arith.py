"""The yardstick's counts against the numbers they were copied with."""

import json

from perfbench import arith
from perfbench.spec import HERE

QUICKDRAW, FLAVOR = (
    json.loads((HERE / "configs" / f"{n}.json").read_text())
    for n in ("quickdraw-lstm", "flavor-tagging-gru"))


def test_quickdraw_lstm_scan_counts_at_256():
    # chip_smoke.py's bound of row 1 (PERF.md's table of kernels)
    assert arith.rnn_flops(QUICKDRAW, 256) == 2.0 * 256 * 100 * 131 * 512
    assert round(arith.rnn_flops(QUICKDRAW, 256) / 1e6) == 3434
    assert arith.rnn_bytes(QUICKDRAW, 256) == 708_608
    assert abs(arith.rnn_bound_s(QUICKDRAW, 256) * 1e3 - 0.0513) < 5e-5


def test_model_flops_a_chunk():
    # 27.75 GFLOP for a QuickDraw chunk of 2048 events, the head included
    head = 2.0 * 2048 * (128 * 256 + 256 * 128 + 128 * 5)
    assert arith.head_flops(QUICKDRAW, 2048) == head
    assert abs(arith.model_flops(QUICKDRAW, 2048) - 2.7747e10) < 1e7
    # the GRU: 3 gates, the [2, 3H] bias read once
    assert arith.rnn_flops(FLAVOR, 1) == 2.0 * 15 * 126 * 360
    assert arith.rnn_bytes(FLAVOR, 1) == 4 * (90 + 6 * 360 + 120 * 360
                                              + 720 + 120)
