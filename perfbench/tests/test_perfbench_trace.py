"""The readers on a window of known spans and device intervals."""

import numpy as np

from perfbench import arith, spec
from perfbench.trace import Window, breakdown, merge

CFG = spec.resolve("quickdraw-lstm.bulk").cfg
SCAN = "void cluster_scan_kernel<0, false, float, float, 8, 32, false>(...)"


def window(device, traced=True):
    # three calls of 100 ns, 20 ns apart
    starts = np.array([0, 120, 240], np.int64)
    return Window(CFG, {}, starts, starts + 100, 2048, 7.5, traced, device)


def read(name, win):
    return spec.reader(name).read(win)


def test_merge():
    assert merge([(5, 9), (0, 3), (2, 4), (9, 10)]).tolist() == \
        [[0, 4], [5, 10]]
    assert merge([]).shape == (0, 2)


def test_readers():
    dev = [("Memcpy HtoD (Pageable -> Device)", "memcpy", 10, 30),
           (SCAN, "kernel", 30, 80), ("col_matmul_kernel", "kernel", 85, 90),
           (SCAN, "kernel", 150, 200), ("col_matmul_kernel", "kernel", 195,
                                        205)]
    win = window(dev)
    assert abs(win.busy_s() - (70 + 5 + 55) * 1e-9) < 1e-18
    assert read("kernels_per_call.bulk", win) == 4 / 3
    host = (300 - 130) / 3
    assert abs(read("engine_host_ms.bulk", win) - host * 1e-6) < 1e-12
    assert abs(read("engine_host_us.trigger", win) - host * 1e-3) < 1e-9
    assert abs(read("device_idle.bulk", win) - (1 - 130 / 340) * 100) < 1e-9
    share = 3 * arith.rnn_bound_s(CFG, 2048) / 100e-9 * 100
    assert abs(read("scan_roofline.bulk", win) / share - 1) < 1e-12
    assert abs(read("events_per_s", win) / (3 * 2048 / 340e-9) - 1) < 1e-12
    assert read("setup_s", win) == 7.5
    b = breakdown(win)
    assert b["device_ops"][0][0].startswith("cluster_scan_kernel<0, false")
    idle = dict(b["idle_gaps"])
    assert abs(sum(idle.values()) + win.busy_s() - win.window_s) < 1e-15
    assert idle["harness between calls"] == 40e-9
    assert idle["host before a call's first device op"] == (10 + 30 + 100) \
        * 1e-9


def test_nothing_to_read():
    win = window([("col_matmul_kernel", "kernel", 5, 9)])
    assert read("scan_roofline.bulk", win) is None
    untraced = window([], traced=False)
    for name in ("engine_host_ms.bulk", "kernels_per_call.bulk",
                 "device_idle.bulk"):
        assert read(name, untraced) is None
