"""The decode tick's share of its memory roofline, in %: the least bytes
a tick must move (``perfbench/lm_arith.py``: the weights once, every
slot's SSM state and conv tail read and written, the new K / V written)
times the window's ticks over 3.35 TB/s, over the device's busy time in
the traced window.  The attention's reads of the cache are left out of
the floor on purpose, so the share cannot pass 100 %.  Nothing to read
without a device trace or for a configuration that is not such an LM."""

from perfbench.lm_arith import HBM_BPS, tick_floor_bytes


def read(win):
    if not win.device or "layer_types" not in win.cfg:
        return None
    floor = tick_floor_bytes(win.cfg, win.traffic["slots"])
    return win.calls * floor / HBM_BPS / win.busy_s() * 100
