"""The model's share of the card's float32 peak, in %: the tagger's
products for the events answered (counted from the published shapes,
whatever the schedule) over the window's seconds times 67 TFLOP/s."""

from perfbench.arith import F32_PEAK, model_flops


def read(win):
    return model_flops(win.cfg, win.events) / (win.window_s * F32_PEAK) * 100
