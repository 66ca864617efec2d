"""The LM's share of the card's bfloat16 peak, in %: the model's products
for the tokens answered (2 x the published parameter count a token,
``perfbench/lm_arith.py``) over the window's seconds times 989 TFLOP/s.
The whole step's share.  Nothing to read for a configuration that is not
such an LM."""

from perfbench.lm_arith import BF16_PEAK, flops_per_token


def read(win):
    if "layer_types" not in win.cfg:
        return None
    return (flops_per_token(win.cfg) * win.events
            / (win.window_s * BF16_PEAK) * 100)
