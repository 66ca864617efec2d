"""The recurrent layer: the paper's static / non-static schedules.

impl="pallas" routes the layer through the scheduled scan
(kernels/ops.py) for the float datapath (fp=None) and for the native
int8/int4 configs (``is_native_int``): every mode of the schedule on the
CUDA kernels for a CUDA tensor.  Emulated fixed-point configs (wider words,
trn, wrap) stay on the quantized cells below, as in the JAX package:
emulation IS the reference datapath, there is no kernel for it.

impl="xla" runs the cells of core/rnn/cells.py in a Python loop over time:
in eager PyTorch the static scan and the unrolled one-block-per-timestep
form are the same loop, so every mode shares it.  With
``schedule.hoist_input`` the float cell loop consumes zx = xs @ W
precomputed for all timesteps; quantized paths never hoist (splitting
z = q(xW + hU + b) would move the hls4ml quantization points).

``lengths`` selects the pad-and-mask ragged path; as in the JAX package it
runs on the cells (float or quantized) for every impl.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import FixedPointConfig, RNNConfig
from repro_torch.core.quant.fixed_point import is_native_int
from repro_torch.core.rnn.cells import (gru_cell, gru_cell_quantized,
                                        initial_state, lstm_cell,
                                        lstm_cell_quantized)
from repro_torch.kernels.ref import matmul
from repro_torch.kernels.schedule import KernelSchedule


def _cell_fn(cell: str, fp: Optional[FixedPointConfig]):
    if cell == "lstm":
        if fp is None:
            return lstm_cell
        return lambda x, s, W, U, b: lstm_cell_quantized(x, s, W, U, b, fp)
    if fp is None:
        return gru_cell
    return lambda x, s, W, U, b: gru_cell_quantized(x, s, W, U, b, fp)


def rnn_layer(
    rnn: RNNConfig,
    xs: torch.Tensor,                   # [b, T, in]
    W: torch.Tensor,
    U: torch.Tensor,
    b: torch.Tensor,
    *,
    fp: Optional[FixedPointConfig] = None,
    mode: Optional[str] = None,
    impl: str = "xla",
    schedule: Optional[KernelSchedule] = None,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the recurrent layer; returns the final hidden state [b, h].

    The schedule is the ``schedule`` argument, else the config's
    ``rnn.kernel_schedule()``; an explicit ``mode`` overrides its mode.
    ``lengths`` [b] freezes row i's state once t >= lengths[i].
    """
    schedule = schedule or rnn.kernel_schedule()
    if mode is not None and mode != schedule.mode:
        schedule = schedule.replace(mode=mode)
    cell = _cell_fn(rnn.cell, fp)
    state = initial_state(rnn.cell, xs.shape[0], rnn.hidden, xs.dtype,
                          xs.device)

    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=xs.device)
        for t in range(xs.shape[1]):
            _, new = cell(xs[:, t], state, W, U, b)
            keep = (t < lengths)[:, None]
            if rnn.cell == "lstm":
                state = (torch.where(keep, new[0], state[0]),
                         torch.where(keep, new[1], state[1]))
            else:
                state = torch.where(keep, new, state)
        return state[0] if rnn.cell == "lstm" else state

    if impl == "pallas" and (fp is None or is_native_int(fp)):
        from repro_torch.kernels import ops as kops

        scan = kops.lstm_scan if rnn.cell == "lstm" else kops.gru_scan
        return scan(xs, W, U, b, schedule=schedule, fp=fp)

    zx_all = None
    if schedule.hoist_input and fp is None:
        zx_all = matmul(xs, W)
    for t in range(xs.shape[1]):
        if zx_all is None:
            _, state = cell(xs[:, t], state, W, U, b)
        else:
            _, state = cell(xs[:, t], state, W, U, b, zx=zx_all[:, t])
    return state[0] if rnn.cell == "lstm" else state
