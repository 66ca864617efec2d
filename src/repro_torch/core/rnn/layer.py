"""The recurrent layer: the paper's static / non-static schedules.

impl="pallas" (fp=None) routes the layer through the scheduled scan
(kernels/ops.py), which runs every mode of the schedule (static, nonstatic,
pipeline) on the CUDA kernels for a CUDA tensor.  impl="xla" runs the cells
of core/rnn/cells.py in a Python loop over time: in eager PyTorch the
static scan and the unrolled one-block-per-timestep form are the same loop,
so every mode shares it.  With ``schedule.hoist_input`` the cell loop
consumes zx = xs @ W precomputed for all timesteps.

``lengths`` selects the pad-and-mask ragged path; as in the JAX package it
runs on the cells for every impl.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import RNNConfig
from repro_torch.core.rnn.cells import gru_cell, initial_state, lstm_cell
from repro_torch.kernels.schedule import KernelSchedule


def require_float(fp) -> None:
    if fp is not None:
        raise NotImplementedError(
            "fixed-point (fp) datapaths are not ported yet (ROADMAP.md, "
            "modules to port, item 6); serve with fp=None")


def rnn_layer(
    rnn: RNNConfig,
    xs: torch.Tensor,                   # [b, T, in]
    W: torch.Tensor,
    U: torch.Tensor,
    b: torch.Tensor,
    *,
    fp=None,
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
    require_float(fp)
    schedule = schedule or rnn.kernel_schedule()
    if mode is not None and mode != schedule.mode:
        schedule = schedule.replace(mode=mode)
    cell = lstm_cell if rnn.cell == "lstm" else gru_cell
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

    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        scan = kops.lstm_scan if rnn.cell == "lstm" else kops.gru_scan
        return scan(xs, W, U, b, schedule=schedule)

    zx_all = None
    if schedule.hoist_input:
        dt = torch.promote_types(xs.dtype, W.dtype)
        zx_all = torch.einsum("btf,fg->btg", xs.to(dt), W.to(dt))
    for t in range(xs.shape[1]):
        zx = None if zx_all is None else zx_all[:, t]
        _, state = cell(xs[:, t], state, W, U, b, zx=zx)
    return state[0] if rnn.cell == "lstm" else state
