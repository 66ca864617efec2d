"""Non-static mode across ranks: sequence-pipelined RNN inference.

The port of ``repro/core/rnn/pipeline.py``, on ``torch.distributed``.  The
paper's non-static mode instantiates one RNN block per timestep and passes
state block to block; here timestep GROUPS map to the ranks of a process
group: rank k owns timesteps [k*spp, (k+1)*spp), and its recurrent state
moves to rank k+1 after every beat.  A software-pipeline schedule streams
the B inferences through the P stages in B + P - 1 beats (at beat j rank k
runs inference j - k, when there is one); rank 0 starts every inference
from zeros, the last rank emits the finished hidden state, and the outputs
are summed to every rank (``all_reduce``).  The blocks run the port's
``core/rnn/cells.py`` cells one timestep at a time, as ``repro``'s
``lax.scan`` does (``zx=`` when the input projection is hoisted).

The state moves with ``batch_isend_irecv`` (rank k posts its send to k+1
and its receive from k-1 together, so no rank waits on a blocking send).
Gloo sends host tensors only, and NCCL refuses two ranks on one card: so
on a gloo group the state and the outputs are staged through host memory
explicitly (``_host``) while the blocks still compute on the caller's
device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.config import RNNConfig
from repro_torch.core.rnn.cells import gru_cell, lstm_cell


def _host(group) -> bool:
    """Whether the group's backend needs host tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def _shift_right(state: torch.Tensor, k: int, n_stages: int, group,
                 host: bool) -> torch.Tensor:
    """Send ``state`` to rank k+1 and receive rank k-1's (zeros on rank
    0, as ``ppermute`` leaves a rank nothing sends to)."""
    send = state.cpu() if host else state.contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if k < n_stages - 1:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, k + 1)
                              if group is not None else k + 1, group))
    if k > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, k - 1)
                              if group is not None else k - 1, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(state.device)


def pipelined_rnn(rnn: RNNConfig, xs: torch.Tensor, W: torch.Tensor,
                  U: torch.Tensor, b: torch.Tensor, *, group=None,
                  hoist_input: bool = False) -> torch.Tensor:
    """Final hidden state [B, hidden] of the tagger's RNN layer over xs
    [B, T, F] (the whole input on every rank), pipelined over the ranks of
    ``group`` (the default group when None); T must divide the group size.

    ``hoist_input`` is the multi-rank face of the hoisted-projection
    schedule: zx = xs @ W for ALL timesteps is one product before the
    stage pipeline (f32 accumulation, rounded to xs's dtype, as
    ``repro``'s einsum with ``preferred_element_type``), so each block
    carries only the hU recurrence."""
    B, T, F = xs.shape
    n_stages = dist.get_world_size(group)
    k = dist.get_rank(group)
    if T % n_stages:
        raise ValueError(f"pipelined_rnn: T={T} % stages={n_stages}")
    spp = T // n_stages
    H = rnn.hidden
    cell = lstm_cell if rnn.cell == "lstm" else gru_cell
    n_state = 2 if rnn.cell == "lstm" else 1
    host = _host(group)

    if hoist_input:
        xs = torch.einsum("btf,fg->btg", xs.float(), W.float()).to(xs.dtype)
    xs_local = xs[:, k * spp:(k + 1) * spp]

    def run_block(x_blk: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        # x_blk: [1, spp, F]; state: [n_state, 1, H]
        s = (state[0], state[1]) if n_state == 2 else state[0]
        for t in range(spp):
            x_t = x_blk[:, t]
            _, s = cell(x_t, s, W, U, b,
                        **({"zx": x_t} if hoist_input else {}))
        return torch.stack(s if n_state == 2 else (s,))

    out = torch.zeros((B, H), dtype=xs.dtype, device=xs.device)
    state_in = torch.zeros((n_state, 1, H), dtype=xs.dtype, device=xs.device)
    for j in range(B + n_stages - 1):
        i = j - k                                   # inference handled now
        if 0 <= i < B:
            boundary = torch.zeros_like(state_in) if k == 0 else state_in
            state_out = run_block(xs_local[i:i + 1], boundary)
            if k == n_stages - 1:                   # the last stage emits
                out[i] = state_out[0, 0]
        else:
            state_out = torch.zeros_like(state_in)
        state_in = _shift_right(state_out, k, n_stages, group, host)
    # outputs live on the last stage; share them with everyone
    if k != n_stages - 1:
        out = torch.zeros_like(out)
    share = out.cpu() if host else out
    dist.all_reduce(share, group=group)
    return share.to(xs.device)
