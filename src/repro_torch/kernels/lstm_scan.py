"""LSTM scan: the CUDA kernels' wrappers and plain versions.

Replaces ``repro/kernels/lstm_scan.py``'s ``lstm_scan_pallas``,
``lstm_scan_hoisted_pallas`` and ``lstm_scan_pipeline_pallas``.  The kernels
live in ``csrc/rnn_scan.cu`` (its header says what bounds them on an H100
and how the design answers); all three run on the thread-block-cluster
kernel (the hoisted and pipeline ones on its zx mode) at a layout from
``kernels/scan_layout.py``, for h up to ``MAX_CLUSTER_HIDDEN``; past it
the in-loop function runs as ``col_matmul`` and the hoisted kernel
(:func:`lstm_scan_composed`), and the hoisted and pipeline kernels on the
block kernel (``lstm_scan_hoisted_block``, ``lstm_scan_pipeline_block``).
The pipeline kernel computes the hoisted kernel's function with its R
column tiles issued together: it runs the hoisted kernel's R = 1 instance
and layout at every R, and column tiles change no column's arithmetic, so
both share one plain version.

Each wrapper takes the tensor's device as the dispatch: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version beside
it, which repeats the kernel's R-tiled arithmetic in PyTorch: per step, R
column tiles of ``z = (x_t W + h U) + b`` (hoisted: ``(zx_t + h U) + b``),
then the i|f|c|o gate update.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.reuse_matmul import col_matmul_kernel
from repro_torch.kernels.scan_layout import (launch_hoisted_scan, launch_scan,
                                             scan_route)


def _gate_update(z: torch.Tensor, c: torch.Tensor, hidden: int):
    """z: [bt, 4h] pre-activations, c: [bt, h] -> (h_new, c_new)."""
    i = torch.sigmoid(z[:, :hidden])
    f = torch.sigmoid(z[:, hidden:2 * hidden])
    g = torch.tanh(z[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(z[:, 3 * hidden:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _plain_scan(zx_fn, U, b, B, T, reuse, out_dtype, device):
    """The R-tiled recurrence; ``zx_fn(t, cols)`` gives the input-side
    pre-activation of tile ``cols`` at step t."""
    hidden = U.shape[0]
    gw = (4 * hidden) // reuse
    h = torch.zeros(B, hidden, dtype=torch.float32, device=device)
    c = torch.zeros_like(h)
    for t in range(T):
        tiles = []
        for r in range(reuse):
            cols = slice(r * gw, (r + 1) * gw)
            tiles.append((zx_fn(t, cols) + h @ U[:, cols]) + b[cols])
        h, c = _gate_update(torch.cat(tiles, dim=-1), c, hidden)
    return h.to(out_dtype)


def lstm_scan_plain(xs, W, U, b, *, reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`lstm_scan_kernel`."""
    B, T, _ = xs.shape
    x32 = xs.float()
    return _plain_scan(lambda t, cols: x32[:, t] @ W[:, cols], U, b, B, T,
                       reuse, xs.dtype, xs.device)


def lstm_scan_hoisted_plain(zx, U, b, *, reuse: int = 1,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`lstm_scan_hoisted_kernel`."""
    B, T, _ = zx.shape
    return _plain_scan(lambda t, cols: zx[:, t, cols], U, b, B, T, reuse,
                       out_dtype, zx.device)


def _check_shapes(kernel, hidden, reuse, U, b, gates_in=None):
    if U.shape != (hidden, 4 * hidden) or b.shape != (4 * hidden,):
        raise ValueError(f"{kernel}: U {tuple(U.shape)} / b {tuple(b.shape)}"
                         f" do not fit hidden={hidden}")
    if gates_in is not None and gates_in != 4 * hidden:
        raise ValueError(f"{kernel}: gate width {gates_in} != 4h = "
                         f"{4 * hidden}")
    if reuse < 1 or (4 * hidden) % reuse:
        raise ValueError(f"{kernel}: reuse {reuse} does not divide 4h = "
                         f"{4 * hidden}")


def lstm_scan_kernel(xs: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
                     b: torch.Tensor, *, reuse: int = 1) -> torch.Tensor:
    """xs: [B, T, in] f32|bf16; W: [in, 4h], U: [h, 4h], b: [4h] f32
    -> final h [B, h] in xs's dtype.  ``reuse`` must divide 4h.  On the
    card :func:`~repro_torch.kernels.scan_layout.scan_route` picks the path:
    the cluster kernel at
    :func:`~repro_torch.kernels.scan_layout.card_layout`'s layout for h up
    to ``MAX_CLUSTER_HIDDEN`` (U in registers), else
    :func:`lstm_scan_composed`."""
    hidden = U.shape[0]
    _check_shapes("lstm_scan", hidden, reuse, U, b, W.shape[-1])
    if W.shape[0] != xs.shape[-1]:
        raise ValueError(f"lstm_scan: W {tuple(W.shape)} vs xs "
                         f"{tuple(xs.shape)}")
    if xs.device.type == "cpu":
        return lstm_scan_plain(xs, W, U, b, reuse=reuse)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_scan: no kernel for device {xs.device}")
    if scan_route(hidden) == "cluster":
        return launch_scan("lstm", xs, W, U, b, reuse)
    return lstm_scan_composed(xs, W, U, b, reuse=reuse)


def lstm_scan_composed(xs, W, U, b, *, reuse: int = 1) -> torch.Tensor:
    """The in-loop function as two kernels, the route past the cluster
    kernel's h: the input side of every step as one ``col_matmul`` of
    ``xs`` [B*T, in] (widened to f32, exact) by W at the same R, then
    ``lstm_scan_hoisted`` on that zx: ``(x_t W + h U) + b`` tile by tile,
    with only x W summed in another order.  On CPU tensors both wrappers
    run their plain versions."""
    B, T, fin = xs.shape
    zx = col_matmul_kernel(xs.float().reshape(B * T, fin), W, reuse=reuse)
    return lstm_scan_hoisted_kernel(zx.reshape(B, T, -1), U, b, reuse=reuse,
                                    out_dtype=xs.dtype)


def _hoisted(kernel: str, zx, U, b, reuse, out_dtype) -> torch.Tensor:
    """Wrapper of the two kernels that take zx precomputed: a CUDA tensor
    goes to :func:`~repro_torch.kernels.scan_layout.launch_hoisted_scan`,
    which routes by H."""
    hidden = U.shape[0]
    _check_shapes(kernel, hidden, reuse, U, b, zx.shape[-1])
    if zx.device.type == "cpu":
        return lstm_scan_hoisted_plain(zx, U, b, reuse=reuse,
                                       out_dtype=out_dtype)
    if zx.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {zx.device}")
    return launch_hoisted_scan(kernel, zx, U, b, reuse, out_dtype)



def lstm_scan_hoisted_kernel(zx: torch.Tensor, U: torch.Tensor,
                             b: torch.Tensor, *, reuse: int = 1,
                             out_dtype=torch.float32) -> torch.Tensor:
    """zx: [B, T, 4h] f32 precomputed x W (no bias); U: [h, 4h], b: [4h] f32
    -> final h [B, h] in ``out_dtype`` (float32 or bfloat16)."""
    return _hoisted("lstm_scan_hoisted", zx, U, b, reuse, out_dtype)


def lstm_scan_pipeline_kernel(zx: torch.Tensor, U: torch.Tensor,
                              b: torch.Tensor, *, reuse: int = 1,
                              out_dtype=torch.float32) -> torch.Tensor:
    """The pipeline schedule's scan: arguments and result as
    :func:`lstm_scan_hoisted_kernel`, the R column tiles of each step's
    h U issued together (a chain of T steps, not T*R).  Up to
    ``MAX_CLUSTER_HIDDEN`` it is the hoisted kernel at R = 1 on the card,
    bit for bit, at every R."""
    return _hoisted("lstm_scan_pipeline", zx, U, b, reuse, out_dtype)


#: plain version of :func:`lstm_scan_pipeline_kernel` (the same function)
lstm_scan_pipeline_plain = lstm_scan_hoisted_plain
