"""GRU (reset_after) scan: the CUDA kernels' wrappers and plain versions.

Replaces ``repro/kernels/gru_scan.py``'s ``gru_scan_pallas``,
``gru_scan_hoisted_pallas`` and ``gru_scan_pipeline_pallas``.  The kernels
live in ``csrc/rnn_scan.cu``: all three on the thread-block-cluster kernel
(the hoisted and pipeline ones on its zx mode) at a layout from
``kernels/scan_layout.py``, for h up to ``MAX_CLUSTER_HIDDEN``; past it
the in-loop function runs as ``col_matmul`` and the hoisted scan
(:func:`gru_scan_composed`), and the hoisted and pipeline scans on the
block kernel.  The pipeline kernel computes the hoisted kernel's function
with its R column tiles issued together (on the cluster kernel: its
one-pass instance, so at every R it gives the hoisted scan's R = 1 bits),
so both share one plain version.

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, which repeats the kernel's R-tiled arithmetic: per step, R column
tiles of ``zx = x_t W + b_in`` (hoisted: precomputed) and
``zh = h U + b_rec``, then ``hh = tanh(zx_h + r * zh_h)`` and
``h = z * h + (1 - z) * hh``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import matmul, sigmoid
from repro_torch.kernels.reuse_matmul import col_matmul_kernel
from repro_torch.kernels.scan_layout import (launch_hoisted_scan, launch_scan,
                                             scan_route)


def _gate_update(zx: torch.Tensor, zh: torch.Tensor, h: torch.Tensor,
                 hidden: int) -> torch.Tensor:
    """zx, zh: [bt, 3h] input-/recurrent-side pre-activations (z|r|hh),
    h: [bt, h] -> h_new."""
    z = sigmoid(zx[:, :hidden] + zh[:, :hidden])
    rg = sigmoid(zx[:, hidden:2 * hidden] + zh[:, hidden:2 * hidden])
    hh = torch.tanh(zx[:, 2 * hidden:] + rg * zh[:, 2 * hidden:])
    return z * h + (1.0 - z) * hh


def _plain_scan(zx_fn, U, b_rec, B, T, reuse, out_dtype, device):
    """The R-tiled recurrence; ``zx_fn(t, cols)`` gives the input-side
    pre-activation (b_in included) of tile ``cols`` at step t."""
    hidden = U.shape[0]
    gw = (3 * hidden) // reuse
    h = torch.zeros(B, hidden, dtype=torch.float32, device=device)
    for t in range(T):
        zx, zh = [], []
        for r in range(reuse):
            cols = slice(r * gw, (r + 1) * gw)
            zx.append(zx_fn(t, cols))
            zh.append(matmul(h, U[:, cols]) + b_rec[cols])
        h = _gate_update(torch.cat(zx, dim=-1), torch.cat(zh, dim=-1), h,
                         hidden)
    return h.to(out_dtype)


def gru_scan_plain(xs, W, U, b, *, reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`gru_scan_kernel`."""
    B, T, _ = xs.shape
    x32 = xs.float()
    return _plain_scan(lambda t, cols: matmul(x32[:, t], W[:, cols])
                       + b[0, cols],
                       U, b[1], B, T, reuse, xs.dtype, xs.device)


def gru_scan_hoisted_plain(zx, U, b_rec, *, reuse: int = 1,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`gru_scan_hoisted_kernel`."""
    B, T, _ = zx.shape
    return _plain_scan(lambda t, cols: zx[:, t, cols], U, b_rec, B, T, reuse,
                       out_dtype, zx.device)


def _check_shapes(kernel, hidden, reuse, U, gates_in):
    if U.shape != (hidden, 3 * hidden) or gates_in != 3 * hidden:
        raise ValueError(f"{kernel}: U {tuple(U.shape)} / gate width "
                         f"{gates_in} do not fit hidden={hidden}")
    if reuse < 1 or (3 * hidden) % reuse:
        raise ValueError(f"{kernel}: reuse {reuse} does not divide 3h = "
                         f"{3 * hidden}")


def gru_scan_kernel(xs: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
                    b: torch.Tensor, *, reuse: int = 1) -> torch.Tensor:
    """xs: [B, T, in] f32|bf16; W: [in, 3h], U: [h, 3h], b: [2, 3h] f32
    -> final h [B, h] in xs's dtype.  ``reuse`` must divide 3h.  On the
    card :func:`~repro_torch.kernels.scan_layout.scan_route` picks the path:
    the cluster kernel at
    :func:`~repro_torch.kernels.scan_layout.card_layout`'s layout for h up
    to ``MAX_CLUSTER_HIDDEN`` (U in registers), else
    :func:`gru_scan_composed`."""
    hidden = U.shape[0]
    _check_shapes("gru_scan", hidden, reuse, U, W.shape[-1])
    if W.shape[0] != xs.shape[-1] or b.shape != (2, 3 * hidden):
        raise ValueError(f"gru_scan: W {tuple(W.shape)} / b {tuple(b.shape)}"
                         f" vs xs {tuple(xs.shape)}")
    if xs.device.type == "cpu":
        return gru_scan_plain(xs, W, U, b, reuse=reuse)
    if xs.device.type != "cuda":
        raise ValueError(f"gru_scan: no kernel for device {xs.device}")
    if scan_route(hidden) == "cluster":
        return launch_scan("gru", xs, W, U, b, reuse)
    return gru_scan_composed(xs, W, U, b, reuse=reuse)


def gru_scan_composed(xs, W, U, b, *, reuse: int = 1) -> torch.Tensor:
    """The in-loop function as two kernels, the route past the cluster
    kernel's h: the input side of every step as one ``col_matmul`` of
    ``xs`` [B*T, in] (widened to f32, exact) by W at the same R, plus b_in,
    then ``gru_scan_hoisted`` on that zx with b_rec: the in-loop gates tile
    by tile, with only x W summed in another order.  On CPU tensors both
    wrappers run their plain versions."""
    B, T, fin = xs.shape
    zx = col_matmul_kernel(xs.float().reshape(B * T, fin), W, reuse=reuse)
    return gru_scan_hoisted_kernel((zx + b[0]).reshape(B, T, -1), U,
                                   b[1].contiguous(), reuse=reuse,
                                   out_dtype=xs.dtype)


def _hoisted(kernel: str, zx, U, b_rec, reuse, out_dtype) -> torch.Tensor:
    """Wrapper of the two kernels that take zx precomputed: a CUDA tensor
    goes to :func:`~repro_torch.kernels.scan_layout.launch_hoisted_scan`,
    which routes by H."""
    hidden = U.shape[0]
    _check_shapes(kernel, hidden, reuse, U, zx.shape[-1])
    if b_rec.shape != (3 * hidden,):
        raise ValueError(f"{kernel}: b_rec {tuple(b_rec.shape)}")
    if zx.device.type == "cpu":
        return gru_scan_hoisted_plain(zx, U, b_rec, reuse=reuse,
                                      out_dtype=out_dtype)
    if zx.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {zx.device}")
    return launch_hoisted_scan(kernel, zx, U, b_rec, reuse, out_dtype)



def gru_scan_hoisted_kernel(zx: torch.Tensor, U: torch.Tensor,
                            b_rec: torch.Tensor, *, reuse: int = 1,
                            out_dtype=torch.float32) -> torch.Tensor:
    """zx: [B, T, 3h] f32 precomputed x W + b_in; U: [h, 3h]; b_rec: [3h]
    f32 -> final h [B, h] in ``out_dtype`` (float32 or bfloat16).  On the
    card the cluster kernel's zx mode up to ``MAX_CLUSTER_HIDDEN``, the
    block kernel past it."""
    return _hoisted("gru_scan_hoisted", zx, U, b_rec, reuse, out_dtype)


def gru_scan_pipeline_kernel(zx: torch.Tensor, U: torch.Tensor,
                             b_rec: torch.Tensor, *, reuse: int = 1,
                             out_dtype=torch.float32) -> torch.Tensor:
    """The pipeline schedule's scan: arguments and result as
    :func:`gru_scan_hoisted_kernel`, the R column tiles of each step's
    h U issued together (a chain of T steps, not T*R)."""
    return _hoisted("gru_scan_pipeline", zx, U, b_rec, reuse, out_dtype)


#: plain version of :func:`gru_scan_pipeline_kernel` (the same function)
gru_scan_pipeline_plain = gru_scan_hoisted_plain
