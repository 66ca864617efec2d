"""LSTM / GRU cells: Keras-compatible math (paper Eq. 1).

Weight layout follows Keras, as in the JAX package:

  LSTM: kernel W [in, 4h] (gates i|f|c|o), recurrent U [h, 4h], bias [4h]
  GRU (reset_after): kernel [in, 3h] (z|r|hh), recurrent [h, 3h],
                     bias [2, 3h] (input bias ; recurrent bias)

Products follow jnp's type promotion (bfloat16 x float32 in float32).  The
fixed-point cells (``*_cell_quantized``) emulate the hls4ml datapath: f32
compute with ``quantize`` at every ap_fixed point.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import FixedPointConfig, RNNConfig
from repro_torch.core.quant.fixed_point import quantize
from repro_torch.kernels.ref import matmul, sigmoid
from repro_torch.models.init import ParamSpec, ParamSpecs


def rnn_param_specs(rnn: RNNConfig, prefix: str = "rnn") -> ParamSpecs:
    h, fin = rnn.hidden, rnn.input_size
    g = 4 if rnn.cell == "lstm" else 3
    bias = (g * h,) if rnn.cell == "lstm" else (2, g * h)
    return {
        f"{prefix}/kernel": ParamSpec((fin, g * h), "lecun",
                                      logical_axes=("rnn_in", "rnn_gates")),
        f"{prefix}/recurrent": ParamSpec(
            (h, g * h), "rnn_ortho", logical_axes=("rnn_hidden", "rnn_gates")),
        f"{prefix}/bias": ParamSpec(bias, "zeros", logical_axes=(
            ("rnn_gates",) if rnn.cell == "lstm" else (None, "rnn_gates"))),
    }


def tiled_matmul(x: torch.Tensor, w: torch.Tensor,
                 reuse: int = 1) -> torch.Tensor:
    """x @ w computed as ``reuse`` sequential column tiles: the cell-level
    realization of the schedule's reuse factor.  Column tiles are
    independent, so any R agrees with R=1 up to fp accumulation order
    (on the CPU, whose :func:`~repro_torch.kernels.ref.matmul` sums each
    output in k order, bit for bit)."""
    if reuse <= 1:
        return matmul(x, w)
    n = w.shape[-1]
    if n % reuse:
        raise ValueError(f"reuse {reuse} does not divide {n} columns")
    ns = n // reuse
    return torch.cat([matmul(x, w[:, r * ns:(r + 1) * ns])
                      for r in range(reuse)], dim=-1)


def lstm_cell(x_t, state, W, U, b, *, reuse: int = 1, matmul=None,
              zx: Optional[torch.Tensor] = None):
    """One LSTM step.  x_t: [b, in]; state = (h, c): [b, h] each.

    ``matmul`` swaps the gate matmul implementation; ``zx`` injects a
    precomputed input projection x_t @ W (no bias), keeping the association
    (xW + hU) + b.
    """
    mm = matmul if matmul is not None else (
        lambda a, w: tiled_matmul(a, w, reuse))
    h_prev, c_prev = state
    hdim = h_prev.shape[-1]
    z = (zx if zx is not None else mm(x_t, W)) + mm(h_prev, U) + b
    i = sigmoid(z[..., :hdim])
    f = sigmoid(z[..., hdim:2 * hdim])
    g = torch.tanh(z[..., 2 * hdim:3 * hdim])
    o = sigmoid(z[..., 3 * hdim:])
    c_t = f * c_prev + i * g                         # Hadamard products
    h_t = o * torch.tanh(c_t)
    return h_t, (h_t, c_t)


def gru_cell(x_t, state, W, U, b, *, reuse: int = 1, matmul=None,
             zx: Optional[torch.Tensor] = None):
    """One GRU step (reset_after).  x_t: [b, in]; state h: [b, h];
    b: [2, 3h] = (input bias; recurrent bias).  ``matmul`` and ``zx`` as in
    :func:`lstm_cell`."""
    mm = matmul if matmul is not None else (
        lambda a, w: tiled_matmul(a, w, reuse))
    h_prev = state
    b_in, b_rec = b[0], b[1]
    zx = (zx if zx is not None else mm(x_t, W)) + b_in   # [b, 3h]
    zh = mm(h_prev, U) + b_rec
    zxz, zxr, zxh = torch.chunk(zx, 3, dim=-1)
    zhz, zhr, zhh = torch.chunk(zh, 3, dim=-1)
    z = sigmoid(zxz + zhz)
    r = sigmoid(zxr + zhr)
    hh = torch.tanh(zxh + r * zhh)                   # Hadamard inside tanh
    h_t = z * h_prev + (1.0 - z) * hh                # Hadamard combine
    return h_t, h_t


# ---------------------------------------------------------------------------
# Fixed-point cells (bit-accurate hls4ml datapath emulation)
# ---------------------------------------------------------------------------


def _q(x, fp: Optional[FixedPointConfig]):
    return x if fp is None else quantize(x, fp)


def lstm_cell_quantized(x_t, state, W, U, b, fp: FixedPointConfig, *,
                        matmul=None):
    """LSTM step with every intermediate on the ap_fixed grid.

    Matches hls4ml's datapath: quantized inputs/weights, quantized
    accumulator outputs, LUT-indexed activations (quantized in/out),
    quantized Hadamard products.  ``matmul`` injects the gate matmul
    implementation; it must be value-equal to ``@`` for the datapath to
    stay bit-accurate.
    """
    mm = matmul if matmul is not None else tiled_matmul
    h_prev, c_prev = state
    hdim = h_prev.shape[-1]
    x_t = _q(x_t, fp)
    z = _q(mm(x_t, W) + mm(h_prev, U) + b, fp)
    i, f, g, o = (z[..., :hdim], z[..., hdim:2 * hdim],
                  z[..., 2 * hdim:3 * hdim], z[..., 3 * hdim:])
    i = _q(sigmoid(i), fp)
    f = _q(sigmoid(f), fp)
    g = _q(torch.tanh(g), fp)
    o = _q(sigmoid(o), fp)
    c_t = _q(_q(f * c_prev, fp) + _q(i * g, fp), fp)
    h_t = _q(o * _q(torch.tanh(c_t), fp), fp)
    return h_t, (h_t, c_t)


def gru_cell_quantized(x_t, state, W, U, b, fp: FixedPointConfig, *,
                       matmul=None):
    """GRU (reset_after) counterpart of :func:`lstm_cell_quantized`."""
    mm = matmul if matmul is not None else tiled_matmul
    h_prev = state
    x_t = _q(x_t, fp)
    zx = _q(mm(x_t, W) + b[0], fp)
    zh = _q(mm(h_prev, U) + b[1], fp)
    zxz, zxr, zxh = torch.chunk(zx, 3, dim=-1)
    zhz, zhr, zhh = torch.chunk(zh, 3, dim=-1)
    z = _q(sigmoid(zxz + zhz), fp)
    r = _q(sigmoid(zxr + zhr), fp)
    hh = _q(torch.tanh(_q(zxh + _q(r * zhh, fp), fp)), fp)
    h_t = _q(_q(z * h_prev, fp) + _q((1.0 - z) * hh, fp), fp)
    return h_t, h_t


def quantized_cell_scan(cell: str, xs, W, U, b, fp: FixedPointConfig, *,
                        matmul=None) -> torch.Tensor:
    """[B, T, in] -> final hidden [B, h]: the quantized cells over T on an
    f32 state, the result in xs's dtype.  ``matmul`` as in
    :func:`lstm_cell_quantized`: the ap_fixed emulation leaves it unset, the
    native int datapath passes its integer gate product."""
    B, T, _ = xs.shape
    step = lstm_cell_quantized if cell == "lstm" else gru_cell_quantized
    state = initial_state(cell, B, U.shape[0], torch.float32, xs.device)
    bf = b.float()
    for t in range(T):
        _, state = step(xs[:, t].float(), state, W, U, bf, fp, matmul=matmul)
    h = state[0] if cell == "lstm" else state
    return h.to(xs.dtype)


def initial_state(cell: str, batch: int, hidden: int,
                  dtype: torch.dtype = torch.float32,
                  device: Union[str, torch.device, None] = None):
    h0 = torch.zeros(batch, hidden, dtype=dtype, device=device)
    if cell == "lstm":
        return (h0, torch.zeros_like(h0))
    return h0
