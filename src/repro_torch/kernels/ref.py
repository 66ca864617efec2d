"""Golden models of the scheduled kernels in plain PyTorch
(``backend="xla"``).

They follow the JAX package's ``lax.scan`` references step for step,
including its type promotion: a product of a bfloat16 and a float32 operand
is taken in float32, a product of two bfloat16 operands in bfloat16, and
the pre-activations are cast to float32 before the gates.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted type of the two operands, as jnp's ``@``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def lstm_scan_ref(xs: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """xs: [B, T, in] -> final h [B, h] (Keras gate order i|f|c|o)."""
    B, T, _ = xs.shape
    h = U.shape[0]
    hp = torch.zeros(B, h, dtype=torch.float32, device=xs.device)
    cp = torch.zeros_like(hp)
    for t in range(T):
        z = (_mm(xs[:, t], W) + _mm(hp, U) + b).float()
        i = torch.sigmoid(z[:, :h])
        f = torch.sigmoid(z[:, h:2 * h])
        g = torch.tanh(z[:, 2 * h:3 * h])
        o = torch.sigmoid(z[:, 3 * h:])
        cp = f * cp + i * g
        hp = o * torch.tanh(cp)
    return hp.to(xs.dtype)


def gru_scan_ref(xs: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """xs: [B, T, in] -> final h [B, h] (reset_after; b: [2, 3h])."""
    B, T, _ = xs.shape
    h = U.shape[0]
    hp = torch.zeros(B, h, dtype=torch.float32, device=xs.device)
    for t in range(T):
        zx = (_mm(xs[:, t], W) + b[0]).float()
        zh = (_mm(hp, U) + b[1]).float()
        z = torch.sigmoid(zx[:, :h] + zh[:, :h])
        r = torch.sigmoid(zx[:, h:2 * h] + zh[:, h:2 * h])
        hh = torch.tanh(zx[:, 2 * h:] + r * zh[:, 2 * h:])
        hp = z * hp + (1.0 - z) * hh
    return hp.to(xs.dtype)


def hadamard_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a * b`` in the promoted type of the two."""
    return a * b


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t over axis 1 -> all states [B, T, W] in a's
    dtype; the state is float32 and starts at zero, and each step rounds
    the product and then the sum (no fused multiply-add)."""
    B, T, W = a.shape
    h = torch.zeros(B, W, dtype=torch.float32, device=a.device)
    hs = []
    for t in range(T):
        h = a[:, t].float() * h + bx[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def reuse_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated in float32, result in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product [M, K] @ [K, N] -> int32 (the native
    datapath's golden reference), taken in float64: exact while |acc| <
    2^53, and integer products are not implemented on CUDA."""
    return (a.double() @ w.double()).to(torch.int32)
