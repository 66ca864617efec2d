"""Golden models of the scheduled kernels in plain PyTorch
(``backend="xla"``).

They follow the JAX package's ``lax.scan`` references step for step,
including its type promotion: a product of a bfloat16 and a float32 operand
is taken in float32, a product of two bfloat16 operands in bfloat16, and
the pre-activations are cast to float32 before the gates.

Batch invariance: a row's result must not depend on the other rows of its
batch (``predict_one(x) == predict(X)[i]`` bit for bit, as ``repro``
holds).  On the CPU two PyTorch calls break that: MKL's ``matmul`` rounds a
row differently at different M, and ``torch.sigmoid`` runs a vectorised and
a scalar formula, chosen by where an element falls in the flattened
tensor.  So every product of the plain versions, the cells and the dense
head goes through :func:`matmul`, and every sigmoid through
:func:`sigmoid`: on CPU tensors both compute each element in one fixed
order.  A CUDA tensor takes cuBLAS and ``torch.sigmoid`` here (plain
versions held against the kernels within tolerance); the serving path's
float and native-int products run on the kernels there, and the ap_fixed
emulation's on cuBLAS, whose sums of grid values the card showed equal in
every batch shape (``chip_smoke.py`` phase 3 ``robustness``).
"""

from __future__ import annotations

import torch


def _k_ordered(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] of CPU tensors of one floating dtype: every output
    the k-ascending sum of its K products, each product and each sum
    rounded (bfloat16 operands summed in float32, then rounded once)."""
    dt = a.dtype
    N = w.shape[1]
    acc_dt = dt if dt in (torch.float32, torch.float64) else torch.float32
    cols = a.to(acc_dt).t().contiguous()                  # [K, M]
    w = w.to(acc_dt)
    acc = torch.zeros(cols.shape[1], N, dtype=acc_dt)
    term = torch.empty_like(acc)
    for k in range(cols.shape[0]):
        torch.mul(cols[k, :, None], w[k], out=term)
        acc.add_(term)
    return acc.to(dt)


class _KOrderedMatmul(torch.autograd.Function):
    """:func:`_k_ordered` with its gradients: ``grad @ wᵀ`` and
    ``aᵀ @ grad``, each through :func:`matmul` again (k-ordered, and
    differentiable once more)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _k_ordered(a, w)

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        ga = matmul(grad, w.t()) if ctx.needs_input_grad[0] else None
        gw = matmul(a.t(), grad) if ctx.needs_input_grad[1] else None
        return ga, gw


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` ([..., K] @ [K, N]) in the promoted type of the two
    operands, as jnp's ``@``.  On CPU tensors every output is the
    k-ascending sum of its K products, each product and each sum rounded
    (bfloat16 operands summed in float32, then rounded once), so a row's
    bits do not depend on M; its gradients are taken the same way.  On
    other devices ``torch.matmul``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    a, w = a.to(dt), w.to(dt)
    if a.device.type != "cpu" or not dt.is_floating_point:
        return a @ w
    K, N = w.shape
    lead = a.shape[:-1]
    return _KOrderedMatmul.apply(a.reshape(-1, K), w).reshape(*lead, N)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``.  On CPU tensors as three elementwise calls
    whose bits do not depend on an element's position (``torch.sigmoid``'s
    do); on other devices ``torch.sigmoid``."""
    if x.device.type != "cpu":
        return torch.sigmoid(x)
    return torch.reciprocal(torch.exp(-x) + 1.0)



def lstm_scan_ref(xs: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """xs: [B, T, in] -> final h [B, h] (Keras gate order i|f|c|o)."""
    B, T, _ = xs.shape
    h = U.shape[0]
    hp = torch.zeros(B, h, dtype=torch.float32, device=xs.device)
    cp = torch.zeros_like(hp)
    for t in range(T):
        z = (matmul(xs[:, t], W) + matmul(hp, U) + b).float()
        i = sigmoid(z[:, :h])
        f = sigmoid(z[:, h:2 * h])
        g = torch.tanh(z[:, 2 * h:3 * h])
        o = sigmoid(z[:, 3 * h:])
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
        zx = (matmul(xs[:, t], W) + b[0]).float()
        zh = (matmul(hp, U) + b[1]).float()
        z = sigmoid(zx[:, :h] + zh[:, :h])
        r = sigmoid(zx[:, h:2 * h] + zh[:, h:2 * h])
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
    return matmul(x.float(), w.float()).to(x.dtype)


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product [M, K] @ [K, N] -> int32 (the native
    datapath's golden reference), taken in float64: exact while |acc| <
    2^53, and integer products are not implemented on CUDA."""
    return (a.double() @ w.double()).to(torch.int32)
