"""Reuse-tiled matrix products: the CUDA kernels' wrappers and plain versions.

Replaces ``repro/kernels/reuse_matmul.py``'s ``col_matmul_pallas`` (the N
output columns in R sequential tiles: the per-timestep blocks of the
non-static schedule and the hoist stage at ``hoist_reuse > 1``) and
``reuse_matmul_pallas`` (the K reduction in R sequential passes).  The
kernels live in ``csrc/reuse_matmul.cu``: both run one tiled design (a CTA
tile of outputs in registers, w staged through a ring of shared-memory
slots); ``col_matmul`` walks its R column tiles in order, ``reuse_matmul``
runs it as one tile over all of K at every R (its passes, added in order,
are R = 1's k-ascending sum, so R names them only).

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, which repeats the kernel's R-tiled arithmetic with f32
accumulation; any other device raises.  Shapes and types are checked before
anything runs.  The kernels pick their tiles for the shape and mask the
ragged edges, so ``M`` needs no padding here (``ops`` pads to the TPU
kernels' row granule anyway, as ``repro`` does).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import matmul


def col_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                     reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`col_matmul_kernel`."""
    ns = w.shape[1] // reuse
    x32 = x.float()
    tiles = [matmul(x32, w[:, r * ns:(r + 1) * ns].float())
             for r in range(reuse)]
    return torch.cat(tiles, dim=-1).to(x.dtype)


def reuse_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                       reuse: int = 1) -> torch.Tensor:
    """Plain version of :func:`reuse_matmul_kernel`."""
    ks = x.shape[1] // reuse
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for r in range(reuse):
        k = slice(r * ks, (r + 1) * ks)
        acc += matmul(x[:, k].float(), w[k].float())
    return acc.to(x.dtype)


def _check(kernel: str, x, w, reuse: int, split: int) -> None:
    """``split`` is the dimension the R tiles divide (N or K)."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{kernel}: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not a matrix product")
    if reuse < 1 or split % reuse:
        raise ValueError(f"{kernel}: reuse {reuse} does not divide {split}")


def col_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                      reuse: int = 1) -> torch.Tensor:
    """x: [M, K] f32|bf16 @ w: [K, N] f32 -> [M, N] in x's dtype, the N
    columns in ``reuse`` sequential tiles (``reuse`` must divide N)."""
    _check("col_matmul", x, w, reuse, w.shape[1])
    if x.device.type == "cpu":
        return col_matmul_plain(x, w, reuse=reuse)
    if x.device.type != "cuda":
        raise ValueError(f"col_matmul: no kernel for device {x.device}")
    dev = cuda.require("col_matmul", x.dtype, io=("x",), x=x, w=w)
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if M:
        cuda.launch("reuse_matmul", "col_matmul", dev, x.data_ptr(),
                    int(x.dtype == torch.bfloat16), w.data_ptr(),
                    out.data_ptr(), M, K, N, reuse)
    return out


def reuse_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                        reuse: int = 1) -> torch.Tensor:
    """x: [M, K] @ w: [K, N], both f32 or both bf16 -> [M, N] in x's dtype,
    K in ``reuse`` sequential passes accumulated in f32 (``reuse`` must
    divide K).  On the card every output sums its K products in k order
    whatever R, so R = 2 and 4 give R = 1's bits.  Mixed operands raise
    on every device, the CPU included (the Pallas kernel's contract)."""
    _check("reuse_matmul", x, w, reuse, x.shape[1])
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"reuse_matmul: x and w must be both float32 or "
                        f"both bfloat16, not {x.dtype} and {w.dtype}")
    if x.device.type == "cpu":
        return reuse_matmul_plain(x, w, reuse=reuse)
    if x.device.type != "cuda":
        raise ValueError(f"reuse_matmul: no kernel for device {x.device}")
    return launch_reuse_matmul(x, w, reuse)


def launch_reuse_matmul(x: torch.Tensor, w: torch.Tensor,
                        reuse: int) -> torch.Tensor:
    """Launch ``reuse_matmul`` on CUDA tensors (shapes and dtypes checked by
    the caller); the kernel masks a ragged M and N itself."""
    dev = cuda.require("reuse_matmul", x.dtype, io=("x", "w"), x=x, w=w)
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if M:
        cuda.launch("reuse_matmul", "reuse_matmul", dev, x.data_ptr(),
                    w.data_ptr(), int(x.dtype == torch.bfloat16),
                    out.data_ptr(), M, K, N, reuse)
    return out
