"""RG-LRU linear recurrence: the CUDA kernel's wrapper and plain version.

Replaces ``repro/kernels/rglru_scan.py``'s ``rglru_scan_pallas``:
``h_t = a_t * h_{t-1} + bx_t`` over a, bx ``[B, T, W]`` (decay and gated
input, each float32 or bfloat16), the state float32 from zero, every state
written out in a's dtype.  The kernel lives in ``csrc/rglru_scan.cu``: one
thread per (row, column) carries the state in a register through T, one
thread block per (batch tile, width tile); with ``serial_width`` (the reuse
factor R > 1) one block per batch tile walks its width tiles in order.
Ragged B and W are masked in the kernel, so nothing is padded.

Every (row, column) is its own recurrence, so the tiles change the order of
work and never a value: the plain version is the reference's chain
(``ref.rglru_scan_ref``).  Each step rounds
the product and then the sum (the kernel writes them as two IEEE-rounded
intrinsics, so nvcc cannot fuse them into an FMA), which gives the plain
version's bits on the card.

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version; any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref

_DTYPES = (torch.float32, torch.bfloat16)


def rglru_scan_plain(a: torch.Tensor, bx: torch.Tensor, *,
                     block_batch: int = 8, block_width: int = 128,
                     serial_width: bool = False) -> torch.Tensor:
    """Plain version of :func:`rglru_scan_kernel`: the reference's chain
    (the tiles change no value, so they are ignored)."""
    return ref.rglru_scan_ref(a, bx)


def rglru_scan_kernel(a: torch.Tensor, bx: torch.Tensor, *,
                      block_batch: int = 8, block_width: int = 128,
                      serial_width: bool = False) -> torch.Tensor:
    """a, bx: [B, T, W], each float32 or bfloat16 -> all states [B, T, W]
    in a's dtype; the grid is (batch tiles of ``block_batch`` rows) x
    (width tiles of ``block_width`` columns, walked in order by one block
    when ``serial_width``)."""
    if a.ndim != 3 or a.shape != bx.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and bx "
                         f"{tuple(bx.shape)} must be one [B, T, W] shape")
    if a.dtype not in _DTYPES or bx.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan: a and bx must be float32 or bfloat16, "
                        f"not {a.dtype} and {bx.dtype}")
    if block_batch < 1 or block_width < 1:
        raise ValueError(f"rglru_scan: tiles {block_batch} x {block_width}")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, bx, block_batch=block_batch,
                                block_width=block_width,
                                serial_width=serial_width)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    dev = cuda.require("rglru_scan", a.dtype, io=("a",), a=a)
    if cuda.require("rglru_scan", bx.dtype, io=("bx",), bx=bx) != dev:
        raise ValueError(f"rglru_scan: bx is on {bx.device}, expected {dev}")
    out = torch.empty_like(a)
    if out.numel():
        B, T, W = a.shape
        cuda.launch("rglru_scan", "rglru_scan", dev, a.data_ptr(),
                    int(a.dtype == torch.bfloat16), bx.data_ptr(),
                    int(bx.dtype == torch.bfloat16), out.data_ptr(), B, T, W,
                    block_batch, block_width, int(serial_width))
    return out
