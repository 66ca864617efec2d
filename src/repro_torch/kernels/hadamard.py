"""Hadamard product: the CUDA kernel's wrapper and plain version.

Replaces ``repro/kernels/hadamard.py``'s ``hadamard_pallas``, the op the
paper added to hls4ml (Sec. 3): ``a * b`` elementwise over ``[N, M]``, a and
b of one dtype, float32 or bfloat16, the output in that dtype.  The kernel
lives in ``csrc/hadamard.cu``, on the streaming body of
``csrc/stream_elementwise.cuh`` (16-byte vectors, a scalar head and tail,
any N and any operand offset; the TPU's row blocks and their padding are
not ported).  Each output is the float32 product rounded once to the dtype; for
two bfloat16 operands that product is exact in float32, so the result is
the correctly rounded bfloat16 product, the bits of ``torch.mul``.

A mixed pair raises ``TypeError`` on every device, as the JAX package's
kernel refuses one: nothing is promoted.  A CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version; any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_DTYPES = (torch.float32, torch.bfloat16)


def hadamard_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hadamard_kernel`."""
    return (a.float() * b.float()).to(a.dtype)


def hadamard_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [N, M], both float32 or both bfloat16 -> a * b, same shape and
    dtype."""
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"hadamard: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [N, M] shape")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"hadamard: a and b must be both float32 or both "
                        f"bfloat16, not {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return hadamard_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"hadamard: no kernel for device {a.device}")
    dev = cuda.require("hadamard", a.dtype, io=("a", "b"), a=a, b=b)
    out = torch.empty_like(a)
    if out.numel():
        cuda.launch("hadamard", "hadamard", dev, a.data_ptr(), b.data_ptr(),
                    int(a.dtype == torch.bfloat16), out.data_ptr(),
                    out.numel())
    return out
