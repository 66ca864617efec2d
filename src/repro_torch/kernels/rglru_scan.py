"""RG-LRU linear recurrence: the CUDA kernel's wrapper, its layout model and
its plain version.

Replaces ``repro/kernels/rglru_scan.py``'s ``rglru_scan_pallas``:
``h_t = a_t * h_{t-1} + bx_t`` over a, bx ``[B, T, W]`` (decay and gated
input, each float32 or bfloat16), the state float32 from zero, every state
written out in a's dtype.  The kernel lives in ``csrc/rglru_scan.cu``: a
streaming recurrence over every SM of the card, by one of two routes.
Where a TMA tensor map can describe a and bx (16-byte-aligned, W *
itemsize a multiple of 16), a block owns ``cols`` channels of one row and
a producer thread streams [``tc``, ``cols``] chunks of a and bx through a
ring of shared-memory stages while one thread a channel runs its chain;
every other operand (a pointer or a row stride off the 16-byte grid) runs
the register window, the narrower granule: a thread owns ``vec`` channels
(down to one) and keeps a window of ``unroll`` steps of both inputs in
flight in registers.  :func:`rglru_layout` is the model of the layout the
C launcher plans (its twin ``rglru_scan_layout``).  Ragged B, T and W
cost nothing else; nothing is padded.

The reuse factor.  ``block_batch``, ``block_width`` and ``serial_width``
(R > 1) are ``repro``'s schedule: on the TPU, R walks the width tiles in
order so that one tile of lanes is reused.  On the card a width tile that
waits for another saves no resource and only idles the other SMs, so they
name the schedule and choose no layout: every R runs the same instance and
layout, and R = 2, 4 give R = 1's bits by construction.

Every (row, column) is its own recurrence, so no layout changes a value:
the plain version is the reference's chain (``ref.rglru_scan_ref``).  Each
step rounds the product and then the sum (the kernel writes them as two
IEEE-rounded intrinsics, so nvcc cannot fuse them into an FMA), which gives
the plain version's bits on the card.

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version; any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda, ref

_DTYPES = (torch.float32, torch.bfloat16)

#: the H100 SXM's SM count, the model's default card
SMS = 132
#: the kernel's constants (``csrc/rglru_scan.cu``).  Shared memory: a
#: block's most.  The ring: its widest block of channels, a stage's most
#: bytes (a and bx), its stages, its producer warp.  The register window:
#: the registers of a thread's window, its longest window, the load groups
#: in it, the blocks an SM the block size must leave, the largest block.
MAX_SMEM = 227 * 1024
MAX_COLS, STAGE_BYTES, STAGES, PRODUCER = 128, 32 * 1024, 3, 32
BUF_WORDS, MAX_UNROLL, GROUPS = 128, 64, 2
BLOCKS_PER_SM, MAX_THREADS = 2, 256


class RglruLayout(NamedTuple):
    """The launch layout of one ``rglru_scan`` call.  ``ring``: 1 for the
    TMA ring (a block owns ``cols`` channels of one row and streams them
    through ``stages`` shared-memory stages of ``tc`` steps), 0 for the
    register window (a thread owns ``vec`` channels and a window of
    ``unroll`` steps in registers); then threads a block, blocks and
    shared-memory bytes."""
    ring: int
    vec: int
    unroll: int
    cols: int
    tc: int
    stages: int
    threads: int
    blocks: int
    smem_bytes: int

    @property
    def channels_per_block(self) -> int:
        return self.cols if self.ring else self.threads * self.vec


def _words(vec: int, itemsize: int) -> int:
    """Registers a vector of ``vec`` elements takes."""
    return max(1, vec * itemsize // 4)


def rglru_layout(B: int, W: int, a_dtype: torch.dtype = torch.float32,
                 bx_dtype: torch.dtype = torch.float32, *,
                 block_batch: int = 8, block_width: int = 128,
                 serial_width: bool = False, offsets=(0, 0, 0),
                 sms: int = SMS) -> RglruLayout:
    """The layout ``csrc/rglru_scan.cu`` plans for a, bx [B, T, W] (T does
    not enter) on ``sms`` SMs, with a, bx and out at ``offsets`` bytes past
    a 16-byte boundary.  The schedule's tiles (``block_batch``,
    ``block_width``, ``serial_width``) are the C entry point's arguments
    too, and choose nothing (module docstring).

    The ring where a tensor map can describe a and bx (both on the 16-byte
    grid, W * itemsize a multiple of 16): ``cols`` 128, halved to 32 while
    ``B * ceil(W / cols)`` blocks leave an SM without one; ``tc`` the
    largest power of two up to 256 whose stage fits ``STAGE_BYTES``;
    ``STAGES`` stages.  Else the register window: ``vec`` the largest
    vector (at most 16 bytes of each input) that W and every operand's
    offset allow; ``unroll`` the steps whose loads fit ``BUF_WORDS``
    registers, a power of two; ``threads`` the largest block of 256 .. 32
    that still gives each SM ``BLOCKS_PER_SM`` blocks."""
    if B < 1 or W < 1 or sms < 1 or block_batch < 1 or block_width < 1:
        raise ValueError(f"rglru_layout: B {B}, W {W}, sms {sms}, tiles "
                         f"{block_batch} x {block_width}")
    sa = torch.empty((), dtype=a_dtype).element_size()
    sb = torch.empty((), dtype=bx_dtype).element_size()
    if (offsets[0] % 16 == 0 and offsets[1] % 16 == 0
            and W * sa % 16 == 0 and W * sb % 16 == 0):
        cols = MAX_COLS
        while cols > 32 and B * -(-W // cols) < sms:
            cols //= 2
        tc = 256
        while tc > 1 and tc * cols * (sa + sb) > STAGE_BYTES:
            tc //= 2
        stage = tc * cols * (sa + sb) + 16           # + its two mbarriers
        return RglruLayout(1, 1, 0, cols, tc, STAGES, cols + PRODUCER,
                           B * -(-W // cols), STAGES * stage)
    sizes = (sa, sb, sa)
    vec = 16 // max(sa, sb)
    while vec > 1 and (W % vec or any(off % (vec * s)
                                      for off, s in zip(offsets, sizes))):
        vec //= 2
    fit = BUF_WORDS // (_words(vec, sa) + _words(vec, sb))
    unroll = MAX_UNROLL
    while unroll > GROUPS and unroll > fit:
        unroll //= 2
    n = B * (W // vec)
    threads = MAX_THREADS
    while threads > 32 and -(-n // threads) < sms * BLOCKS_PER_SM:
        threads //= 2
    return RglruLayout(0, vec, unroll, 0, 0, 0, threads, -(-n // threads), 0)


def layout_of(a: torch.Tensor, bx: torch.Tensor,
              out: torch.Tensor) -> RglruLayout:
    """:func:`rglru_layout` at these tensors' shapes, dtypes and addresses,
    on their card (the H100's SM count for a CPU tensor)."""
    sms = (torch.cuda.get_device_properties(a.device).multi_processor_count
           if a.device.type == "cuda" else SMS)
    B, _, W = a.shape
    offsets = tuple(t.data_ptr() % 16 for t in (a, bx, out))
    return rglru_layout(B, W, a.dtype, bx.dtype, offsets=offsets, sms=sms)


def rglru_scan_plain(a: torch.Tensor, bx: torch.Tensor, *,
                     block_batch: int = 8, block_width: int = 128,
                     serial_width: bool = False) -> torch.Tensor:
    """Plain version of :func:`rglru_scan_kernel`: the reference's chain
    (the schedule changes no value, so it is ignored)."""
    return ref.rglru_scan_ref(a, bx)


def rglru_scan_kernel(a: torch.Tensor, bx: torch.Tensor, *,
                      block_batch: int = 8, block_width: int = 128,
                      serial_width: bool = False) -> torch.Tensor:
    """a, bx: [B, T, W], each float32 or bfloat16 -> all states [B, T, W]
    in a's dtype.  ``block_batch``, ``block_width`` and ``serial_width``
    are the schedule's tiles (checked; they choose no layout: module
    docstring)."""
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
