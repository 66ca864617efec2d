"""Public scan entry points: dispatch of the LSTM / GRU scans through one
:class:`KernelSchedule`.

  backend "xla"     the golden reference (kernels/ref.py);
  any other backend the kernel path.  Static mode runs the scan kernels
                    with the gate matmuls partitioned into reuse_factor
                    sequential column tiles; with ``hoist_input`` the input
                    projection xW for all timesteps runs first as one
                    batched f32 matmul and the hoisted kernels carry only hU.

The kernel path dispatches on the tensor's device: a CUDA tensor launches
the CUDA kernels (or raises), a CPU tensor runs their plain versions.

Not in this slice of the port: non-static and pipeline modes and
``hoist_reuse > 1`` on a kernel backend (they need ``col_matmul`` and the
pipeline kernels: ROADMAP.md, kernels to port, items 3, 6 and 7) and the
fixed-point datapaths.  They raise :class:`NotImplementedError`; with
``backend="xla"`` every mode runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.gru_scan import (gru_scan_hoisted_kernel,
                                          gru_scan_kernel)
from repro_torch.kernels.lstm_scan import (lstm_scan_hoisted_kernel,
                                           lstm_scan_kernel)
from repro_torch.kernels.schedule import KernelSchedule


def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def _resolve(schedule: Optional[KernelSchedule],
             block_batch: Optional[int], default_bb: int = 128
             ) -> KernelSchedule:
    if schedule is None:
        return KernelSchedule(block_batch=block_batch or default_bb)
    if block_batch is not None:
        return schedule.replace(block_batch=block_batch)
    return schedule


def _require_static(schedule: KernelSchedule, kernel: str) -> None:
    if schedule.mode != "static":
        raise NotImplementedError(
            f"{kernel}: mode {schedule.mode!r} on a kernel backend needs the "
            f"col_matmul and pipeline kernels, not ported yet (ROADMAP.md, "
            f"kernels to port, items 3, 6 and 7); use backend='xla'")
    if schedule.hoist_reuse != 1:
        raise NotImplementedError(
            f"{kernel}: hoist_reuse={schedule.hoist_reuse} needs the "
            f"col_matmul kernel, not ported yet (ROADMAP.md, kernels to "
            f"port, item 3); use hoist_reuse=1 or backend='xla'")


def _hoist_stage(xs: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The hoisted input projection at ``hoist_reuse == 1``: ONE batched
    [B*T, fin] @ [fin, G*h] matmul in f32, no bias.  On the card this is a
    cuBLAS f32 product, which stays in full f32 as long as TF32 matmuls are
    off (PyTorch's default)."""
    B, T, fin = xs.shape
    zx = xs.reshape(B * T, fin).float() @ W
    return zx.reshape(B, T, W.shape[-1])


def _static_scan(cell: str, xs, W, U, b, schedule: KernelSchedule):
    _require_static(schedule, f"{cell}_scan")
    # the kernels compute every gate product in f32 from f32 weights
    W, U, b = (t.float().contiguous() for t in (W, U, b))
    B = xs.shape[0]
    g = 4 if cell == "lstm" else 3
    reuse = schedule.effective_reuse(g * U.shape[0])
    xs_p = _pad_axis(xs, 0, min(schedule.block_batch, max(8, B))).contiguous()
    if schedule.hoist_input:
        zx = _hoist_stage(xs_p, W)
        if cell == "lstm":
            out = lstm_scan_hoisted_kernel(zx, U, b, reuse=reuse,
                                           out_dtype=xs.dtype)
        else:
            # the GRU keeps input- and recurrent-side pre-activations apart,
            # so the input bias folds into the hoisted zx
            out = gru_scan_hoisted_kernel((zx + b[0]).contiguous(), U,
                                          b[1].contiguous(), reuse=reuse,
                                          out_dtype=xs.dtype)
    elif cell == "lstm":
        out = lstm_scan_kernel(xs_p, W, U, b, reuse=reuse)
    else:
        out = gru_scan_kernel(xs_p, W, U, b, reuse=reuse)
    return out[:B]


def lstm_scan(xs, W, U, b, *, schedule: Optional[KernelSchedule] = None,
              block_batch: Optional[int] = None) -> torch.Tensor:
    """[B, T, in] -> final hidden [B, h], scheduled by ``schedule``."""
    schedule = _resolve(schedule, block_batch)
    if not schedule.use_pallas:
        return ref.lstm_scan_ref(xs, W, U, b)
    return _static_scan("lstm", xs, W, U, b, schedule)


def gru_scan(xs, W, U, b, *, schedule: Optional[KernelSchedule] = None,
             block_batch: Optional[int] = None) -> torch.Tensor:
    """GRU counterpart of :func:`lstm_scan` (b: [2, 3h])."""
    schedule = _resolve(schedule, block_batch)
    if not schedule.use_pallas:
        return ref.gru_scan_ref(xs, W, U, b)
    return _static_scan("gru", xs, W, U, b, schedule)


# kernel name -> (scheduled entry point, golden reference)
SCHEDULED_KERNELS = {
    "lstm": (lstm_scan, ref.lstm_scan_ref),
    "gru": (gru_scan, ref.gru_scan_ref),
}
