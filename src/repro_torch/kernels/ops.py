"""Public scheduled entry points: dispatch of the LSTM / GRU scans, the
RG-LRU recurrence and the reuse-tiled matmul through one
:class:`KernelSchedule`, and the Hadamard product.

  backend "xla"     the golden reference (kernels/ref.py);
  any other backend the kernel path:
    static     the scan kernels, the gate matmuls partitioned into
               reuse_factor sequential column tiles per step;
    nonstatic  one block per timestep (paper Fig. 1 right): the cell
               equations of core/rnn/cells.py with every gate product on
               the column-tiled ``col_matmul`` kernel;
    pipeline   the hoist stage, then ONE pipeline scan kernel whose steps
               issue their R column tiles of h U together.

With ``hoist_input`` the input projection xW for all timesteps runs first
as one batched [B*T, fin] @ [fin, G*h] product in f32 on ``col_matmul``
(``hoist_reuse`` column tiles) and only hU stays in the recurrence.

``rglru_scan`` (a, bx [B, T, W] -> all states) is matmul-free and already
in hoisted form (the caller's dense gates are the hoist stage), so
``hoist_input`` is accepted and does nothing.  Static mode runs the
``rglru_scan`` kernel in width tiles of ``min(block_width, ceil(W / R))``
columns, independent at R = 1 and walked in order at R > 1; non-static and
pipeline modes run the unrolled f32 chain, one step per timestep, with no
kernel, as in ``repro``.  ``hadamard`` flattens any shape to [rows, last
dim] and runs the ``hadamard`` kernel.

``fp`` selects a fixed-point datapath: an ``is_native_int`` config
(signed, rnd, sat, <= 8 bits) on a kernel backend runs the native int8/int4
scan of kernels/quantized.py, every gate product on ``quant_matmul`` (the
RG-LRU: the all-integer recurrence, torch int32 ops); any other config,
and every config on ``backend="xla"``, runs the ap_fixed emulation (the
quantized cells, f32 compute with ``quantize`` at every hls4ml point; the
RG-LRU: ``h = q(q(a) h + q(bx))``).  Quantized scans never hoist.
``fixed_point`` runs the ``fixed_point`` kernel.

The kernel path dispatches on the tensor's device: a CUDA tensor launches
the CUDA kernels (or raises), a CPU tensor runs their plain versions.

``WeightResidency`` / ``resident`` cache packed weight layouts (dtype cast,
gate fusion) per (source identity and version, schedule key): the decode
kernels of kernels/decode_step.py and models/decode.py pack through it.
"""

from __future__ import annotations

import functools
import math
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import FixedPointConfig
from repro_torch.core.quant.fixed_point import is_native_int, quantize
from repro_torch.core.rnn.cells import (gru_cell, initial_state, lstm_cell,
                                        quantized_cell_scan)
from repro_torch.kernels import ref
from repro_torch.kernels.fixed_point import fixed_point_kernel
from repro_torch.kernels.gru_scan import (gru_scan_hoisted_kernel,
                                          gru_scan_kernel,
                                          gru_scan_pipeline_kernel)
from repro_torch.kernels.hadamard import hadamard_kernel
from repro_torch.kernels.lstm_scan import (lstm_scan_hoisted_kernel,
                                           lstm_scan_kernel,
                                           lstm_scan_pipeline_kernel)
from repro_torch.kernels.quantized import (quantized_reuse_matmul,
                                           quantized_rglru_scan,
                                           quantized_scan)
from repro_torch.kernels.reuse_matmul import (col_matmul_kernel,
                                              reuse_matmul_kernel)
from repro_torch.kernels.rglru_scan import rglru_scan_kernel
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


# ---------------------------------------------------------------------------
# Weight residency: pack each weight ONCE per (source version, schedule key)
# ---------------------------------------------------------------------------


def _tensors(tree):
    """Every tensor of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _PackList(list):
    """The container of a pack that hands back a source itself: a list
    (a tuple cannot be weakly referenced), held weakly by its entry."""


class _PackDict(dict):
    """As :class:`_PackList`, for a dict of packed tensors."""


class _Src:
    """In an entry's skeleton, the place of the pack's i-th source."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A tensor on ``t``'s storage, sizes, strides and offset that does
    not reference ``t`` or its base (a view does, through ``_base``)."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.size(), t.stride())


def _skeleton(tree, srcs: Tuple):
    """``tree`` with every leaf that IS a source replaced by its ``_Src``
    marker and every leaf on a source's storage (a view) by an
    ``_alias``; (skeleton, whether a marker was placed)."""
    if isinstance(tree, torch.Tensor):
        for i, a in enumerate(srcs):
            if tree is a:
                return _Src(i), True
        ptrs = {_storage_ptr(a) for a in srcs if a.numel()}
        if tree.numel() and _storage_ptr(tree) in ptrs:
            return _alias(tree), False
        return tree, False
    if isinstance(tree, dict):
        out = {k: _skeleton(v, srcs) for k, v in tree.items()}
        return ({k: v[0] for k, v in out.items()},
                any(v[1] for v in out.values()))
    if isinstance(tree, (list, tuple)):
        out = [_skeleton(v, srcs) for v in tree]
        return type(tree)(v[0] for v in out), any(v[1] for v in out)
    return tree, False


def _rebuild(skel, srcs: Tuple, top: bool = True):
    """The pack result of ``skel`` with its markers filled from ``srcs``
    (the top container a weakly referenceable ``_PackList`` /
    ``_PackDict``)."""
    if isinstance(skel, _Src):
        return srcs[skel.i]
    if isinstance(skel, dict):
        out = {k: _rebuild(v, srcs, False) for k, v in skel.items()}
        return _PackDict(out) if top else out
    if isinstance(skel, (list, tuple)):
        out = [_rebuild(v, srcs, False) for v in skel]
        return _PackList(out) if top else type(skel)(out)
    return skel


class _Entry:
    __slots__ = ("refs", "skel", "packed", "live", "nbytes")


class WeightResidency:
    """Host-side cache of packed weight layouts.

    ``get`` runs a pack function (dtype cast, gate fusion) ONCE per (source
    tensors, key) and returns the same packed result on every later call.

    Safety: ``repro``'s cache rests on jax arrays being immutable.  Torch
    tensors are not, so an entry is keyed on each source's identity AND its
    version counter (``tensor._version``, which every in-place operation
    bumps): an in-place update of a source misses the cache and repacks.

    An entry holds its sources weakly: a ``weakref.ref`` to each, whose
    callback drops the entry (and its bytes) when that source dies, and a
    hit checks each ``ref() is`` the given source.  So a dropped model's
    weights are freed at once, whatever else the cache holds, and an
    ``id`` cannot be reused while an entry keyed on it lives: the entry
    dies with its source, before CPython can recycle the ``id``.

    A pack may hand back a source itself (the f32 scan weights'
    ``.float().contiguous()`` of an f32 contiguous tensor) or a view of one
    (``resident_matrix``'s reshape, the LM decode pack's norm slices); held
    as they are, those would keep the source alive (a view through its
    ``_base``).  So an entry stores a view as a base-less alias on the same
    storage (``_alias``: the memory stays while the entry lives, the
    source object does not), and the place of a source handed back as
    itself as a marker: such a pack's result is rebuilt from the live
    sources, and its container (``_PackList`` / ``_PackDict``) is held
    weakly, so a caller that keeps it gets the same object back.  Nothing
    is left uncached.  Sources that cannot be keyed this way (numpy
    arrays, inference-mode tensors, which carry no version counter) pack
    uncached.  Eviction is LRU, bounded by the entry count and by the
    packed tensors' total bytes, so a pack larger than ``max_bytes`` (a
    full-width LM's decode layout) is evicted as soon as it is stored: its
    caller must keep its own reference.
    """

    def __init__(self, max_entries: int = 128,
                 max_bytes: int = 512 * 1024 * 1024):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.bytes = 0
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()

    @staticmethod
    def _nbytes(packed) -> int:
        return sum(t.numel() * t.element_size() for t in _tensors(packed))

    @staticmethod
    def _cacheable(srcs: Tuple) -> bool:
        # plain tensors only: not a DTensor, not a meta tensor (no storage
        # to tell a view from a copy by)
        return all(type(a) in (torch.Tensor, torch.nn.Parameter)
                   and not a.is_inference() and a.device.type != "meta"
                   for a in srcs)

    def _drop(self, ck: Tuple, ref: weakref.ref) -> None:
        """A source of entry ``ck`` died: drop the entry."""
        ent = self._entries.get(ck)
        if ent is not None and any(r is ref for r in ent.refs):
            del self._entries[ck]
            self.bytes -= ent.nbytes

    def _result(self, ent: _Entry, srcs: Tuple):
        if ent.packed is not None:
            return ent.packed
        out = ent.live() if ent.live is not None else None
        if out is None:
            out = _rebuild(ent.skel, srcs)
            ent.live = (weakref.ref(out)
                        if isinstance(out, (_PackList, _PackDict)) else None)
        return out

    def get(self, srcs, key: str, pack: Callable[[], object]):
        """Packed layout for ``srcs`` (one tensor or a tuple) under ``key``."""
        if not isinstance(srcs, tuple):
            srcs = (srcs,)
        if not self._cacheable(srcs):
            return pack()
        ck = (key,) + tuple((id(a), a._version) for a in srcs)
        ent = self._entries.get(ck)
        if ent is not None and all(r() is a for r, a in zip(ent.refs, srcs)):
            self.hits += 1
            self._entries.move_to_end(ck)
            return self._result(ent, srcs)
        self.misses += 1
        packed = pack()
        ent = _Entry()
        ent.nbytes = self._nbytes(packed)
        skel, marked = _skeleton(packed, srcs)
        ent.skel, ent.live = skel, None
        ent.packed = None if marked else skel
        drop = functools.partial(self._drop, ck)
        ent.refs = tuple(weakref.ref(a, drop) for a in srcs)
        self._entries[ck] = ent
        self.bytes += ent.nbytes
        out = self._result(ent, srcs)
        while self._entries and (len(self._entries) > self.max_entries
                                 or self.bytes > self.max_bytes):
            _, old = self._entries.popitem(last=False)
            self.bytes -= old.nbytes
        return out

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0


#: module-level residency cache (kernels/decode_step.py and
#: models/decode.py pack through it)
RESIDENT_WEIGHTS = WeightResidency()


def resident(srcs, key: str, pack: Callable[[], object]):
    """Module-level convenience over :data:`RESIDENT_WEIGHTS`."""
    return RESIDENT_WEIGHTS.get(srcs, key, pack)


def _gate_mm(x: torch.Tensor, w: torch.Tensor, reuse: int) -> torch.Tensor:
    """f32 x @ w through the column-tiled kernel (one per-timestep block of
    the non-static schedule), rows padded to repro's granule."""
    M = x.shape[0]
    x_p = _pad_axis(x.float(), 0, min(128, max(8, M))).contiguous()
    return col_matmul_kernel(x_p, w.float().contiguous(), reuse=reuse)[:M]


def _hoist_stage(xs: torch.Tensor, W: torch.Tensor,
                 schedule: KernelSchedule) -> torch.Tensor:
    """The hoisted input projection: ONE batched [B*T, fin] @ [fin, G*h]
    product in f32, no bias, on ``col_matmul`` in ``hoist_reuse``
    sequential column tiles (one at R = 1).  ``repro`` leaves R = 1 to
    XLA; the port keeps it on the kernel, whose every output is one
    k-ascending chain at any M, so a row's zx has the same bits in a batch
    of 1 and of 256 (cuBLAS picks its kernel, and so its order, by M)."""
    B, T, fin = xs.shape
    flat = xs.reshape(B * T, fin).float().contiguous()
    hr = math.gcd(schedule.hoist_reuse, W.shape[-1])
    # no row padding: the kernel masks a ragged M, and rows are independent
    return col_matmul_kernel(flat, W.float().contiguous(),
                             reuse=hr).reshape(B, T, W.shape[-1])


def _static_scan(cell: str, xs, W, U, b, schedule: KernelSchedule):
    B = xs.shape[0]
    g = 4 if cell == "lstm" else 3
    reuse = schedule.effective_reuse(g * U.shape[0])
    xs_p = _pad_axis(xs, 0, min(schedule.block_batch, max(8, B))).contiguous()
    if schedule.hoist_input:
        zx = _hoist_stage(xs_p, W, schedule)
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


def _cell_pipeline(cell: str, xs, W, U, b, schedule: KernelSchedule):
    """Pipeline mode: pad to the batch granule, the hoist stage, then the
    pipeline scan kernel."""
    B = xs.shape[0]
    g = 4 if cell == "lstm" else 3
    reuse = schedule.effective_reuse(g * U.shape[0])
    xs_p = _pad_axis(xs, 0, min(schedule.block_batch, max(8, B)))
    zx = _hoist_stage(xs_p, W, schedule)
    if cell == "lstm":
        out = lstm_scan_pipeline_kernel(zx.contiguous(), U, b, reuse=reuse,
                                        out_dtype=xs.dtype)
    else:
        out = gru_scan_pipeline_kernel((zx + b[0]).contiguous(), U,
                                       b[1].contiguous(), reuse=reuse,
                                       out_dtype=xs.dtype)
    return out[:B]


def _cell_unrolled(cell: str, xs, W, U, b, schedule: KernelSchedule):
    """Non-static mode, one block per timestep: the cells of
    core/rnn/cells.py with every gate product on ``col_matmul``.  With
    ``hoist_input`` the xW products of all timesteps come from one
    ``col_matmul`` first (at ``hoist_reuse`` R, 1 included, as in repro) and
    each block computes only its hU tiles."""
    B, T, _ = xs.shape
    H = U.shape[0]
    g = 4 if cell == "lstm" else 3
    reuse = schedule.effective_reuse(g * H)

    def mm(a, w):
        return _gate_mm(a, w, reuse)

    zx_all = None
    if schedule.hoist_input:
        hr = math.gcd(schedule.hoist_reuse, g * H)
        zx_all = _gate_mm(xs.reshape(B * T, -1), W, hr).reshape(B, T, g * H)
    state = initial_state(cell, B, H, torch.float32, xs.device)
    step = lstm_cell if cell == "lstm" else gru_cell
    for t in range(T):
        _, state = step(xs[:, t], state, W, U, b, matmul=mm,
                        zx=None if zx_all is None else zx_all[:, t])
    h = state[0] if cell == "lstm" else state
    return h.to(xs.dtype)


_MODES = {"static": _static_scan, "nonstatic": _cell_unrolled,
          "pipeline": _cell_pipeline}


def _scan_weights_resident(cell: str, W, U, b):
    """The kernels compute every gate product in f32 from f32 weights, so
    the f32 contiguous layout is packed once per weights identity (and
    version) instead of on every call, as ``repro``'s
    ``_scan_weights_resident``.  bf16 -> f32 is exact, so the result is
    bit for bit the in-call cast; f32 contiguous weights come back as the
    same tensors."""
    return resident((W, U, b), f"{cell}-scan-f32",
                    lambda: tuple(t.float().contiguous() for t in (W, U, b)))


def _kernel_scan(cell: str, xs, W, U, b, schedule: KernelSchedule):
    W, U, b = _scan_weights_resident(cell, W, U, b)
    return _MODES[schedule.mode](cell, xs, W, U, b, schedule)


# ---------------------------------------------------------------------------
# Fixed-point dispatch: native int bodies vs ap_fixed emulation
# ---------------------------------------------------------------------------


def _scan_fp_dispatch(cell: str, xs, W, U, b, schedule: KernelSchedule,
                      fp: FixedPointConfig) -> torch.Tensor:
    """Native int bodies for integral fp on a kernel backend, otherwise the
    ap_fixed EMULATION scan: the quantized cells (f32 compute, quantize() at
    every hls4ml datapath point), which stay the quantized golden reference
    on backend="xla".  Its f32 products are exact on grid operands only
    with TF32 off (PyTorch's default)."""
    if is_native_int(fp) and schedule.use_pallas:
        return quantized_scan(cell, xs, W, U, b, fp=fp, schedule=schedule)
    return quantized_cell_scan(cell, xs, W, U, b, fp)


def lstm_scan(xs, W, U, b, *, schedule: Optional[KernelSchedule] = None,
              block_batch: Optional[int] = None,
              fp: Optional[FixedPointConfig] = None) -> torch.Tensor:
    """[B, T, in] -> final hidden [B, h], scheduled by ``schedule``; ``fp``
    selects a fixed-point datapath (module docstring)."""
    schedule = _resolve(schedule, block_batch)
    if fp is not None:
        return _scan_fp_dispatch("lstm", xs, W, U, b, schedule, fp)
    if not schedule.use_pallas:
        return ref.lstm_scan_ref(xs, W, U, b)
    return _kernel_scan("lstm", xs, W, U, b, schedule)


def gru_scan(xs, W, U, b, *, schedule: Optional[KernelSchedule] = None,
             block_batch: Optional[int] = None,
             fp: Optional[FixedPointConfig] = None) -> torch.Tensor:
    """GRU counterpart of :func:`lstm_scan` (b: [2, 3h])."""
    schedule = _resolve(schedule, block_batch)
    if fp is not None:
        return _scan_fp_dispatch("gru", xs, W, U, b, schedule, fp)
    if not schedule.use_pallas:
        return ref.gru_scan_ref(xs, W, U, b)
    return _kernel_scan("gru", xs, W, U, b, schedule)


def hadamard(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for a and b of one dtype (float32 or bfloat16) on the
    ``hadamard`` kernel: any shape, flattened to [rows, last dim]; no row
    padding (the kernel takes any row count)."""
    shape = a.shape
    rows = a.numel() // shape[-1]
    a2 = a.reshape(rows, shape[-1]).contiguous()
    b2 = b.reshape(rows, shape[-1]).contiguous()
    return hadamard_kernel(a2, b2).reshape(shape)


def fixed_point(x: torch.Tensor, fp: FixedPointConfig) -> torch.Tensor:
    """``x`` (any shape, f32 or bf16) quantized to the ap_fixed grid on the
    ``fixed_point`` kernel."""
    return fixed_point_kernel(x.contiguous(), fp)


def reuse_matmul(x, w, *, reuse: int = 1, block_m: int = 128,
                 schedule: Optional[KernelSchedule] = None,
                 fp: Optional[FixedPointConfig] = None) -> torch.Tensor:
    """[M, K] @ [K, N] with K serialized into ``reuse`` passes (a schedule's
    reuse_factor overrides the bare ``reuse`` argument; a schedule on
    ``backend="xla"`` runs the reference).

    ``fp``: integral configs on a kernel schedule run ``quant_matmul``
    (z = q(q(x) @ q(w)) with int32 accumulation, the reuse factor tiling
    the output columns); other fp configs emulate the same quantization
    points in f32 around the float product.
    """
    if fp is not None:
        if (is_native_int(fp) and schedule is not None
                and schedule.use_pallas):
            return quantized_reuse_matmul(x, w, fp=fp, schedule=schedule)
        xq = quantize(x.float(), fp)
        wq = quantize(w.float(), fp)
        out = reuse_matmul(xq, wq, reuse=reuse, block_m=block_m,
                           schedule=schedule)
        return quantize(out, fp).to(x.dtype)
    if schedule is not None:
        if not schedule.use_pallas:
            return ref.reuse_matmul_ref(x, w)
        reuse = schedule.effective_reuse(x.shape[1])
    M = x.shape[0]
    x_p = _pad_axis(x, 0, min(block_m, max(8, M))).contiguous()
    return reuse_matmul_kernel(x_p, w.contiguous(), reuse=reuse)[:M]


def _rglru_emulated(a, bx, fp: FixedPointConfig) -> torch.Tensor:
    """ap_fixed emulation of the RG-LRU recurrence: gates and state on the
    grid, one requantization per step (h = q(q(a) h + q(bx))), f32 compute,
    the states in a's dtype.  A state that rounds to zero from below is
    -0.0 here and +0.0 on the native route: equal values, other bits, as in
    ``repro``."""
    B, T, W = a.shape
    aq = quantize(a.float(), fp)
    bq = quantize(bx.float(), fp)
    h = torch.zeros(B, W, dtype=torch.float32, device=a.device)
    hs = []
    for t in range(T):
        h = quantize(aq[:, t] * h + bq[:, t], fp)
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_scan(a, bx, *, schedule: Optional[KernelSchedule] = None,
               block_batch: Optional[int] = None, block_width: int = 128,
               fp: Optional[FixedPointConfig] = None) -> torch.Tensor:
    """a, bx: [B, T, W] -> all recurrence states [B, T, W] in a's dtype.

    The reuse factor R serializes the width tiles: static mode runs the
    ``rglru_scan`` kernel in tiles of ``min(block_width, ceil(W / R))``
    columns, walked in order by one block per batch tile at R > 1 (so W >=
    512 gives 128-column tiles, all serial, at R = 2 and R = 4 alike).
    ``hoist_input`` is a no-op (module docstring); non-static and pipeline
    modes run the unrolled f32 chain, one step per timestep, and launch no
    kernel.

    ``fp``: an integral config on a kernel backend runs the all-integer
    recurrence (kernels/quantized.py); any other config, and every config
    on ``backend="xla"``, the f32 emulation.
    """
    schedule = _resolve(schedule, block_batch, default_bb=8)
    if fp is not None:
        if is_native_int(fp) and schedule.use_pallas:
            return quantized_rglru_scan(a, bx, fp=fp, schedule=schedule)
        return _rglru_emulated(a, bx, fp)
    if not schedule.use_pallas or schedule.mode in ("nonstatic", "pipeline"):
        # non-static / pipeline: one block per timestep, the unrolled f32
        # chain of torch ops, which is the reference's own loop
        return ref.rglru_scan_ref(a, bx)
    B, _, W = a.shape
    bb, bw, serial = rglru_tiles(schedule, B, W, block_width)
    return rglru_scan_kernel(a.contiguous(), bx.contiguous(), block_batch=bb,
                             block_width=bw, serial_width=serial)


def rglru_tiles(schedule: KernelSchedule, B: int, W: int,
                block_width: int = 128) -> Tuple[int, int, bool]:
    """(batch tile, width tile, serial width) of the static RG-LRU kernel:
    bb = min(block_batch, B), bw = min(block_width, ceil(W / R)), the
    width tiles walked in order at R > 1."""
    reuse = schedule.reuse_factor
    bb = min(schedule.block_batch, max(1, B))
    bw = min(block_width, -(-W // reuse))  # ceil: R sequential width tiles
    return bb, bw, reuse > 1


# kernel name -> (scheduled entry point, golden reference)
SCHEDULED_KERNELS = {
    "lstm": (lstm_scan, ref.lstm_scan_ref),
    "gru": (gru_scan, ref.gru_scan_ref),
    "rglru": (rglru_scan, ref.rglru_scan_ref),
    "reuse_matmul": (reuse_matmul, ref.reuse_matmul_ref),
}
