"""Launch layout of the cluster scan kernels (``lstm_scan`` / ``gru_scan``,
and the hoisted and pipeline scans of both cells on the kernel's zx
mode).

The in-loop static scans (``csrc/rnn_scan.cu``, ``cluster_scan_kernel``)
run one thread-block cluster of ``cluster`` CTAs per tile of ``rows`` (1 or
8) batch rows.  CTA c of a cluster owns the hidden units [c*u, (c+1)*u),
u = ceil(H / C), with all G gate columns of each, and every CTA keeps the
tile's full h, double-buffered.  Each unit's recurrent products are split
over ``k_split`` neighbouring lanes: lane s holds the U rows k = s,
s + k_split, ... of its unit's G columns in registers (at most 16), so no
step reads U from memory.  So the cluster kernel takes H up to
:data:`MAX_CLUSTER_HIDDEN` = 128 (8 lanes x 16 rows; 16 lanes would need
more than 256 threads a CTA past it), and :func:`scan_layout` refuses a
larger H.  ``repro``'s Pallas kernel takes any H, and so does the port on
the card: :func:`scan_route` sends a larger H to the input side as one
``col_matmul`` and the recurrence to the hoisted scan kernel.

:func:`scan_layout` picks the layout from the shapes and from how many
clusters of each candidate the card holds at once: on the card the C
library's ``cudaOccupancyMaxActiveClusters`` answers
(:func:`card_resident`), on the CPU :func:`model_resident`.  The C launcher
refuses a layout the kernel cannot run (``cudaErrorInvalidValue``).

The hoisted variant (``hoisted=True``: the zx mode, which reads
precomputed zx in place of the in-kernel x W) follows the same rules; it
has no x side, and its shared memory holds a bias row and three zx
buffers of [rows, G, u] where the in-loop kernel holds W, the biases and
three x buffers.  Four scans run on it up to :data:`MAX_CLUSTER_HIDDEN`
(:data:`ZX_CLUSTER`): both hoisted scans and both pipeline scans, which
run the one-pass instance at every R on R = 1's layout.
:func:`launch_hoisted_scan` routes every scan of zx (any H past the
cluster kernel's goes to the block kernel) and launches it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import cuda

#: shared memory one block may use on an H100 (227 KiB)
SMEM_LIMIT = 232_448
#: H100 SXM streaming multiprocessors: one wave is at most this many CTAs
SMS = 132
MAX_THREADS = 256                   # the kernel's __launch_bounds__

CLUSTERS = (1, 2, 4, 8)             # 8: the portable maximum
ROWS = (1, 8)                       # batch rows a cluster carries
MAX_K = 16                          # U rows a lane holds in registers
K_SPLITS = (2, 8)
#: the largest H the cluster kernel takes: MAX_K U rows on each of a unit's
#: K_SPLITS[-1] lanes
MAX_CLUSTER_HIDDEN = MAX_K * K_SPLITS[-1]
#: x values each thread loads a step, at most
X_PER_THREAD = 4
#: the scans of zx precomputed, which run on the cluster kernel's zx mode
#: up to MAX_CLUSTER_HIDDEN and on the block kernel past it
ZX_CLUSTER = ("lstm_scan_hoisted", "gru_scan_hoisted", "lstm_scan_pipeline",
              "gru_scan_pipeline")
GATE_SLOTS = 4                      # W / b padded to 4 gates a unit


class ScanLayout(NamedTuple):
    cluster: int                    # CTAs per cluster (C)
    rows: int                       # batch rows per cluster (bt)
    k_split: int                    # lanes a unit's k loop is split over
    threads: int                    # threads per CTA
    smem_bytes: int                 # dynamic shared memory per CTA
    clusters: int                   # clusters in the grid: ceil(B / rows)

    @property
    def ctas(self) -> int:
        return self.clusters * self.cluster


def gates(cell: str) -> int:
    if cell not in ("lstm", "gru"):
        raise ValueError(f"cell must be 'lstm' or 'gru', not {cell!r}")
    return 4 if cell == "lstm" else 3


def units_per_cta(hidden: int, cluster: int) -> int:
    return -(-hidden // cluster)


def k_split_for(hidden: int) -> Optional[int]:
    """The fewest lanes in ``K_SPLITS`` that hold a unit's H U rows at
    ``MAX_K`` a lane (None: H is too large)."""
    return next((ks for ks in K_SPLITS if ks * MAX_K >= hidden), None)


def h_stride(rows: int) -> int:
    """Floats per h row (one k) in shared memory: 8 rows padded to 12."""
    return 12 if rows == 8 else rows


def smem_bytes(cell: str, hidden: int, fin: int, cluster: int,
               k_split: int, rows: int, hoisted: bool = False) -> int:
    """Two mbarriers (4 floats) | W [in, u, 4] | b [1 or 2, u, 4] |
    h [2, 16 * k_split, h_stride(rows)] | x [3, rows, in], f32 (the kernel
    carves the same regions).  ``hoisted``: no W, one bias row, and zx
    buffers [3, rows, G, u] in place of x (``fin`` is ignored)."""
    u = units_per_cta(hidden, cluster)
    if hoisted:
        fin, bias_rows, x_floats = 0, 1, 3 * rows * gates(cell) * u
    else:
        bias_rows = 1 if gates(cell) == 4 else 2
        x_floats = 3 * rows * fin
    floats = (4 + (fin + bias_rows) * u * GATE_SLOTS
              + 2 * MAX_K * k_split * h_stride(rows) + x_floats)
    return 4 * floats


def threads_for(units: int, k_split: int) -> int:
    return -(-units * k_split // 32) * 32


def _candidate(B, hidden, fin, cell, cluster, rows, hoisted=False):
    u = units_per_cta(hidden, cluster)
    ks = k_split_for(hidden)
    if ks is None or cluster > hidden or (cluster - 1) * u >= hidden:
        return None
    threads = threads_for(u, ks)
    smem = smem_bytes(cell, hidden, fin, cluster, ks, rows, hoisted)
    if (threads > MAX_THREADS or smem > SMEM_LIMIT
            or (not hoisted and rows * fin > X_PER_THREAD * threads)):
        return None
    return ScanLayout(cluster, rows, ks, threads, smem, -(-B // rows))


def scan_route(hidden: int) -> str:
    """The path a static in-loop scan of ``hidden`` units takes on the card:
    ``"cluster"`` (the cluster kernel, ``lstm_scan`` / ``gru_scan``) up to
    :data:`MAX_CLUSTER_HIDDEN`, else ``"hoisted"``: the input side of every
    step as one ``col_matmul``, then ``lstm_scan_hoisted`` /
    ``gru_scan_hoisted`` over it."""
    return "cluster" if hidden <= MAX_CLUSTER_HIDDEN else "hoisted"


def model_resident(lay: ScanLayout, sms: int = SMS) -> int:
    """The clusters of ``lay`` an H100 holds at once, as a model for where
    no card answers (the CPU tests): every thread at the 255 registers
    ``__launch_bounds__(256)`` allows (8192 a warp, 8 warps an SM), at most
    32 CTAs an SM, every SM usable.  The card's answer differs both ways
    (fewer registers than 255; SMs a cluster cannot use): on the card
    :func:`card_resident` asks the CUDA runtime instead, and ``chip_smoke.py``
    prints both."""
    warps = -(-lay.threads // 32)
    ctas_per_sm = min(32, 65536 // (warps * 8192))
    return sms * ctas_per_sm // lay.cluster


def scan_layout(B: int, hidden: int, fin: int, cell: str, reuse: int = 1,
                *, resident: Optional[Callable[[ScanLayout], int]] = None,
                hoisted: bool = False) -> ScanLayout:
    """The layout of one static in-loop scan of ``B`` rows: of the rows a
    cluster (1 or 8) and cluster sizes that fit a CTA, the one that runs in
    the fewest waves (``resident(layout)``: the clusters the card holds at
    once; default :func:`model_resident`), then gives each CTA the least
    work (rows x units).  At B = 8 that is a cluster per row; at QuickDraw's
    B = 256 two clusters' CTAs share an SM and hide each other's waits.
    ``hoisted``: the layout of the hoisted scan (zx mode) by the same
    rules; ``fin`` is then ignored."""
    G = gates(cell)
    if B < 1 or hidden < 1 or fin < 0:
        raise ValueError(f"scan_layout: B={B}, H={hidden}, in={fin}")
    if reuse < 1 or (G * hidden) % reuse:
        raise ValueError(f"scan_layout: reuse {reuse} does not divide "
                         f"{G}h = {G * hidden}")
    cands = [lay for rows in ROWS for c in CLUSTERS
             if (lay := _candidate(B, hidden, fin, cell, c, rows, hoisted))
             is not None]
    if not cands:
        raise ValueError(f"scan_layout: no cluster layout fits {cell} "
                         f"H={hidden} in={fin} (H <= "
                         f"{MAX_CLUSTER_HIDDEN}, at most {MAX_THREADS} "
                         f"threads and {SMEM_LIMIT} bytes a CTA)")
    resident = resident or model_resident

    def cost(lay):
        fit = resident(lay)
        if fit < 1:                 # never co-resident: not a candidate
            return (float("inf"), 0)
        waves = -(-lay.clusters // fit)
        return (waves,
                waves * lay.rows * units_per_cta(hidden, lay.cluster))

    best = min(cands, key=cost)
    if cost(best)[0] == float("inf"):
        raise ValueError(f"scan_layout: no cluster of {cell} H={hidden} "
                         f"in={fin} is resident on this card")
    return best


def card_resident(cell: str, bf16: bool, reuse: int,
                  lay: ScanLayout, hoisted: bool = False) -> int:
    """Clusters of ``lay`` the current CUDA device holds at once, from the
    C library (``cudaOccupancyMaxActiveClusters`` for the kernel that runs
    that layout; ``hoisted``: the zx mode, ``bf16`` its output's type; at
    ``reuse`` 1 the one-pass instance, which the pipeline scan runs)."""
    lib = cuda.library("rnn_scan")
    cuda.COUNTS["residency"] += 1
    query = (lib.cluster_zx_scan_resident if hoisted
             else lib.cluster_scan_resident)
    n = query(int(cell == "gru"), int(bf16), reuse, *lay[:5])
    if n < 0:
        raise RuntimeError(f"{cell}_scan: residency of {tuple(lay)}: CUDA "
                           f"error {-n}: "
                           f"{lib.kernel_error_string(-n).decode()}")
    return n


@functools.lru_cache(maxsize=1024)
def card_layout(B: int, hidden: int, fin: int, cell: str, reuse: int,
                bf16: bool, device_index: int, hoisted: bool = False
                ) -> ScanLayout:
    """:func:`scan_layout` with the residency the current CUDA device
    reports (:func:`card_resident`), remembered per shape and device (the
    query, like the launch, runs on the current device)."""
    kw = {"hoisted": True} if hoisted else {}
    return scan_layout(B, hidden, fin, cell, reuse,
                       resident=functools.partial(card_resident, cell, bf16,
                                                  reuse, **kw),
                       hoisted=hoisted)


#: launch layouts loaded from compile cache entries: :func:`card_layout`'s
#: arguments -> layout (a warm serving executor asks the card nothing)
SEEDED: Dict[tuple, ScanLayout] = {}


def launch_layout(*args) -> ScanLayout:
    """The layout a launch takes: a seeded one (:data:`SEEDED`), else
    :func:`card_layout` of the same arguments; noted in every
    ``cuda.recording``."""
    lay = SEEDED.get(args)
    if lay is None:
        lay = card_layout(*args)
    cuda.record_layout(args, lay)
    return lay


def launch_scan(cell: str, xs: torch.Tensor, W: torch.Tensor,
                U: torch.Tensor, b: torch.Tensor, reuse: int) -> torch.Tensor:
    """Launch ``lstm_scan`` / ``gru_scan`` on CUDA tensors (shapes checked
    by the caller) at :func:`scan_layout`'s layout for this card (computed
    once per shape and device, or loaded from a compile cache entry:
    :func:`launch_layout`)."""
    kernel = f"{cell}_scan"
    dev = cuda.require(kernel, xs.dtype, xs=xs, W=W, U=U, b=b)
    B, T, fin = xs.shape
    hidden = U.shape[0]
    out = torch.empty(B, hidden, dtype=xs.dtype, device=dev)
    if B:
        bf16 = xs.dtype == torch.bfloat16
        lay = launch_layout(B, hidden, fin, cell, reuse, bf16, dev.index,
                            False)
        cuda.launch("rnn_scan", kernel, dev, xs.data_ptr(), int(bf16),
                    W.data_ptr(), U.data_ptr(), b.data_ptr(),
                    out.data_ptr(), B, T, fin, hidden, reuse, *lay[:5])
    return out


def launch_hoisted_scan(kernel: str, zx: torch.Tensor, U: torch.Tensor,
                        b: torch.Tensor, reuse: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``kernel``, a scan of zx precomputed (``<cell>_scan_hoisted``
    or ``<cell>_scan_pipeline``; CUDA tensors, shapes checked by the
    caller), by its route.  The kernels of :data:`ZX_CLUSTER` run on the
    cluster kernel's zx mode up to :data:`MAX_CLUSTER_HIDDEN`, at
    :func:`scan_layout`'s hoisted layout for this card; a pipeline scan
    runs the one-pass instance at every R, so its layout (and the
    residency asked for it) is R = 1's.  Past that H the block kernel runs
    them (``<kernel>_block``, counted as ``kernel``).  No fallback: a
    refused launch raises.  zx: [B, T, G*h] f32; b: the LSTM's b or the
    GRU's b_rec."""
    cell = kernel.split("_", 1)[0]
    dev = cuda.require(kernel, out_dtype, zx=zx, U=U, b=b)
    B, T, _ = zx.shape
    hidden = U.shape[0]
    out = torch.empty(B, hidden, dtype=out_dtype, device=dev)
    if not B:
        return out
    bf16 = out_dtype == torch.bfloat16
    args = (zx.data_ptr(), U.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(bf16), B, T, hidden, reuse)
    if scan_route(hidden) == "cluster":
        lay_reuse = 1 if kernel.endswith("_pipeline") else reuse
        lay = launch_layout(B, hidden, 0, cell, lay_reuse, bf16, dev.index,
                            True)
        cuda.launch("rnn_scan", kernel, dev, *args, *lay[:5])
    else:
        cuda.launch("rnn_scan", f"{kernel}_block", dev, *args,
                    count_as=kernel)
    return out
