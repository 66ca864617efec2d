#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit and builds every CUDA kernel
     from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel;
     timed);
  2. holds each of the thirteen kernels against its plain PyTorch version
     on the card, at the main path's shapes of all six taggers (B = 256,
     R in {1, 4}, float32 and bfloat16): the static, hoisted and pipeline
     scans, the static in-loop scans (the thread-block-cluster kernels
     ``lstm_scan`` / ``gru_scan``) also at predict_one's B = 8 and a
     ragged B = 9, and checks that their C entry points refuse a bad
     cluster layout (``cudaErrorInvalidValue``, no launch); ``col_matmul``
     (the tiled f32 product: 16 TM x 8 TN outputs a CTA of 128 threads, TM
     x TN in {2x4, 1x4, 1x2, 1x1} by shape, K in chunks of 64 through a
     4-slot cp.async ring) at each step's x-side and h-side product, at the
     hoist stage's [256*T, in] product (R = 2), at ragged shapes (M in {1,
     9}, K in {3, 20}, N/R down to 15) and at a 128 x 1024 f32 weight (512
     KiB, over a block's shared memory); ``reuse_matmul`` (the same tiled
     body as one tile of all N columns over all of K at every R) at QuickDraw's
     h-side shape, at ``RAGGED_PRODUCTS`` with K and N swapped and at a K
     of 520 (K/R = 130), float32 and bfloat16, R in {1, 2, 4}, R = 2 and 4
     bit for bit equal to R = 1; ``quant_matmul`` (tolerance 0; 32 x 32
     outputs a CTA of four warps on int8 ``mma.sync`` m16n8k32, K in chunks
     of 128 through the same ring) at every native gate product, int8 and
     int4-range operands, at the same ragged shapes and at a 512 x 1024
     int8 weight; ``fixed_point``
     (bit for bit) at QuickDraw LSTM's gate block of one step and of all T
     steps, float32 and bfloat16, for seven ap_fixed configs;
     ``decode_matmul`` (split-K: chunks folded in chunk order, in the
     block or by a fold kernel) at gemma-2b's four per-token products
     (bf16, M = 4, and q|k|v at M = 3) and at the taggers' decode-step
     products (f32, M = 1 and 256), R = 4 and a second call bit for bit
     equal to R = 1, and that its C entry point refuses a layout it cannot
     run; the hoisted and pipeline scans also at B = 8 and 9, and all
     six scans at H = 256; the hoisted and pipeline scans of both cells
     (the cluster kernel's zx mode) on their cluster entry point up to
     H = 128 and on ``<name>_block`` past it, each pipeline at every R bit
     for bit equal to R = 1 and to its cell's hoisted scan at R = 1;
     ``rglru_scan`` (bit
     for bit, R = 2 and 4 equal to R = 1) at (4, 12, 20), the ragged
     (9, 12, 200) and recurrentgemma-9b's width (8, 2048, 4096), R in
     {1, 2, 4}, float32, bfloat16 and both mixes; ``hadamard`` (bit for
     bit, and equal to ``torch.mul``) at (1500, 200) and (16384, 4096),
     float32 and bfloat16, and at (1500, 200) with operands off 16-byte
     alignment (the scalar path);
  3. drives the port's main paths, each with the launch counts set to 0
     just before it and read just after, and checks every answer against
     the same model on ``backend="xla"``:
       static   all six taggers served through ``RNNServingEngine(...,
                impl="pallas", device="cuda")`` with seeded random weights
                (``predict``, ``predict_one``, ``submit`` / ``flush``, a
                hoisted and an R=4 schedule);
       modes    the same taggers in non-static mode (``predict`` and one
                ``submit`` / ``flush``), non-static with the hoist,
                pipeline at R = 1 and R = 4, and the hoist stage at
                ``hoist_reuse = 2``;
       matmul   the scheduled matmul entry point ``ops.reuse_matmul``;
       static_wide  static ``ops.lstm_scan`` / ``ops.gru_scan`` at H = 256,
                past the cluster kernel's H, at B = 8 and 256: one
                ``col_matmul`` and one ``*_scan_hoisted`` a call, within
                3e-5 of ``backend="xla"``;
       fixed_point  the six taggers with PTQ'd weights through
                ``RNNServingEngine(..., fp=ap_fixed<8,3>)`` and
                ``fp=ap_fixed<4,2>`` (the native int8 / int4 datapath, every
                gate product on ``quant_matmul``), each answer bit for bit
                equal to the same engine on ``backend="xla"``; then
                ``fp=ap_fixed<16,6>`` on the emulation cells (no kernel);
       ops_fixed_point  ``ops.fixed_point`` on a CUDA tensor;
       lm_decode  gemma-2b at its published width and depth (18 layers,
                d_model 2048, bf16, seeded weights drawn on the card)
                served through ``LMServingEngine(device="cuda")``: 4
                requests of 8 prompt + 8 new tokens on keys R = 1, R = 4
                (every projection on ``decode_matmul``, 72 calls a tick,
                and in a trace of one tick exactly the device kernels their
                layouts launch) and the default key (einsum); R = 1 and
                R = 4 give the same tokens and first-step logits bit for
                bit, the einsum logits agree within 2e-2; one executor per
                key;
       rnn_decode  the six taggers at B = 256 as T chained
                ``rnn_decode_step`` calls: float (``decode_matmul``) vs the
                xla scan, ``ap_fixed<8,3>`` (``quant_matmul``) bit for bit
                equal to the emulation, ``ap_fixed<16,6>`` vs xla;
       rglru    ``SCHEDULED_KERNELS["rglru"]`` at recurrentgemma-9b's width
                (a, bx [8, 2048, 4096] f32): static R = 1 and R = 4 (one
                ``rglru_scan`` launch each), non-static and pipeline (no
                launch), all bit for bit equal to ``backend="xla"``; native
                ``ap_fixed<8,3>`` equal in value to the emulation; then
                ``ops.hadamard`` at (16384, 4096) bf16 (one ``hadamard``
                launch, bit for bit equal to ``torch.mul``);
     and checks that every kernel of each path was launched (``static``:
     each tagger's hoisted flush on the cluster kernel; ``modes``: every
     tagger's two pipelines and the hoisted scans on it; ``static_wide``:
     both hoisted scans on the block kernel);
  4. times each kernel (CUDA events around back-to-back calls, and the
     device's own time per call from a ``torch.profiler`` trace; the
     cluster scans at B = 256 and B = 8, with their cluster layout) beside
     its plain version, one PyTorch library call for the same function
     (cuDNN's ``LSTM`` / ``GRU`` for the scans, ``torch.matmul`` for the
     products, ``torch._int_mm`` for ``quant_matmul`` where it takes the
     shape and an f32 ``torch.matmul`` of the same integers elsewhere,
     ``fake_quantize_per_tensor_affine`` for ``fixed_point``,
     ``torch.mul`` for ``hadamard``; none for ``rglru_scan``: no single
     PyTorch call computes a linear recurrence) and its bound on the card
     (``col_matmul`` and ``quant_matmul`` with their launch layout, and in
     the ``kernels`` line the registers and spill bytes of every compiled
     instance from the ``-Xptxas -v`` log)
     (``decode_matmul`` at gemma-2b's products, ``rglru_scan`` and
     ``hadamard`` also with the L2 flushed before each call), whole
     QuickDraw LSTM scans end to end per mode (the native int8 scan too)
     with their launch counts and the device's idle share, whole RG-LRU
     scans at the full width per schedule, and the
     engine's tick latency and tokens/s per key with a trace of one tick;
  5. ends with the JSON result line.

Any failed check raises, so the script exits non-zero; it exits non-zero
and prints no result when no CUDA device is available.  The full timing
table is also written to ``build/chip_smoke.json``.

    python3 chip_smoke.py --time-scans [--src DIR]

only times the in-loop static scans at B = 8 and 256, and the hoisted and
pipeline scans at B = 8 and 256 and R = 1 and 4, beside cuDNN, and the six
engines' ``predict_one`` and flush latency, importing ``repro_torch``
from ``DIR`` (default: this checkout's ``src``).  Run it for an unpacked
parent commit and for this tree in turns (parent, change, change, parent)
within one call to the card to compare the two; it prints a JSON line of
its own and no result line.

    python3 chip_smoke.py --time-products [--src DIR]

likewise times only ``col_matmul``, ``reuse_matmul`` and ``quant_matmul``
at every tagger's gate products (B = 256 and 8, R = 1 and 4; events and
device ms beside ``torch.matmul`` / ``torch._int_mm``), the host path of a
call split into
its parts, whole QuickDraw LSTM non-static and native ``ap_fixed<8,3>``
scans, and the six engines' ``predict_one`` and flush of 256 in those two
modes.

    python3 chip_smoke.py --time-decode [--src DIR]

likewise times only ``decode_matmul`` at gemma-2b's four products and the
taggers' decode-step products (R = 1 and 4; events, device ms and, for
gemma-2b, device ms after an L2 flush, beside ``torch.matmul``) and
gemma-2b's decode tick per key (host-clock latency and a trace).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: tolerance per input dtype, times max(1, max |reference|): f32 accumulation
#: order differs between the kernel (per-column FMA chains) and cuBLAS; bf16
#: outputs round at 2^-8
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
BATCH = 256                      # the engine's max_batch: every flush's rows
#: the in-loop scans' other batches: predict_one's 8 rows and a ragged 9
SMALL_BATCHES = (8, 9)
#: the in-loop static scans: the thread-block-cluster kernels
CLUSTER_SCANS = ("lstm_scan", "gru_scan")
REUSES = (1, 4)
HOIST_REUSE = 2                  # the hoist stage's column tiles
ONE_CALLS = 12                   # predict_one calls per tagger (first builds)
F32_PEAK = 67e12                 # H100 SXM f32 CUDA-core peak, FLOP/s
BF16_PEAK = 989e12               # H100 SXM dense bf16 tensor-core peak
INT8_PEAK = 1979e12              # H100 SXM dense int8 tensor-core peak, OP/s
HBM_BPS = 3.35e12                # H100 SXM device memory, bytes/s
TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
#: the shape whose timings go into the result line (the largest tagger)
HEADLINE = "quickdraw"
#: reuse_matmul's shape: QuickDraw LSTM's h-side product (M, K, N)
MATMUL_SHAPE = (BATCH, 128, 512)
#: col_matmul / quant_matmul at ragged shapes: (M, K, N, R), N/R down to 15
RAGGED_PRODUCTS = tuple((M, K, 60, R) for M in (1, 9) for K in (3, 20)
                        for R in (1, 4))
#: reuse_matmul's other shapes (M, K, N): RAGGED_PRODUCTS with K and N
#: swapped, so that R divides K (K/R down to 15, N in {3, 20}), and a K past
#: the x staged once (K = 520: nine chunks of 64 through the ring)
REUSE_SHAPES = tuple(sorted({(M, N, K) for M, K, N, _ in RAGGED_PRODUCTS})
                     ) + ((BATCH, 520, 60),)
#: reuse_matmul's R: every shape at each, bit for bit equal to R = 1
REUSE_BITS = (1, 2, 4)
#: weights over a block's 227 KiB of shared memory: (M, K, N), f32 for
#: col_matmul (512 KiB), int8 for quant_matmul (512 KiB)
LARGE_PRODUCTS = {"col_matmul": (BATCH, 128, 1024),
                  "quant_matmul": (BATCH, 512, 1024)}
#: the static in-loop scans past the cluster kernel's H: (T, in, H), at B in
#: WIDE_BATCHES (served as col_matmul + the hoisted scan kernel)
WIDE_SCAN = (100, 3, 256)
WIDE_BATCHES = (8, BATCH)

SCAN_SRC = "src/repro_torch/csrc/rnn_scan.cu"
MATMUL_SRC = "src/repro_torch/csrc/reuse_matmul.cu"
QUANT_SRC = "src/repro_torch/csrc/quantized.cu"
DECODE_SRC = "src/repro_torch/csrc/decode_matmul.cu"
#: the LM served on the decode path, at its published width and depth
LM = "gemma-2b"
LM_BATCH = 4                     # LMServingEngine max_batch: a tick's rows
LM_SEQ = 64                      # max_seq of the KV cache
LM_PROMPT = 8                    # prompt tokens per request
LM_NEW = 8                       # max_new tokens per request
#: the ragged row count decode_matmul is checked at (one shape)
RAGGED_M = 3
#: (total, integer, rounding, saturation): the paper's ap_fixed<16,6>, the
#: native int8 / int4 configs, and the trn / wrap corners
FP_GRID = ((16, 6, "rnd", "sat"), (8, 3, "rnd", "sat"), (4, 2, "rnd", "sat"),
           (12, 4, "rnd", "sat"), (16, 6, "trn", "sat"),
           (8, 4, "rnd", "wrap"), (10, 3, "trn", "wrap"))
#: the native configs served on quant_matmul, and the emulated one
FP_NATIVE = {"int8": FP_GRID[1], "int4": FP_GRID[2]}
FP_EMULATED = FP_GRID[0]
#: fixed_point's shapes: QuickDraw LSTM's gate block, one step and all T
FXP_SHAPES = ((BATCH, 512), (BATCH * 100, 512))
RGLRU_SRC = "src/repro_torch/csrc/rglru_scan.cu"
HADAMARD_SRC = "src/repro_torch/csrc/hadamard.cu"
#: the RG-LRU path at recurrentgemma-9b's width (src/repro/configs/
#: recurrentgemma_9b.py: lru_width 4096, local-attention window 2048) for 8
#: sequences: a, bx [RG_B, RG_T, RG_W]
RG_B, RG_T, RG_W = 8, 2048, 4096
#: rglru_scan's checked shapes (B, T, W): small, a ragged width, full width
RGLRU_SHAPES = ((4, 12, 20), (9, 12, 200), (RG_B, RG_T, RG_W))
#: hadamard's shapes: a ragged row count, and the RG-LRU path's (B*T, W)
HADAMARD_SHAPES = ((1500, 200), (RG_B * RG_T, RG_W))
#: kernel -> (TPU kernel it replaces, source of the CUDA kernel)
KERNELS = {
    "lstm_scan": ("src/repro/kernels/lstm_scan.py:120", SCAN_SRC),
    "lstm_scan_hoisted": ("src/repro/kernels/lstm_scan.py:238", SCAN_SRC),
    "gru_scan": ("src/repro/kernels/gru_scan.py:99", SCAN_SRC),
    "gru_scan_hoisted": ("src/repro/kernels/gru_scan.py:200", SCAN_SRC),
    "lstm_scan_pipeline": ("src/repro/kernels/lstm_scan.py:197", SCAN_SRC),
    "gru_scan_pipeline": ("src/repro/kernels/gru_scan.py:164", SCAN_SRC),
    "col_matmul": ("src/repro/kernels/reuse_matmul.py:78", MATMUL_SRC),
    "reuse_matmul": ("src/repro/kernels/reuse_matmul.py:42", MATMUL_SRC),
    "quant_matmul": ("src/repro/kernels/quantized.py:114", QUANT_SRC),
    "fixed_point": ("src/repro/kernels/fixed_point.py:26", QUANT_SRC),
    "decode_matmul": ("src/repro/kernels/decode_step.py:69", DECODE_SRC),
    "rglru_scan": ("src/repro/kernels/rglru_scan.py:47", RGLRU_SRC),
    "hadamard": ("src/repro/kernels/hadamard.py:17", HADAMARD_SRC),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> tuple:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    return err, scale


def scan_inputs(cell, T, fin, H, dtype, seed, device, batch=BATCH):
    """Seeded inputs at a tagger's shapes: weights scaled like the taggers'
    initialisation (lecun kernel, unit-scale recurrent, small bias)."""
    import torch

    rng = np.random.RandomState(seed)
    g = 4 if cell == "lstm" else 3
    xs = rng.randn(batch, T, fin)
    W = rng.randn(fin, g * H) / np.sqrt(fin)
    U = rng.randn(H, g * H) / np.sqrt(H)
    b = rng.randn(*((g * H,) if cell == "lstm" else (2, g * H))) * 0.1
    as_t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
        a, dtype=dt, device=device)
    return as_t(xs, dtype), as_t(W), as_t(U), as_t(b)


def call(name, shape, kern, plain, inputs, flops, library=None,
         headline=False, peak=F32_PEAK) -> dict:
    """One kernel call: its thunk, its plain version's, the inputs and
    operations of its bound (at ``peak`` per second), and (for timing) one
    library call's thunk."""
    return {"name": name, "shape": shape, "kern": kern, "plain": plain,
            "inputs": inputs, "flops": flops, "library": library,
            "headline": headline, "peak": peak}


def scan_calls(tag, rnn, xs, W, U, b, reuse, timing=False,
               headline=True) -> list:
    """The static, hoisted and pipeline scans of ``rnn.cell`` on these
    inputs; the hoisted and pipeline kernels get zx from the port's hoist
    stage, as on the main path.  ``headline``: a QuickDraw call at R = 1
    may be the result line's."""
    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.kernels.ops import _hoist_stage
    from repro_torch.kernels.schedule import KernelSchedule

    zx = _hoist_stage(xs, W, KernelSchedule())
    od = xs.dtype
    B, T, fin = xs.shape
    H = U.shape[0]
    g = 4 if rnn.cell == "lstm" else 3
    shape = f"{tag} B={B} R={reuse}"
    head = headline and tag.startswith(HEADLINE) and reuse == 1
    f_in, f_h = 2.0 * B * T * (fin + H) * g * H, 2.0 * B * T * H * g * H

    def lib(name, args):
        return library_call(name, args) if timing else None

    c = rnn.cell
    mod = ls if c == "lstm" else gs
    hoisted_args = (zx, U, b) if c == "lstm" else \
        ((zx + b[0]).contiguous(), U, b[1].contiguous())
    out = []
    for kind, args, flops, kw in (
            ("", (xs, W, U, b), f_in, {"reuse": reuse}),
            ("_hoisted", hoisted_args, f_h, {"reuse": reuse, "out_dtype": od}),
            ("_pipeline", hoisted_args, f_h, {"reuse": reuse,
                                              "out_dtype": od})):
        name = f"{c}_scan{kind}"
        kern = getattr(mod, f"{name}_kernel")
        plain = getattr(mod, f"{name}_plain")
        out.append(call(name, shape,
                        lambda k=kern, a=args, kw=kw: k(*a, **kw),
                        lambda p=plain, a=args, kw=kw: p(*a, **kw),
                        args, flops, lib(name, args), head))
    return out


def matmul_calls(tag, rnn, xs, U, reuse, seed) -> list:
    """``col_matmul`` at one step's x-side and h-side products of a tagger
    (M = 256 rows): x_t @ W and h @ U."""
    import torch

    from repro_torch.kernels import reuse_matmul as rm

    dev, dt = xs.device, xs.dtype
    g = 4 if rnn.cell == "lstm" else 3
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    W = rand(rnn.input_size, g * rnn.hidden) / np.sqrt(rnn.input_size)
    sides = {"x-side": (xs[:, 0].contiguous(), W),
             "h-side": (torch.tanh(rand(BATCH, rnn.hidden)).to(dt), U)}
    out = []
    for side, (x, w) in sides.items():
        out.append(call(
            "col_matmul", f"{tag} {side} {tuple(x.shape)}@{tuple(w.shape)} "
            f"R={reuse}",
            lambda x=x, w=w: rm.col_matmul_kernel(x, w, reuse=reuse),
            lambda x=x, w=w: rm.col_matmul_plain(x, w, reuse=reuse),
            (x, w), 2.0 * x.shape[0] * x.shape[1] * w.shape[1],
            lambda x=x, w=w: torch.matmul(x, w),
            tag.startswith(HEADLINE) and side == "h-side" and reuse == 1
            and rnn.cell == "lstm"))
    return out


def reuse_calls(dtype, device, timing=False) -> list:
    """(R, call) for ``reuse_matmul`` (no model calls it), x and w both in
    ``dtype``: at QuickDraw's h-side shape, the result line's at R = 1
    (timing: only there, R in ``REUSES``, ``torch.matmul`` beside); else
    also at ``REUSE_SHAPES``, each shape at every R of ``REUSE_BITS`` on
    the same inputs, R = 1 first."""
    import torch

    from repro_torch.kernels import reuse_matmul as rm

    gen = torch.Generator(device=device).manual_seed(1500)
    shapes = [MATMUL_SHAPE] + ([] if timing else list(REUSE_SHAPES))
    out = []
    for M, K, N in shapes:
        x = torch.randn(M, K, generator=gen, device=device).to(dtype)
        w = (torch.randn(K, N, generator=gen, device=device)
             / np.sqrt(K)).to(dtype)
        for R in REUSES if timing else REUSE_BITS:
            out.append((R, call(
                "reuse_matmul", f"({M},{K})@({K},{N}) R={R}",
                lambda x=x, w=w, R=R: rm.reuse_matmul_kernel(x, w, reuse=R),
                lambda x=x, w=w, R=R: rm.reuse_matmul_plain(x, w, reuse=R),
                (x, w), 2.0 * M * K * N, lambda x=x, w=w: torch.matmul(x, w),
                (M, K, N) == MATMUL_SHAPE and R == 1,
                BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK)))
    return out


def hoist_call(tag, xs, W) -> dict:
    """``col_matmul`` at the hoist stage's [B*T, in] @ [in, G*h] product in
    ``HOIST_REUSE`` column tiles."""
    import torch

    from repro_torch.kernels import reuse_matmul as rm

    x = xs.reshape(-1, xs.shape[-1])
    return call("col_matmul", f"{tag} hoist {tuple(x.shape)}@"
                f"{tuple(W.shape)} R={HOIST_REUSE}",
                lambda: rm.col_matmul_kernel(x, W, reuse=HOIST_REUSE),
                lambda: rm.col_matmul_plain(x, W, reuse=HOIST_REUSE),
                (x, W), 2.0 * x.shape[0] * x.shape[1] * W.shape[1],
                lambda: torch.matmul(x, W))


def small_batch_calls(tag, r, dtype, seed, device, timing=False) -> list:
    """(R, call) for the in-loop static scan (``lstm_scan`` / ``gru_scan``)
    and the hoisted and pipeline scans of the tagger's cell (on zx from the
    port's hoist stage; :func:`scan_calls`) at the trigger's batch (B = 8:
    ``predict_one``'s padded row count) and a ragged B = 9 (timing: B = 8
    only), R in ``REUSES``."""
    out = []
    for B in SMALL_BATCHES[:1] if timing else SMALL_BATCHES:
        xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                                  dtype, seed + B, device, batch=B)
        for reuse in REUSES:
            out.extend((reuse, c) for c in scan_calls(
                tag, r, xs, W, U, b, reuse, timing, headline=False))
    return out


def wide_calls(dtype, device) -> list:
    """(tagger, R, call) for the scans of both cells at H = 256, past the
    cluster kernel's H (``WIDE_SCAN``, B in ``WIDE_BATCHES``, R in
    ``REUSES``; :func:`scan_calls`): the in-loop scan as ``col_matmul`` +
    the hoisted scan, the hoisted and pipeline scans on the block
    kernel."""
    from types import SimpleNamespace

    T, fin, H = WIDE_SCAN
    out = []
    for cell in ("lstm", "gru"):
        for B in WIDE_BATCHES:
            xs, W, U, b = scan_inputs(cell, T, fin, H, dtype, 1600 + B,
                                      device, batch=B)
            tag = f"{cell} H={H}"
            for reuse in REUSES:
                out.extend((tag, reuse, c) for c in scan_calls(
                    tag, SimpleNamespace(cell=cell), xs, W, U, b, reuse))
    return out


def product_calls(dtype, device) -> list:
    """(R, call) for ``col_matmul`` at ``RAGGED_PRODUCTS`` and at a weight
    over a block's shared memory (``LARGE_PRODUCTS``), in x's ``dtype``."""
    import torch

    from repro_torch.kernels import reuse_matmul as rm

    gen = torch.Generator(device=device).manual_seed(1400)
    M, K, N = LARGE_PRODUCTS["col_matmul"]
    shapes = list(RAGGED_PRODUCTS) + [(M, K, N, R) for R in REUSES]
    out = []
    for M, K, N, R in shapes:
        x = torch.randn(M, K, generator=gen, device=device).to(dtype)
        w = torch.randn(K, N, generator=gen, device=device) / np.sqrt(K)
        out.append((R, call(
            "col_matmul", f"({M},{K})@({K},{N}) R={R}",
            lambda x=x, w=w, R=R: rm.col_matmul_kernel(x, w, reuse=R),
            lambda x=x, w=w, R=R: rm.col_matmul_plain(x, w, reuse=R),
            (x, w), 2.0 * M * K * N)))
    return out


def all_calls(dtype, device, timing=False):
    """(tagger, R, call) for every kernel call of phases 2 and 4."""
    from repro_torch.configs import get_config

    if not timing:
        for reuse, c in product_calls(dtype, device):
            yield "products", reuse, c
        yield from wide_calls(dtype, device)
    for reuse, c in reuse_calls(dtype, device, timing):
        yield "products", reuse, c

    for i, tag in enumerate(TAGGERS):
        r = get_config(tag).rnn
        xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                                  dtype, (200 if timing else 100) + i,
                                  device)
        for reuse in REUSES:
            for c in (scan_calls(tag, r, xs, W, U, b, reuse, timing)
                      + matmul_calls(tag, r, xs, U, reuse, 300 + i)):
                yield tag, reuse, c
        for reuse, c in small_batch_calls(tag, r, dtype, 600 + 20 * i,
                                          device, timing):
            yield tag, reuse, c
        yield tag, HOIST_REUSE, hoist_call(tag, xs, W)


def fixed_point_config(spec):
    from repro_torch.config import FixedPointConfig

    total, integer, rounding, saturation = spec
    return FixedPointConfig(total, integer, rounding=rounding,
                            saturation=saturation)


def int_matmul_library(x, w):
    """``torch._int_mm`` (cuBLASLt int8 -> int32) where it takes the shape
    (M > 16, K and N multiples of 8), else an f32 ``torch.matmul`` on f32
    copies made ahead of the timed call: the same exact integer product
    while |acc| < 2^24, with TF32 off (int8 fan-ins here stay below 2^21)."""
    import torch

    (M, K), N = x.shape, w.shape[1]
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        return lambda: torch._int_mm(x, w)
    xf, wf = x.float(), w.float()
    return lambda: torch.matmul(xf, wf)


def quant_calls(device, timing=False):
    """(tagger, R, call) for ``quant_matmul`` at every native gate product
    of the six taggers (x-side and h-side, int8 and int4-range operands)
    and ``fixed_point`` at its shapes, dtypes and configs (in timing runs:
    int8 products only, and two configs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import fixed_point as fx
    from repro_torch.kernels import quantized as qm

    gen = torch.Generator().manual_seed(500 if timing else 400)
    for tag in TAGGERS:
        r = get_config(tag).rnn
        g = 4 if r.cell == "lstm" else 3
        for side, K in (("x-side", r.input_size), ("h-side", r.hidden)):
            for reuse in REUSES:
                for kind, lim in (("int8", 128), ("int4", 8)):
                    if timing and kind == "int4":
                        continue
                    x = torch.randint(-lim, lim, (BATCH, K), generator=gen,
                                      dtype=torch.int8).to(device)
                    w = torch.randint(-lim, lim, (K, g * r.hidden),
                                      generator=gen,
                                      dtype=torch.int8).to(device)
                    yield tag, reuse, call(
                        "quant_matmul", f"{tag} {side} {tuple(x.shape)}@"
                        f"{tuple(w.shape)} {kind} R={reuse}",
                        lambda x=x, w=w, R=reuse: qm.quant_matmul_kernel(
                            x, w, reuse=R),
                        lambda x=x, w=w, R=reuse: qm.quant_matmul_plain(
                            x, w, reuse=R),
                        (x, w), 2.0 * BATCH * K * w.shape[1],
                        int_matmul_library(x, w) if timing else None,
                        tag == "quickdraw-lstm" and side == "h-side"
                        and reuse == 1 and kind == "int8",
                        peak=INT8_PEAK)
    if not timing:
        M, K, N = LARGE_PRODUCTS["quant_matmul"]
        for M, K, N, R in (list(RAGGED_PRODUCTS)
                           + [(M, K, N, R) for R in REUSES]):
            x = torch.randint(-128, 128, (M, K), generator=gen,
                              dtype=torch.int8).to(device)
            w = torch.randint(-128, 128, (K, N), generator=gen,
                              dtype=torch.int8).to(device)
            yield "products", R, call(
                "quant_matmul", f"({M},{K})@({K},{N}) R={R}",
                lambda x=x, w=w, R=R: qm.quant_matmul_kernel(x, w, reuse=R),
                lambda x=x, w=w, R=R: qm.quant_matmul_plain(x, w, reuse=R),
                (x, w), 2.0 * M * K * N, peak=INT8_PEAK)
    specs = (FP_GRID[0], FP_GRID[6]) if timing else FP_GRID
    for shape in FXP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(*shape, generator=gen) * 8).to(dtype)
            x.view(-1)[::7] = torch.round(x.view(-1)[::7] * 64) / 64  # ties
            x = x.to(device)
            for spec in specs:
                fp = fixed_point_config(spec)
                lib = None
                if timing and dtype == torch.float32 and spec[2:] == (
                        "rnd", "sat"):
                    from repro_torch.core.quant.fixed_point import \
                        grid_constants

                    scale, lo, hi = grid_constants(fp)
                    lib = (lambda x=x, s=1.0 / scale, lo=int(lo), hi=int(hi):
                           torch.fake_quantize_per_tensor_affine(
                               x, s, 0, lo, hi))
                yield "quickdraw-lstm", 1, call(
                    "fixed_point", f"{tuple(shape)} {str(dtype)[6:]} "
                    f"ap{'_'.join(map(str, spec))}",
                    lambda x=x, fp=fp: fx.fixed_point_kernel(x, fp),
                    lambda x=x, fp=fp: fx.fixed_point_plain(x, fp),
                    (x,), 0.0, lib,
                    shape == FXP_SHAPES[1] and dtype == torch.float32
                    and spec == FP_GRID[0])


def lm_products(cfg) -> dict:
    """The four per-token products of one decoder layer: (K, N)."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"q|k|v": (d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
            "o": (cfg.n_heads * hd, d),
            "gate|up": (d, 2 * cfg.d_ff),
            "down": (cfg.d_ff, d)}


def decode_calls(device, timing=False):
    """(tagger or model, R, call) for ``decode_matmul`` at gemma-2b's four
    per-token products (bf16, M = ``LM_BATCH``; in checks also the q|k|v
    product at a ragged M) and at the six taggers' decode-step products
    (f32, x-side and h-side, M = 1 and ``BATCH``), each at R = 1 and 4
    on the same inputs.  Inputs are drawn on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_step as ds

    gen = torch.Generator(device=device).manual_seed(600 if timing else 500)
    cases = []
    for prod, (K, N) in lm_products(get_config(LM)).items():
        cases.append((f"{LM} {prod}", LM_BATCH, K, N, torch.bfloat16,
                      prod == "gate|up"))
        if prod == "q|k|v" and not timing:
            cases.append((f"{LM} {prod}", RAGGED_M, K, N, torch.bfloat16,
                          False))
    for tag in TAGGERS:
        r = get_config(tag).rnn
        g = 4 if r.cell == "lstm" else 3
        for side, K in (("x-side", r.input_size), ("h-side", r.hidden)):
            for M in (1, BATCH):
                cases.append((f"{tag} {side}", M, K, g * r.hidden,
                              torch.float32, False))
    for what, M, K, N, dt, head in cases:
        x = torch.randn(M, K, generator=gen, device=device).to(dt)
        w = (torch.randn(K, N, generator=gen, device=device)
             / np.sqrt(K)).to(dt)
        for reuse in REUSES:
            yield what, reuse, call(
                "decode_matmul", f"{what} ({M},{K})@({K},{N}) R={reuse}",
                lambda x=x, w=w, R=reuse: ds.decode_matmul_kernel(
                    x, w, reuse=R),
                lambda x=x, w=w, R=reuse: ds.decode_matmul_plain(
                    x, w, reuse=R),
                (x, w), 2.0 * M * K * N,
                (lambda x=x, w=w: torch.matmul(x, w)) if timing else None,
                head and reuse == 1,
                BF16_PEAK if dt == torch.bfloat16 else F32_PEAK)


def rglru_inputs(B, T, W, dtype, gen, device, bx_dtype=None):
    """Seeded RG-LRU inputs drawn on the card, as ``repro.testing``'s: the
    decay a = exp(-|n|) in (0, 1], the gated input bx ~ N(0, 1)."""
    import torch

    a = torch.exp(-torch.randn(B, T, W, generator=gen, device=device).abs())
    bx = torch.randn(B, T, W, generator=gen, device=device)
    return a.to(dtype), bx.to(bx_dtype or dtype)


def elementwise_calls(device, timing=False):
    """(shape, R, call) for ``rglru_scan`` at ``RGLRU_SHAPES`` and R in {1, 2,
    4} (tiles as ``ops.rglru_scan`` picks them for a static schedule; in
    checks also both mixes of bf16 and f32 at the ragged shape) and
    ``hadamard`` at ``HADAMARD_SHAPES``; f32 and bf16.  No single PyTorch
    call computes a linear recurrence, so ``rglru_scan`` has no library
    call; ``hadamard``'s is ``torch.mul``."""
    import torch

    from repro_torch.kernels import hadamard as hd
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels.ops import rglru_tiles
    from repro_torch.kernels.schedule import KernelSchedule

    gen = torch.Generator(device=device).manual_seed(900 if timing else 800)
    pairs = [(dt, dt) for dt in (torch.float32, torch.bfloat16)]
    if not timing:
        pairs += [(torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16)]
    for B, T, W in RGLRU_SHAPES:
        for dt, bdt in pairs:
            if bdt != dt and (B, T, W) != RGLRU_SHAPES[1]:
                continue
            a, bx = rglru_inputs(B, T, W, dt, gen, device, bdt)
            mix = "" if bdt == dt else f"/{str(bdt)[6:]}"
            for reuse in (1, 2, 4):
                bb, bw, serial = rglru_tiles(
                    KernelSchedule(reuse_factor=reuse), B, W)
                kw = {"block_batch": bb, "block_width": bw,
                      "serial_width": serial}
                yield (B, T, W), reuse, call(
                    "rglru_scan", f"({B},{T},{W}) {str(dt)[6:]}{mix} "
                    f"bw={bw} R={reuse}",
                    lambda a=a, bx=bx, kw=kw: rg.rglru_scan_kernel(a, bx,
                                                                   **kw),
                    lambda a=a, bx=bx: rg.rglru_scan_plain(a, bx),
                    (a, bx), 2.0 * B * T * W, None,
                    W == RG_W and reuse == 1 and dt == torch.float32)
    for shape in HADAMARD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, generator=gen, device=device).to(dt)
            y = torch.randn(*shape, generator=gen, device=device).to(dt)
            yield shape, 1, call(
                "hadamard", f"{shape} {str(dt)[6:]}",
                lambda x=x, y=y: hd.hadamard_kernel(x, y),
                lambda x=x, y=y: hd.hadamard_plain(x, y),
                (x, y), float(x.numel()), lambda x=x, y=y: torch.mul(x, y),
                shape == HADAMARD_SHAPES[-1] and dt == torch.float32)
    if not timing:
        # operands 4 bytes off 16-byte alignment take the scalar path
        rows, cols = HADAMARD_SHAPES[0]
        base = torch.randn(2, rows * cols + 1, generator=gen, device=device)
        x, y = (v[1:].view(rows, cols) for v in base)
        yield (rows, cols), 1, call(
            "hadamard", f"({rows}, {cols}) float32 unaligned",
            lambda: hd.hadamard_kernel(x, y), lambda: hd.hadamard_plain(x, y),
            (x, y), float(x.numel()), lambda: torch.mul(x, y))


def same_bits(got, want) -> bool:
    """Equal bit for bit (int32 products; float32 / bfloat16 as raw bits,
    so the sign of a zero counts)."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.is_floating_point():
        view = torch.int16 if got.element_size() == 2 else torch.int32
        got, want = got.view(view), want.view(view)
    return torch.equal(got, want)


def library_call(name, inputs):
    """One PyTorch call computing the same function as scan kernel ``name``
    on its ``inputs`` (cuDNN's LSTM / GRU), used only as a yardstick.
    torch's LSTM gate order i|f|g|o equals Keras i|f|c|o (bias_hh = 0); its
    GRU is reset_after with gates r|z|n, a permutation of Keras z|r|hh.  The
    hoisted and pipeline kernels' function (final h from precomputed zx) is
    the same cell with an identity input weight."""
    import torch

    hoisted = not name.endswith("_scan")
    if hoisted:
        xs, U, b = inputs
    else:
        xs, W, U, b = inputs
    H = U.shape[0]
    dev = xs.device
    if name.startswith("lstm"):
        mod = torch.nn.LSTM(xs.shape[-1], H, batch_first=True).to(dev)
        w_ih = torch.eye(4 * H, device=dev) if hoisted else W.t()
        w_hh, b_ih, b_hh = U.t(), b, torch.zeros_like(b)
    else:
        mod = torch.nn.GRU(xs.shape[-1], H, batch_first=True).to(dev)
        perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                          torch.arange(2 * H, 3 * H)]).to(dev)
        w_ih = (torch.eye(3 * H, device=dev) if hoisted else W.t())[perm]
        w_hh = U.t()[perm]
        if hoisted:                       # b is b_rec; b_in is in zx
            b_ih, b_hh = torch.zeros(3 * H, device=dev), b[perm]
        else:
            b_ih, b_hh = b[0][perm], b[1][perm]
    with torch.no_grad():
        mod.weight_ih_l0.copy_(w_ih)
        mod.weight_hh_l0.copy_(w_hh)
        mod.bias_ih_l0.copy_(b_ih)
        mod.bias_hh_l0.copy_(b_hh)
    x32 = xs.float()
    if name.startswith("lstm"):
        return lambda: mod(x32)[1][0][0]      # h_n of (out, (h_n, c_n))
    return lambda: mod(x32)[1][0]             # h_n of (out, h_n)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (weights stay hot in L2, as
    they do across a stream of serving requests)."""
    import torch

    with torch.inference_mode():
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


#: device kernel name fragment -> what launched it, for the trace readings
KERNEL_GROUPS = (("cluster_scan_kernel", "cluster scan kernels"),
                 ("rglru_scan_kernel", "rglru_scan"),
                 ("hadamard_kernel", "hadamard"),
                 ("decode_matmul", "decode_matmul"),   # and its fold
                 ("col_matmul_kernel", "col_matmul"),
                 ("reuse_matmul_kernel", "reuse_matmul"),
                 ("quant_matmul_kernel", "quant_matmul"),
                 ("fixed_point_kernel", "fixed_point"),
                 ("rnn_scan_kernel", "scan kernels"))


def device_trace(fn, calls: int = 1) -> dict:
    """Read ``calls`` calls of ``fn`` from a ``torch.profiler`` trace of the
    device: the span from the first device event to the last, the time
    some device event ran (the union of their intervals) and its idle
    share, and per group of kernels the launches and their device time.
    Empty where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    if not events:
        return {}
    busy, end = 0.0, events[0][0]
    groups: dict = {}
    for start, stop, name in events:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        group = next((g for frag, g in KERNEL_GROUPS if frag in name),
                     "other")
        n, us = groups.get(group, (0, 0.0))
        groups[group] = (n + 1, us + stop - start)
    span = end - events[0][0]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span if span else 0.0,
            "kernels": {g: {"launches": n, "device_ms": us / 1e3}
                        for g, (n, us) in groups.items()}}


def bound(inputs, out, flops, peak=F32_PEAK):
    """(bound_ms, bound_by, bytes): the larger of the bytes each input read
    once and the output written once over device-memory bandwidth, and the
    operations over ``peak``, the card's rate for the operands' type: the
    bf16 tensor-core peak for a product of two bf16 operands, the int8
    tensor-core peak for ``quant_matmul``, else the f32 CUDA-core peak."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def phase_kernels(device) -> dict:
    """Every kernel against its plain version at every main-path shape."""
    import torch

    from repro_torch.kernels import cuda

    errs: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        first_pass: dict = {}               # reuse_matmul at R = 1, a shape
        for tag, reuse, c in all_calls(dtype, device):
            cuda.reset_launches()
            with torch.inference_mode():
                got = c["kern"]()
                torch.cuda.synchronize()
                want = c["plain"]()
            if c["name"].endswith(("_hoisted", "_pipeline")):
                # H <= 128: the cluster kernel's zx mode, never the block
                entry = zx_entry(c["name"], c["inputs"][1].shape[0])
                check(cuda.ENTRIES == {entry: 1},
                      f"{c['name']} {c['shape']}: entries "
                      f"{cuda.ENTRIES}, expected one {entry}")
            if c["name"].endswith("_pipeline"):
                check_pipeline_bits(c, got)
            if c["name"] == "reuse_matmul":
                # every output sums its K products in k order at any R
                key = c["shape"].rsplit(" R=", 1)[0]
                same = same_bits(got, first_pass.setdefault(key, got))
                print(f"check reuse_matmul {c['shape']:44s} "
                      f"{str(dtype)[6:]:8s}: bits equal to R=1: {same}")
                check(same, f"reuse_matmul {c['shape']} {dtype}: R={reuse} "
                      f"differs from R=1")
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"{c['name']} {c['shape']}: {got.dtype} "
                  f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
            err, scale = max_err(got, want)
            print(f"check {c['name']:18s} {c['shape']:44s} "
                  f"{str(dtype)[6:]:8s}: max_abs_err {err:.3e} "
                  f"(tol {tol * scale:.1e})")
            check(bool(np.isfinite(err)) and err <= tol * scale,
                  f"{c['name']} {c['shape']} {dtype}: err {err}")
            errs[c["name"]] = max(errs.get(c["name"], 0.0), err)
    for tag, reuse, c in quant_calls(device):
        with torch.inference_mode():
            got = c["kern"]()
            torch.cuda.synchronize()
            want = c["plain"]()
        same = same_bits(got, want)
        err = max_err(got, want)[0] if got.shape == want.shape else np.inf
        print(f"check {c['name']:18s} {c['shape']:44s}: max_abs_err "
              f"{err:.3e}, bit for bit {same} (tol 0)")
        check(same, f"{c['name']} {c['shape']}: differs from its plain "
              f"version (err {err})")
        errs[c["name"]] = max(errs.get(c["name"], 0.0), err)
    first_tile: dict = {}
    for what, reuse, c in decode_calls(device):
        with torch.inference_mode():
            got = c["kern"]()
            torch.cuda.synchronize()
            want = c["plain"]()
        dt = str(got.dtype).split(".")[1]
        tol = TOL[dt]
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"decode_matmul {c['shape']}: {got.dtype} {tuple(got.shape)}")
        err, scale = max_err(got, want)
        # every R sums each column in one order: R = 4 gives R = 1's bits,
        # and a second call the first one's
        key = c["shape"].rsplit(" R=", 1)[0]
        same = same_bits(got, first_tile.setdefault(key, got))
        with torch.inference_mode():
            again = same_bits(c["kern"](), got)
        print(f"check {c['name']:18s} {c['shape']:44s} {dt:8s}: max_abs_err "
              f"{err:.3e} (tol {tol * scale:.1e}); bits equal to R=1: "
              f"{same}, to a second call: {again}")
        check(bool(np.isfinite(err)) and err <= tol * scale,
              f"decode_matmul {c['shape']}: err {err}")
        check(same, f"decode_matmul {c['shape']}: R={reuse} differs from R=1")
        check(again, f"decode_matmul {c['shape']}: a second call differs")
        errs["decode_matmul"] = max(errs.get("decode_matmul", 0.0), err)
    check_elementwise(device, errs)
    check_bad_layouts(device)
    check(set(errs) == set(KERNELS), f"kernels checked: {sorted(errs)}")
    return errs


def zx_entry(name: str, hidden: int) -> str:
    """The C entry point that scan ``name`` of zx precomputed takes at
    ``hidden`` units: its own on the cluster kernel's zx mode up to its H,
    ``<name>_block`` past it."""
    from repro_torch.kernels.scan_layout import scan_route

    return name if scan_route(hidden) == "cluster" else f"{name}_block"


def check_pipeline_bits(c, got) -> None:
    """A pipeline scan (``lstm_scan_pipeline`` / ``gru_scan_pipeline``) at
    any R runs the one-pass instance on its cell's hoisted R = 1 layout:
    its answer ``got`` equals, bit for bit, the pipeline at R = 1 and
    ``<cell>_scan_hoisted`` at R = 1 on the same inputs (both routes)."""
    import torch

    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls

    name = c["name"]
    cell = name.split("_")[0]
    mod = ls if cell == "lstm" else gs
    kw = {"reuse": 1, "out_dtype": got.dtype}
    with torch.inference_mode():
        r1 = getattr(mod, f"{name}_kernel")(*c["inputs"], **kw)
        hoisted = getattr(mod, f"{cell}_scan_hoisted_kernel")(*c["inputs"],
                                                              **kw)
        torch.cuda.synchronize()
    same_r1, same_h = same_bits(got, r1), same_bits(got, hoisted)
    print(f"check {name} {c['shape']:44s}: bits equal to R=1: "
          f"{same_r1}, to {cell}_scan_hoisted R=1: {same_h}")
    check(same_r1, f"{name} {c['shape']}: differs from R=1")
    check(same_h, f"{name} {c['shape']}: differs from {cell}_scan_hoisted "
          f"at R=1")


#: cudaErrorInvalidValue: the C launcher's answer to a layout it refuses
INVALID_VALUE = 1


def check_bad_layouts(device) -> None:
    """The C entry points of the cluster scan kernel (``lstm_scan`` /
    ``gru_scan``, and in its zx mode the hoisted and pipeline scans of both
    cells) and ``decode_matmul``
    refuse a layout that breaks the kernel's rules with
    cudaErrorInvalidValue, and launch nothing (called directly: no launch
    is counted)."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels import scan_layout as sl

    lib = cuda.library("rnn_scan")
    B, T, fin, H = 9, 5, 6, 20
    stream = torch.cuda.current_stream(device).cuda_stream
    for name in ("lstm_scan", "gru_scan", *sl.ZX_CLUSTER):
        cell = name.split("_")[0]
        zx_mode = name in sl.ZX_CLUSTER
        xs, W, U, b = scan_inputs(cell, T, fin, H, torch.float32, 5, device,
                                  batch=B)
        out = torch.full((B, H), 7.0, device=device)
        good = sl.card_layout(B, H, 0 if zx_mode else fin, cell, 1, False,
                              device.index, zx_mode)
        bad = {
            "cluster 3": good._replace(cluster=3),
            "a CTA without units": good._replace(
                cluster=8, smem_bytes=sl.smem_bytes(cell, H, fin, 8,
                                                    good.k_split, good.rows,
                                                    zx_mode)),
            "rows 16": good._replace(rows=16),
            "k_split 1": good._replace(k_split=1),
            "k_split 4": good._replace(k_split=4),
            "threads 0": good._replace(threads=0),
            "threads 288": good._replace(threads=288),
            "smem 4 bytes short": good._replace(
                smem_bytes=good.smem_bytes - 4),
        }
        zx = torch.zeros(B, T, U.shape[1], device=device)
        b_zx = b if cell == "lstm" else b[1]          # the GRU's b_rec
        for what, lay in bad.items():
            if zx_mode:
                rc = getattr(lib, name)(
                    zx.data_ptr(), U.data_ptr(), b_zx.data_ptr(),
                    out.data_ptr(), 0, B, T, H, 1, *lay[:5], stream)
            else:
                rc = getattr(lib, name)(
                    xs.data_ptr(), 0, W.data_ptr(), U.data_ptr(),
                    b.data_ptr(), out.data_ptr(), B, T, fin, H, 1, *lay[:5],
                    stream)
            print(f"check {name} refuses layout {tuple(lay[:5])} "
                  f"({what}): error {rc}")
            check(rc == INVALID_VALUE, f"{name} took a bad layout "
                  f"({what}): returned {rc}")
        torch.cuda.synchronize()
        check(bool((out == 7.0).all()), f"{name} wrote out on a refused "
              f"launch")
    check_bad_decode_layouts(device)


def check_bad_decode_layouts(device) -> None:
    """``decode_matmul``'s C entry point refuses a layout it cannot run
    (cudaErrorInvalidValue) and writes nothing."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels import decode_step as ds

    fn = cuda.function("decode_matmul", "decode_matmul")
    stream = torch.cuda.current_stream(device).cuda_stream
    M, K, N = LM_BATCH, 2048, 512
    gen = torch.Generator(device=device).manual_seed(77)
    x = torch.randn(M, K, generator=gen, device=device).bfloat16()
    wbig = torch.randn(K * N + 8, generator=gen, device=device).bfloat16()
    w = wbig[:K * N].view(K, N)
    good = ds.decode_layout(M, K, N, 1, True)
    ws = torch.empty(good.chunks, M, N, device=device)
    out = torch.full((M, N), 7.0, device=device).bfloat16()
    vec, rows, chunk, cps, warps, k_warps = good.c_args()
    check(good.splits > 1, f"decode_matmul at {(M, K, N)}: one split "
          f"{good}; the workspace check needs more")
    bad = {
        "vec 3": (w, ws, (3, rows, chunk, cps, warps, k_warps)),
        "w off 16-byte alignment": (wbig[1:K * N + 1].view(K, N), ws,
                                    good.c_args()),
        "rows 3": (w, ws, (vec, 3, chunk, cps, warps, k_warps)),
        "warps 8": (w, ws, (vec, rows, chunk, cps, 8, k_warps)),
        "k_warps 3": (w, ws, (vec, rows, chunk, cps, warps, 3)),
        "512 threads": (w, ws, (vec, rows, chunk, cps, 4, 4)),
        "chunk 0": (w, ws, (vec, rows, 0, cps, warps, k_warps)),
        "cps 0": (w, ws, (vec, rows, chunk, 0, warps, k_warps)),
        "x over 32 KiB": (w, ws, (vec, 8, chunk, K, warps, k_warps)),
        "no workspace": (w, None, good.c_args()),
    }
    for what, (wt, wst, lay) in bad.items():
        rc = fn(x.data_ptr(), wt.data_ptr(), 1, out.data_ptr(),
                0 if wst is None else wst.data_ptr(), M, K, N, 1, *lay,
                stream)
        print(f"check decode_matmul refuses layout {lay} ({what}): error "
              f"{rc}")
        check(rc == INVALID_VALUE, f"decode_matmul took a bad layout "
              f"({what}): returned {rc}")
    torch.cuda.synchronize()
    check(bool((out.float() == 7.0).all()),
          "decode_matmul wrote out on a refused launch")


def check_elementwise(device, errs: dict) -> None:
    """``rglru_scan`` and ``hadamard`` bit for bit against their plain
    versions, R = 2 and 4 against R = 1, ``hadamard`` against
    ``torch.mul``; the largest error per kernel goes into ``errs``."""
    import torch

    first_tile: dict = {}
    for shape, reuse, c in elementwise_calls(device):
        with torch.inference_mode():
            got = c["kern"]()
            torch.cuda.synchronize()
            want = c["plain"]()
            lib = c["library"]() if c["library"] else None
        same = same_bits(got, want)
        err = max_err(got, want)[0] if got.shape == want.shape else np.inf
        # the tiles change no value: R = 2 and 4 give R = 1's bits
        key = c["shape"].split(" bw=")[0]
        same_r1 = same_bits(got, first_tile.setdefault(key, got))
        same_lib = lib is None or same_bits(got, lib)
        print(f"check {c['name']:18s} {c['shape']:44s}: max_abs_err "
              f"{err:.3e}, bit for bit {same} (tol 0); equal to R=1: "
              f"{same_r1}; to torch.mul: "
              f"{'n/a' if lib is None else same_lib}")
        check(same, f"{c['name']} {c['shape']}: differs from its plain "
              f"version (err {err})")
        check(same_r1, f"{c['name']} {c['shape']}: differs from R=1")
        check(same_lib, f"{c['name']} {c['shape']}: differs from torch.mul")
        errs[c["name"]] = max(errs.get(c["name"], 0.0), err)


#: path -> calls per C entry point in its drive (``cuda.ENTRIES``)
ROUTES: dict = {}


def drive(path: str, run, kernels) -> tuple:
    """Run one main path with every launch count set to 0 just before it;
    read the counts just after and check each kernel of the path ran.
    Returns (launches, the path's result); the calls per C entry point go
    into ``ROUTES[path]``."""
    import torch

    from repro_torch.kernels import cuda

    cuda.reset_launches()
    result = run()
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    ROUTES[path] = dict(cuda.ENTRIES)
    print(f"launches on the {path} path: {launches}; C entry points "
          f"{ROUTES[path]}")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")
    return launches, result


def check_served(tag, what, g, w) -> None:
    check(g.shape == w.shape and bool(np.isfinite(g).all()),
          f"{tag} {what}: shape {g.shape} vs {w.shape}")
    err = float(np.abs(g - w).max())
    scale = max(1.0, float(np.abs(w).max()))
    check(err <= TOL["float32"] * scale,
          f"{tag} {what}: err {err} vs backend xla")


def phase_serving(device) -> dict:
    """The port's main paths, each driven with the counts set to 0."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.scan_layout import ZX_CLUSTER
    from repro_torch.kernels.schedule import KernelSchedule, schedule_key
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    hoist = KernelSchedule(hoist_input=True)
    r4 = KernelSchedule(reuse_factor=4)
    modes = {
        "nonstatic_hoist": KernelSchedule(mode="nonstatic", hoist_input=True),
        "pipeline_r1": KernelSchedule(mode="pipeline"),
        "pipeline_r4": KernelSchedule(mode="pipeline", reuse_factor=4),
        "hoist_reuse2": KernelSchedule(hoist_input=True,
                                       hoist_reuse=HOIST_REUSE),
    }
    engines = []
    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        eng = RNNServingEngine(cfg, params, impl="pallas", device=device)
        nonstatic = RNNServingEngine(cfg, params, mode="nonstatic",
                                     impl="pallas", device=device)
        ref = RNNServingEngine(cfg, params, impl="xla", device=device)
        rnn = cfg.rnn
        x = np.random.RandomState(i).randn(
            24, rnn.seq_len, rnn.input_size).astype(np.float32)
        engines.append((tag, eng, nonstatic, ref, x))

    def static_path():
        served = {}
        for tag, eng, _, _, x in engines:
            got = {
                "predict": eng.predict(x[:8]),
                "predict_r4": eng.predict(x[:8], schedule=r4),
                "predict_one": np.stack([eng.predict_one(x[j])
                                         for j in range(ONE_CALLS)]),
            }
            reqs = eng.serve(list(x[:16]))
            hreqs = eng.serve(list(x[16:]), schedules=[hoist] * 8)
            for q in reqs + hreqs:
                check(q.status == "answered",
                      f"{tag}: request {q.req_id} {q.status}: {q.error!r}")
            got["flush"] = np.stack([q.result for q in reqs])
            got["flush_hoist"] = np.stack([q.result for q in hreqs])
            served[tag] = got
        return served

    def modes_path():
        served = {}
        for tag, eng, nonstatic, _, x in engines:
            got = {"nonstatic": nonstatic.predict(x[:8])}
            for what, sched in modes.items():
                got[what] = eng.predict(x[:8], schedule=sched)
            reqs = nonstatic.serve(list(x[:16]))
            for q in reqs:
                check(q.status == "answered",
                      f"{tag}: request {q.req_id} {q.status}: {q.error!r}")
            got["nonstatic_flush"] = np.stack([q.result for q in reqs])
            served[tag] = got
        return served

    M, K, N = MATMUL_SHAPE
    gen = torch.Generator().manual_seed(7)
    mx = torch.randn(M, K, generator=gen).to(device)
    mw = (torch.randn(K, N, generator=gen) / np.sqrt(K)).to(device)
    msched = KernelSchedule(reuse_factor=4)

    def matmul_path():
        return ops.reuse_matmul(mx, mw, schedule=msched)

    launches = {}
    launches["static"], static = drive(
        "static", static_path, ("lstm_scan", "lstm_scan_hoisted",
                                "gru_scan", "gru_scan_hoisted"))
    # one hoisted flush a tagger, each on the cluster kernel's zx mode
    for cell in ("lstm", "gru"):
        kernel = f"{cell}_scan_hoisted"
        n = sum(get_config(t).rnn.cell == cell for t in TAGGERS)
        check(launches["static"][kernel] == n
              and ROUTES["static"].get(kernel) == n
              and f"{kernel}_block" not in ROUTES["static"],
              f"static: {kernel} launches {launches['static']} / "
              f"{ROUTES['static']}, expected {n} on the cluster kernel")
    launches["modes"], moded = drive(
        "modes", modes_path, ("col_matmul", "lstm_scan_pipeline",
                              "gru_scan_pipeline", "lstm_scan_hoisted",
                              "gru_scan_hoisted"))
    # pipeline R = 1 and R = 4 of each tagger, and the hoist_reuse = 2
    # flushes, on the cluster kernel's zx mode
    for cell in ("lstm", "gru"):
        kernel = f"{cell}_scan_pipeline"
        n = 2 * sum(get_config(t).rnn.cell == cell for t in TAGGERS)
        check(launches["modes"][kernel] == n,
              f"modes: {kernel} launches {launches['modes']}, expected {n}")
    for kernel in ZX_CLUSTER:
        check(ROUTES["modes"].get(kernel) == launches["modes"][kernel]
              and f"{kernel}_block" not in ROUTES["modes"],
              f"modes: {kernel} entries {ROUTES['modes']}, expected "
              f"{launches['modes'][kernel]} on the cluster kernel")
    launches["matmul"], mm = drive("matmul", matmul_path, ("reuse_matmul",))
    launches["static_wide"] = drive_wide_scans(device)

    rows = {"predict": slice(0, 8), "predict_r4": slice(0, 8),
            "predict_one": slice(0, ONE_CALLS), "flush": slice(0, 16),
            "flush_hoist": slice(16, 24), "nonstatic_flush": slice(0, 16)}
    for tag, eng, nonstatic, ref, x in engines:
        want = ref.predict(x)
        for what, g in {**static[tag], **moded[tag]}.items():
            check_served(tag, what, g, want[rows.get(what, slice(0, 8))])
        for e in (eng, nonstatic):
            for key in e._infer_cache:
                check(e.trace_count(key) == 1, f"{tag}: {key} built "
                      f"{e.trace_count(key)} times")
        rep = eng.serve_report()
        key = schedule_key(eng.resolved_schedule)
        fast = rep[key]["fast_path"]["latency_p50_s"] * 1e3
        flush = rep[key]["measured"]
        nkey = schedule_key(nonstatic.resolved_schedule)
        nflush = nonstatic.serve_report()[nkey]["measured"]
        print(f"served {tag:20s} keys={sorted(eng._infer_cache)} + "
              f"{sorted(nonstatic._infer_cache)}; predict_one p50 "
              f"{fast:.3f} ms, flush of {BATCH} rows: static request "
              f"latency p50 {flush['latency_p50_s'] * 1e3:.3f} ms, "
              f"nonstatic {nflush['latency_p50_s'] * 1e3:.3f} ms; all "
              f"answers within {TOL['float32']:.0e} of backend xla")
    mm_want = ops.reuse_matmul(mx, mw, schedule=msched.replace(backend="xla"))
    err, scale = max_err(mm, mm_want)
    print(f"served ops.reuse_matmul {tuple(mx.shape)}@{tuple(mw.shape)} "
          f"{msched.key()}: max_abs_err {err:.3e} vs backend xla")
    check(err <= TOL["float32"] * scale, f"ops.reuse_matmul: err {err}")
    return launches


def drive_wide_scans(device) -> dict:
    """Static ``ops.lstm_scan`` / ``ops.gru_scan`` at H = 256, past the
    cluster kernel's H, at B in ``WIDE_BATCHES``, driven with the counts set
    to 0: each call launches one ``col_matmul`` (the input side of every
    step) and one ``*_scan_hoisted`` and no cluster scan, and answers within
    the float32 tolerance of the same call on ``backend="xla"``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.scan_layout import scan_route
    from repro_torch.kernels.schedule import KernelSchedule

    T, fin, H = WIDE_SCAN
    check(scan_route(H) == "hoisted", f"H={H} routes to {scan_route(H)}")
    sched = KernelSchedule()
    cases = [(cell, scan_inputs(cell, T, fin, H, torch.float32, 1500 + B,
                                device, batch=B))
             for cell in ("lstm", "gru") for B in WIDE_BATCHES]

    def run():
        with torch.inference_mode():
            return [(ops.lstm_scan if cell == "lstm" else ops.gru_scan)(
                *args, schedule=sched) for cell, args in cases]

    launches, got = drive("static_wide", run, (
        "col_matmul", "lstm_scan_hoisted", "gru_scan_hoisted"))
    n = len(WIDE_BATCHES)
    want_launches = {"col_matmul": 2 * n, "lstm_scan_hoisted": n,
                     "gru_scan_hoisted": n}
    check({k: v for k, v in launches.items() if v} == want_launches,
          f"static_wide launches {launches}, expected {want_launches}")
    # past the cluster kernel's H both hoisted scans run on the block kernel
    for kernel in ("lstm_scan_hoisted", "gru_scan_hoisted"):
        check(ROUTES["static_wide"].get(f"{kernel}_block") == n
              and kernel not in ROUTES["static_wide"],
              f"static_wide: entries {ROUTES['static_wide']}, expected {n} "
              f"{kernel}_block")
    for (cell, args), g in zip(cases, got):
        scan = ops.lstm_scan if cell == "lstm" else ops.gru_scan
        with torch.inference_mode():
            want = scan(*args, schedule=sched.replace(backend="xla"))
        err, scale = max_err(g, want)
        print(f"served ops.{cell}_scan static H={H} B={args[0].shape[0]} "
              f"T={T}: max_abs_err {err:.3e} vs backend xla (tol "
              f"{TOL['float32'] * scale:.1e}), through col_matmul + "
              f"{cell}_scan_hoisted")
        check(g.shape == want.shape and bool(torch.isfinite(g).all())
              and err <= TOL["float32"] * scale,
              f"{cell}_scan H={H} B={args[0].shape[0]}: err {err}")
    return launches


FP_ONE_CALLS = 4                 # predict_one calls per fixed-point engine


def serve_fixed_point(eng, x) -> dict:
    """One engine's fixed-point calls: ``predict`` of 8 rows at R = 1 and
    R = 4, ``predict_one`` calls, one 16-request ``submit`` / ``flush``
    (padded to ``BATCH`` rows)."""
    from repro_torch.kernels.schedule import KernelSchedule

    got = {"predict": eng.predict(x[:8]),
           "predict_r4": eng.predict(x[:8],
                                     schedule=KernelSchedule(reuse_factor=4)),
           "predict_one": np.stack([eng.predict_one(x[j])
                                    for j in range(FP_ONE_CALLS)])}
    reqs = eng.serve(list(x[:16]))
    for q in reqs:
        check(q.status == "answered",
              f"request {q.req_id} {q.status}: {q.error!r}")
    got["flush"] = np.stack([q.result for q in reqs])
    return got


def phase_fixed_point(device) -> dict:
    """The fixed-point paths, each driven with the counts set to 0: the
    six taggers on the native int8 / int4 datapath (then on the emulated
    ap_fixed<16,6> cells, which launch no kernel), and ``ops.fixed_point``;
    every served answer bit for bit equal to the same engine on
    ``backend="xla"``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import ptq_quantize_model
    from repro_torch.kernels import ops
    from repro_torch.kernels.fixed_point import fixed_point_plain
    from repro_torch.kernels.schedule import schedule_key
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    specs = {**{k: fixed_point_config(v) for k, v in FP_NATIVE.items()},
             "ap16_6": fixed_point_config(FP_EMULATED)}
    engines = []
    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        x = np.random.RandomState(50 + i).randn(
            16, cfg.rnn.seq_len, cfg.rnn.input_size).astype(np.float32)
        for kind, fp in specs.items():
            q = ptq_quantize_model(params, fp)
            engines.append((tag, kind, fp, x, RNNServingEngine(
                cfg, q, impl="pallas", device=device, fp=fp),
                RNNServingEngine(cfg, q, impl="xla", device=device, fp=fp)))

    def serve(kinds):
        return {(tag, kind): serve_fixed_point(eng, x)
                for tag, kind, _, x, eng, _ in engines if kind in kinds}

    launches = {}
    launches["fixed_point"], native = drive(
        "fixed_point", lambda: serve(tuple(FP_NATIVE)), ("quant_matmul",))
    launches["fixed_point_emulated"], emulated = drive(
        "fixed_point_emulated", lambda: serve(("ap16_6",)), ())
    check(sum(launches["fixed_point_emulated"].values()) == 0,
          "the emulated ap_fixed<16,6> path launched a kernel")
    served = {**native, **emulated}
    for tag, kind, fp, x, eng, ref in engines:
        want = serve_fixed_point(ref, x)
        for what, g in served[(tag, kind)].items():
            w = want[what]
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"{tag} {kind} {what}: shape {g.shape} vs {w.shape}")
            check(np.array_equal(g.view(np.int32), w.view(np.int32)),
                  f"{tag} {kind} {what}: differs from backend xla by "
                  f"{float(np.abs(g - w).max())}")
        keys = sorted(eng._infer_cache)
        check(len(keys) == 2 and all(eng.trace_count(k) == 1 for k in keys),
              f"{tag} {kind}: executors {[(k, eng.trace_count(k)) for k in keys]}")
        key = schedule_key(eng.resolved_schedule, fp)
        rep = eng.serve_report()[key]
        print(f"served {tag:20s} {kind:6s} keys={keys}; predict_one p50 "
              f"{rep['fast_path']['latency_p50_s'] * 1e3:.3f} ms, flush of "
              f"{BATCH} rows: request latency p50 "
              f"{rep['measured']['latency_p50_s'] * 1e3:.3f} ms; every "
              f"answer bit for bit equal to backend xla")

    fp = specs["ap16_6"]
    x = (torch.randn(*FXP_SHAPES[0], generator=torch.Generator()
                     .manual_seed(9)) * 8).to(device)
    launches["ops_fixed_point"], out = drive(
        "ops_fixed_point", lambda: ops.fixed_point(x, fp), ("fixed_point",))
    check(same_bits(out, fixed_point_plain(x, fp)),
          "ops.fixed_point differs from its plain version")
    print(f"served ops.fixed_point {tuple(x.shape)} ap16_6: bit for bit "
          f"equal to its plain version")
    return launches


def phase_lm_decode(device) -> tuple:
    """gemma-2b at its published width and depth, seeded weights drawn on
    the card, served through ``LMServingEngine(device="cuda")``: 4 requests
    of ``LM_PROMPT`` prompt tokens and ``LM_NEW`` new tokens on each of
    three keys (R = 1, R = 4, and the default key's einsum path), driven
    with the counts set to 0.  R = 1 and R = 4 decode the same tokens and
    their first-step logits are the same bits; the default key's logits
    agree with them within the bf16 tolerance; one executor per key; 72
    ``decode_matmul`` launches per scheduled tick.  Returns (launches, a
    report of the path)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serving import LMServingEngine

    cfg = get_config(LM)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scheds = {"R1": KernelSchedule(reuse_factor=1),
              "R4": KernelSchedule(reuse_factor=4)}
    t0 = time.perf_counter()
    eng = LMServingEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_SEQ,
                          device=device)
    for s in scheds.values():
        eng._decoder_for(s)                   # packs its weight layout
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    prompts = np.random.RandomState(0).randint(
        2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).tolist()
    ids = {k: [] for k in ("default", *scheds)}

    def serve():
        for k in ids:
            for p in prompts:
                ids[k].append(eng.add_request(p, max_new=LM_NEW,
                                              schedule=scheds.get(k)))
        return eng.run_to_completion()

    t0 = time.perf_counter()
    launches, out = drive("lm_decode", serve, ("decode_matmul",))
    serve_s = time.perf_counter() - t0
    toks = {k: [out[i] for i in v] for k, v in ids.items()}
    for k, v in toks.items():
        check(len(v) == LM_BATCH and all(
            len(t) == LM_PROMPT + LM_NEW and t[:LM_PROMPT] == p
            and all(0 <= x < cfg.vocab_size for x in t)
            for t, p in zip(v, prompts)), f"{LM} key {k}: tokens {v}")
    check(toks["R1"] == toks["R4"], f"{LM}: R=1 and R=4 decoded different "
          f"tokens: {toks['R1']} vs {toks['R4']}")
    decs = {k: eng._decoder_for(scheds.get(k)) for k in ids}
    sched_ticks = decs["R1"].ticks + decs["R4"].ticks
    per_tick = 4 * cfg.n_layers
    check(launches["decode_matmul"] == per_tick * sched_ticks,
          f"{LM}: {launches['decode_matmul']} decode_matmul launches for "
          f"{sched_ticks} scheduled ticks, expected {per_tick} each")
    check(len(eng.keys()) == 3 and all(eng.trace_count(k) == 1
                                       for k in eng.keys()),
          f"{LM}: executors {[(k, eng.trace_count(k)) for k in eng.keys()]}")

    # the first step of every request, key by key, on a fresh cache
    tok0 = torch.tensor([p[:1] for p in prompts], device=device)
    pos0 = torch.zeros(LM_BATCH, dtype=torch.int64, device=device)
    logits = {}
    with torch.inference_mode():
        for k, dec in decs.items():
            cache = init_cache(cfg, LM_BATCH, LM_SEQ, "float32", device)
            logits[k] = decode_step(cfg, eng.params, cache, tok0, pos0,
                                    schedule=dec.schedule,
                                    packed=dec.packed)[0]
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) and v.shape == (
        LM_BATCH, 1, padded_vocab(cfg)) for v in logits.values()),
        f"{LM}: first-step logits not finite or misshaped")
    check(same_bits(logits["R1"], logits["R4"]),
          f"{LM}: R=1 and R=4 first-step logits differ")
    err, scale = max_err(logits["default"], logits["R1"])
    check(err <= TOL["bfloat16"] * scale, f"{LM}: the einsum path's logits "
          f"differ from the scheduled path's by {err} (scale {scale})")
    same_tokens = sum(a == b for a, b in zip(toks["default"], toks["R1"]))

    rep = eng.serve_report()
    keys = {k: dec.key for k, dec in decs.items()}
    report = {"model": LM, "params": cfg.param_count(),
              "param_gb": sum(t.numel() * t.element_size()
                              for t in params.values()) / 1e9,
              "init_s": init_s, "engine_and_pack_s": pack_s,
              "serve_s": serve_s, "first_step_logits_max_abs_err": err,
              "default_key_requests_same_tokens": same_tokens,
              "keys": {k: {"key": keys[k], "ticks": decs[k].ticks,
                           **{m: rep[keys[k]]["measured"][m] for m in (
                               "tokens", "tokens_per_s",
                               "tick_latency_p50_s", "tick_latency_p99_s")}}
                       for k in decs}}
    print(f"served {LM} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{report['param_gb']:.2f} GB of bf16 params drawn on the card in "
          f"{init_s:.2f} s): {len(out)} requests of {LM_PROMPT}+{LM_NEW} "
          f"tokens in {serve_s:.2f} s; R=1 == R=4 tokens and first-step "
          f"logits bit for bit; einsum logits within {err:.3e} "
          f"(tol {TOL['bfloat16'] * scale:.2e}); default-key tokens equal "
          f"on {same_tokens}/{LM_BATCH} requests")
    for k, row in report["keys"].items():
        print(f"  key {row['key']:32s}: {row['ticks']} ticks, tick p50 "
              f"{row['tick_latency_p50_s'] * 1e3:.3f} ms, p99 "
              f"{row['tick_latency_p99_s'] * 1e3:.3f} ms, "
              f"{row['tokens_per_s']:.1f} tokens/s")

    # one scheduled tick (R = 1) and one einsum tick in a device trace; a
    # scheduled tick launches each call's kernels: the product and, where
    # K takes more than one chunk, the chunk fold
    from repro_torch.kernels.decode_step import decode_layout

    per_call = [decode_layout(LM_BATCH, K, N, 1, True).launches
                for K, N in lm_products(cfg).values()]
    device_per_tick = cfg.n_layers * sum(per_call)
    cache = init_cache(cfg, LM_BATCH, LM_SEQ, "float32", device)
    for k in ("R1", "default"):
        for _ in range(3):              # a trace now and then comes back empty
            trace = device_trace(lambda k=k: decode_step(
                cfg, eng.params, cache, tok0, pos0,
                schedule=decs[k].schedule, packed=decs[k].packed))
            if trace:
                break
        report["keys"][k]["trace"] = trace
        print(f"  trace of one {k} step: {json.dumps(trace)}")
    got = report["keys"]["R1"]["trace"].get("kernels", {}).get(
        "decode_matmul", {}).get("launches")
    print(f"  a scheduled tick: {per_tick} decode_matmul calls, "
          f"{device_per_tick} device kernels (per call {per_call}); the "
          f"trace shows {got}")
    check(got == device_per_tick, f"{LM}: the R1 tick's trace shows {got} "
          f"decode_matmul kernels, expected {device_per_tick}")
    report["device_kernels_per_tick"] = device_per_tick
    del eng, params, decs
    torch.cuda.empty_cache()
    return launches, report


def phase_rnn_decode(device) -> dict:
    """The six taggers at their published widths, B = ``BATCH``, as T
    chained ``rnn_decode_step`` calls on a kernel schedule, driven with the
    counts set to 0: float (``decode_matmul``) held to the ``backend="xla"``
    scan within 3e-5; ``fp=ap_fixed<8,3>`` on PTQ'd weights (the native
    route, ``quant_matmul``) bit for bit equal to the same steps on
    ``backend="xla"`` (the emulation); ``fp=ap_fixed<16,6>`` (the quantized
    cells with the ``decode_matmul`` hook) within 3e-5 of them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quant.fixed_point import quantize
    from repro_torch.core.rnn.cells import initial_state
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_step import rnn_decode_step
    from repro_torch.kernels.schedule import KernelSchedule

    sched = KernelSchedule()
    xla = sched.replace(backend="xla")
    fps = {"ap8_3": fixed_point_config(FP_NATIVE["int8"]),
           "ap16_6": fixed_point_config(FP_EMULATED)}
    cases = []
    for i, tag in enumerate(TAGGERS):
        r = get_config(tag).rnn
        xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                                  torch.float32, 700 + i, device)
        weights = {"float": (W, U, b),
                   **{k: tuple(quantize(t, fp) for t in (W, U, b))
                      for k, fp in fps.items()}}
        cases.append((tag, r.cell, xs, weights))

    def chain(cell, xs, weights, s, fp=None):
        state = initial_state(cell, xs.shape[0], weights[1].shape[0],
                              torch.float32, xs.device)
        with torch.inference_mode():
            for t in range(xs.shape[1]):
                h, state = rnn_decode_step(cell, xs[:, t], state, *weights,
                                           schedule=s, fp=fp)
        return h

    def run():
        return {tag: {k: chain(cell, xs, w, sched, fps.get(k))
                      for k, w in weights.items()}
                for tag, cell, xs, weights in cases}

    launches, got = drive("rnn_decode", run, ("decode_matmul",
                                              "quant_matmul"))
    steps = sum(xs.shape[1] for _, _, xs, _ in cases)
    check(launches["decode_matmul"] == 2 * 2 * steps
          and launches["quant_matmul"] == 2 * steps,
          f"rnn_decode launches {launches} for {steps} steps")
    for tag, cell, xs, weights in cases:
        scan = ops.lstm_scan if cell == "lstm" else ops.gru_scan
        with torch.inference_mode():
            want = {"float": scan(xs, *weights["float"], schedule=xla),
                    **{k: chain(cell, xs, weights[k], xla, fp)
                       for k, fp in fps.items()}}
        g = got[tag]
        err, scale = max_err(g["float"], want["float"])
        check(err <= TOL["float32"] * scale,
              f"{tag}: decode steps vs the xla scan: err {err}")
        check(same_bits(g["ap8_3"], want["ap8_3"]),
              f"{tag}: native int8 steps differ from the emulation")
        err16, scale16 = max_err(g["ap16_6"], want["ap16_6"])
        check(err16 <= TOL["float32"] * scale16,
              f"{tag}: ap_fixed<16,6> steps vs xla: err {err16}")
        print(f"served {tag:20s} {xs.shape[1]} chained rnn_decode_steps "
              f"B={BATCH}: float max_abs_err {err:.3e} vs the xla scan; "
              f"ap8_3 native bit for bit equal to the emulation; ap16_6 "
              f"max_abs_err {err16:.3e} vs xla")
    return launches


def phase_rglru(device) -> dict:
    """The scheduled RG-LRU entry point ``SCHEDULED_KERNELS["rglru"]`` at
    recurrentgemma-9b's width (a, bx [8, 2048, 4096] f32 on the card) and
    ``ops.hadamard`` at (8 * 2048, 4096) bf16, each driven with the counts
    set to 0: static R = 1 and R = 4 launch ``rglru_scan`` once each and
    give the reference's bits (R = 4 equal to R = 1); non-static and
    pipeline launch no kernel and give the same bits; the native
    ``ap_fixed<8,3>`` route (torch integer ops) equals the emulation in
    value; ``ops.hadamard`` launches ``hadamard`` once and equals
    ``torch.mul`` bit for bit."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import KernelSchedule

    scan, golden = ops.SCHEDULED_KERNELS["rglru"]
    gen = torch.Generator(device=device).manual_seed(1000)
    a, bx = rglru_inputs(RG_B, RG_T, RG_W, torch.float32, gen, device)
    scheds = {"static_r1": KernelSchedule(),
              "static_r4": KernelSchedule(reuse_factor=4),
              "nonstatic": KernelSchedule(mode="nonstatic"),
              "pipeline": KernelSchedule(mode="pipeline", reuse_factor=4)}
    fp = fixed_point_config(FP_NATIVE["int8"])
    with torch.inference_mode():
        want = golden(a, bx)
        emulated = scan(a, bx, schedule=KernelSchedule(backend="xla"), fp=fp)
    launches, got = {}, {}
    for what, sched in scheds.items():
        with torch.inference_mode():
            launches[f"rglru_{what}"], got[what] = drive(
                f"rglru_{what}", lambda s=sched: scan(a, bx, schedule=s),
                ("rglru_scan",) if what.startswith("static") else ())
        n = launches[f"rglru_{what}"]
        expect = {"rglru_scan": 1} if what.startswith("static") else {}
        check({k: v for k, v in n.items() if v} == expect,
              f"rglru {what}: launches {n}, expected {expect}")
        check(same_bits(got[what], want),
              f"rglru {what}: differs from backend xla by "
              f"{max_err(got[what], want)[0]}")
    with torch.inference_mode():
        launches["rglru_fixed_point"], native = drive(
            "rglru_fixed_point", lambda: scan(a, bx, schedule=KernelSchedule(),
                                              fp=fp), ())
    check(sum(launches["rglru_fixed_point"].values()) == 0,
          "the native RG-LRU route launched a kernel")
    check(native.dtype == emulated.dtype and torch.equal(native, emulated),
          f"rglru ap8_3: native differs from the emulation by "
          f"{max_err(native, emulated)[0]}")
    neg = int((torch.signbit(emulated) & (emulated == 0)).sum())
    print(f"served SCHEDULED_KERNELS['rglru'] ({RG_B},{RG_T},{RG_W}) f32: "
          f"static R=1 / R=4, nonstatic, pipeline bit for bit equal to "
          f"backend xla; ap8_3 native equal in value to the emulation "
          f"({neg} of its zeros are -0.0)")

    x = torch.randn(RG_B * RG_T, RG_W, generator=gen, device=device).bfloat16()
    y = torch.randn(RG_B * RG_T, RG_W, generator=gen, device=device).bfloat16()
    with torch.inference_mode():
        launches["hadamard"], out = drive(
            "hadamard", lambda: ops.hadamard(x, y), ("hadamard",))
    check(launches["hadamard"]["hadamard"] == 1,
          f"ops.hadamard: {launches['hadamard']['hadamard']} launches")
    check(same_bits(out, torch.mul(x, y)), "ops.hadamard differs from "
          "torch.mul")
    print(f"served ops.hadamard {tuple(x.shape)} bf16: bit for bit equal to "
          f"torch.mul")
    return launches


def phase_timing(device) -> tuple:
    """Kernel, plain and library times and the bound at B = 256, and whole
    scans end to end."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.scan_layout import (ZX_CLUSTER, card_layout,
                                                 card_resident,
                                                 model_resident, scan_route)

    rows = []
    small_kernels = ("col_matmul", "reuse_matmul", "quant_matmul",
                     "fixed_point", "decode_matmul", "hadamard")
    calls_all = [*all_calls(torch.float32, device, timing=True),
                 *quant_calls(device, timing=True),
                 *decode_calls(device, timing=True),
                 *elementwise_calls(device, timing=True)]
    for tag, reuse, c in calls_all:
        lib = c["library"]
        with torch.inference_mode():
            out = c["kern"]()
            lib_err = (float((lib().float() - out.float()).abs().max())
                       if lib else None)
        small = c["name"] in small_kernels
        ms = time_ms(c["kern"], 200 if small else 20)
        plain_ms = time_ms(c["plain"], 20 if small else 3, warmup=1)
        library_ms = time_ms(lib, 200 if small else 20) if lib else None
        b_ms, b_by, nbytes = bound(c["inputs"], out, c["flops"], c["peak"])
        row = {"name": c["name"], "tagger": tag, "reuse": reuse,
               "shape": c["shape"], "headline": c["headline"],
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by, "flop": c["flops"],
               "bytes": nbytes, "library_max_abs_err": lib_err}
        # events around back-to-back calls of a small kernel time the host's
        # launch rate; the trace reads the device's own time per call
        calls = 50 if small else 10
        own = small or c["name"] == "rglru_scan"
        # a scan runs on the cluster kernel or the block kernel by shape
        group = c["name"] if own else ("cluster scan kernels",
                                       "scan kernels")
        row["device_ms"] = per_call(c["kern"], group, calls)
        row["library_device_ms"] = (per_call(lib, "other", calls) if lib
                                    else None)
        zx_cluster = (c["name"] in ZX_CLUSTER
                      and scan_route(c["inputs"][1].shape[0]) == "cluster")
        if c["name"] in CLUSTER_SCANS or zx_cluster:
            xs, U = c["inputs"][0], c["inputs"][1 if zx_cluster else 2]
            cell = c["name"].split("_")[0]
            bf16 = out.dtype == torch.bfloat16
            fin = 0 if zx_cluster else xs.shape[-1]
            # the pipeline runs the one-pass instance on R = 1's layout
            lay_reuse = 1 if c["name"].endswith("_pipeline") else reuse
            lay = card_layout(xs.shape[0], U.shape[0], fin, cell, lay_reuse,
                              bf16, xs.device.index, zx_cluster)
            # clusters the card holds at once (its occupancy query) beside
            # the CPU tests' model of it
            row["layout"] = {**lay._asdict(),
                             "resident": card_resident(
                                 cell, bf16, lay_reuse, lay,
                                 hoisted=zx_cluster),
                             "model_resident": model_resident(lay)}
        elif c["name"] == "decode_matmul":
            row["layout"] = decode_layout_row(c["inputs"], reuse)
        elif c["name"] in PRODUCT_LIBS:
            (M, K), N = c["inputs"][0].shape, c["inputs"][1].shape[1]
            row["layout"] = product_layout(c["name"], M, K, N, reuse)
        elif not own:
            row["rows_per_block"] = cuda.rows_per_block(BATCH)
        if str(tag).startswith(LM) or c["name"] in ("rglru_scan", "hadamard"):
            # a tick reads each weight once, with 4 GB between two reads, and
            # the RG-LRU path's operands are each 268 MB: time each call
            # after an L2 flush, as the path finds it
            row["cold_ms"] = time_cold_ms(c["kern"], 10 if own else 50)
            row["library_cold_ms"] = (time_cold_ms(lib, 10 if own else 50)
                                      if lib else None)
        rows.append(row)
        lib_txt = ("n/a" if lib is None else
                   f"{library_ms:.4f} ms (device "
                   f"{row['library_device_ms']:.4f}), err {lib_err:.1e}")
        cold = ("" if "cold_ms" not in row else
                f"; L2 cold: kernel {row['cold_ms']:.4f} ms, library "
                f"{'n/a' if lib is None else round(row['library_cold_ms'], 4)}"
                f" ms")
        lay = ("" if "layout" not in row else
               f"; layout {tuple(row['layout'].values())}")
        print(f"time {c['name']:18s} {c['shape']:44s}: kernel {ms:.4f} ms "
              f"(device {row['device_ms']:.4f}), plain {plain_ms:.4f} ms, "
              f"library {lib_txt}, bound {b_ms:.5f} ms ({b_by}){cold}{lay}")
    return rows, (time_nonstatic_scans(device) + [time_quantized_scan(device)]
                  + time_rglru_modes(device))


#: the cluster kernel's zx-mode instances each scan runs, by fragments of
#: their mangled names: <CELL, true, ...> (cell 0: LSTM, 1: GRU), the
#: pipeline's with ONE_PASS (the last template argument) true
ZX_INSTANCES = {"lstm_scan_hoisted": ("ILi0ELb1E",),
                "gru_scan_hoisted": ("ILi1ELb1E",),
                "lstm_scan_pipeline": ("ILi0ELb1E", "Lb1EEEv"),
                "gru_scan_pipeline": ("ILi1ELb1E", "Lb1EEEv")}
#: the tiled products and their C libraries (each exports ``<name>_layout``)
PRODUCT_LIBS = {"col_matmul": "reuse_matmul", "reuse_matmul": "reuse_matmul",
                "quant_matmul": "quantized"}


def decode_layout_row(inputs, reuse) -> dict:
    """``decode_matmul``'s launch layout for (x, w) at this R (the Python
    layout the C entry point takes), with its blocks and launches."""
    import torch

    from repro_torch.kernels.decode_step import decode_layout

    x, w = inputs
    lay = decode_layout(x.shape[0], x.shape[1], w.shape[1], reuse,
                        x.dtype == torch.bfloat16, w.data_ptr() % 16 == 0)
    return {**lay._asdict(), "blocks": lay.blocks, "launches": lay.launches}


def product_layout(name: str, M: int, K: int, N: int, reuse: int) -> dict:
    """The launch of ``col_matmul`` / ``reuse_matmul`` (f32) or
    ``quant_matmul`` at this shape, as its C library's ``*_layout`` export
    gives it: the CTA tile,
    the grid, the threads, the ring's stages and the shared bytes."""
    import ctypes

    from repro_torch.kernels import cuda

    out = (ctypes.c_int * 7)()
    rc = cuda.function(PRODUCT_LIBS[name], f"{name}_layout")(
        M, K, N, reuse, ctypes.cast(out, ctypes.c_void_p))
    check(rc == 0, f"{name}_layout({M}, {K}, {N}, {reuse}): error {rc}")
    lay = dict(zip(("rows", "cols", "grid_x", "grid_y", "threads",
                    "stages", "smem_bytes"), out))
    lay["ctas"] = lay["grid_x"] * lay["grid_y"]
    return lay


def ptxas_report(paths) -> dict:
    """Registers and spill bytes of every compiled kernel, from the
    ``-Xptxas -v`` log the build keeps beside each library: mangled entry
    name -> {"registers", "spill_bytes"}."""
    import re

    report: dict = {}
    for path in paths.values():
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        entry = None
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
                report[entry] = {"registers": None, "spill_bytes": 0}
            elif entry and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
                report[entry]["spill_bytes"] = int(m[1]) + int(m[2])
            elif entry and (m := re.search(r"Used (\d+) registers", ln)):
                report[entry]["registers"] = int(m[1])
    return report


def ptxas_summary(report: dict, name: str, *fragments: str) -> dict:
    """The compiled instances of kernel ``name`` (its template
    instantiations; with ``fragments``, those whose mangled name holds
    every one): how many, their registers, their spill bytes."""
    inst = [v for k, v in report.items()
            if f"{name}_kernel" in k and all(f in k for f in fragments)]
    return {"instances": len(inst),
            "registers": sorted(v["registers"] for v in inst),
            "spill_bytes": sum(v["spill_bytes"] for v in inst)}


def time_cold_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn`` that finds the 50 MB L2
    cold: CUDA events around each call, each after a 256 MB write."""
    import torch

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    pairs = []
    with torch.inference_mode():
        fn()
        for _ in range(iters):
            flush.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def per_call(fn, group, calls: int) -> float:
    """Device time of the kernels of ``group`` (a name, or a tuple of names
    whose times add up) per call of ``fn``, over ``calls`` calls from the
    trace (nan where it holds none).  A trace now and then comes back
    without the group's kernels: up to 3 tries."""
    groups = (group,) if isinstance(group, str) else group
    for _ in range(3):
        kernels = device_trace(fn, calls).get("kernels", {})
        found = [kernels[g]["device_ms"] for g in groups if g in kernels]
        if found:
            return sum(found) / calls
    return float("nan")


#: back-to-back calls a whole-scan trace of :func:`time_nonstatic_scans`
#: reads
SCAN_TRACE_CALLS = 5


def time_nonstatic_scans(device) -> list:
    """One whole scan of QuickDraw LSTM at B = 256 through ``ops.lstm_scan``
    per schedule: device time between CUDA events around 5 calls (host
    launch gaps included), the launches of one call, and from a trace of
    ``SCAN_TRACE_CALLS`` calls back to back the device's span, busy time
    and idle share (one call's span would open on its first event and
    miss the host's gap to the next call)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule

    r = get_config("quickdraw-lstm").rnn
    xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                              torch.float32, 400, device)
    scheds = {"nonstatic": KernelSchedule(mode="nonstatic"),
              "nonstatic_hoist": KernelSchedule(mode="nonstatic",
                                                hoist_input=True),
              "pipeline_r1": KernelSchedule(mode="pipeline"),
              "static": KernelSchedule()}
    out = []
    for what, sched in scheds.items():
        fn = lambda s=sched: ops.lstm_scan(xs, W, U, b, schedule=s)  # noqa
        cuda.reset_launches()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        ms = time_ms(fn, 5)
        n = sum(launches.values())
        trace = device_trace(fn, SCAN_TRACE_CALLS)
        out.append({"schedule": sched.key(), "ms": ms, "launches": launches,
                    "us_per_launch": ms * 1e3 / n, "trace": trace,
                    "trace_calls": SCAN_TRACE_CALLS})
        print(f"scan quickdraw-lstm B={BATCH} {sched.key():32s}: {ms:.3f} ms "
              f"device span, {n} launches {launches}, "
              f"{ms * 1e3 / n:.2f} us per launch; trace of "
              f"{SCAN_TRACE_CALLS} calls: {json.dumps(trace)}")
    return out


def time_quantized_scan(device) -> dict:
    """One whole native int8 scan of QuickDraw LSTM at B = 256 through
    ``ops.lstm_scan(fp=ap_fixed<8,3>)`` (weights PTQ'd): as
    :func:`time_nonstatic_scans`, beside the same scan on the emulation
    cells (``backend="xla"``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quant.fixed_point import quantize
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule

    r = get_config("quickdraw-lstm").rnn
    fp = fixed_point_config(FP_NATIVE["int8"])
    xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                              torch.float32, 401, device)
    W, U, b = (quantize(t, fp) for t in (W, U, b))
    sched = KernelSchedule()
    out = {"schedule": sched.key(), "fp": "ap8_3"}
    for what, s in (("native", sched), ("emulated", sched.replace(
            backend="xla"))):
        fn = lambda s=s: ops.lstm_scan(xs, W, U, b, schedule=s, fp=fp)  # noqa
        cuda.reset_launches()
        with torch.inference_mode():
            h = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        ms = time_ms(fn, 3, warmup=1)
        trace = device_trace(fn)
        out[what] = {"ms": ms, "launches": launches, "trace": trace}
        out[f"{what}_h"] = h
        print(f"scan quickdraw-lstm B={BATCH} {sched.key()} ap8_3 {what:8s}: "
              f"{ms:.3f} ms device span, launches {launches}; trace of one "
              f"call: {json.dumps(trace)}")
    check(same_bits(out.pop("native_h"), out.pop("emulated_h")),
          "native int8 scan differs from the emulation")
    return out


def time_rglru_modes(device) -> list:
    """One whole RG-LRU scan at the full width through ``ops.rglru_scan`` per
    schedule (static R = 1 and 4 on the kernel, the non-static chain of
    torch ops, the native ap_fixed<8,3> route), as
    :func:`time_nonstatic_scans`."""
    import torch

    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule

    gen = torch.Generator(device=device).manual_seed(1100)
    a, bx = rglru_inputs(RG_B, RG_T, RG_W, torch.float32, gen, device)
    fp = fixed_point_config(FP_NATIVE["int8"])
    runs = {"static": (KernelSchedule(), None),
            "static_r4": (KernelSchedule(reuse_factor=4), None),
            "nonstatic": (KernelSchedule(mode="nonstatic"), None),
            "native_ap8_3": (KernelSchedule(), fp)}
    out = []
    for what, (sched, f) in runs.items():
        fn = lambda s=sched, f=f: ops.rglru_scan(a, bx, schedule=s, fp=f)  # noqa
        cuda.reset_launches()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        ms = time_ms(fn, 3, warmup=1)
        trace = device_trace(fn)
        out.append({"rglru": what, "schedule": sched.key(), "ms": ms,
                    "launches": launches, "trace": {
                        k: v for k, v in trace.items() if k != "kernels"},
                    "trace_kernels": {k: v["launches"] for k, v in
                                      trace.get("kernels", {}).items()}})
        print(f"scan rglru ({RG_B},{RG_T},{RG_W}) f32 {what:13s}: {ms:.3f} ms "
              f"device span, launches {launches}; trace of one call: "
              f"{json.dumps(out[-1]['trace'])}, device kernels "
              f"{out[-1]['trace_kernels']}")
    return out


#: predict_one calls and flushes of BATCH requests timed per engine by
#: ``--time-scans``
SCAN_ONE_CALLS, SCAN_FLUSHES = 100, 10


def time_engine(tag, eng, x, one_calls: int, flushes: int) -> dict:
    """An engine's ``predict_one`` p50 / p99 and flush-of-``BATCH`` p50 (host
    clock, ms) over rows of ``x``, after 5 warm-up calls and one flush."""
    for j in range(5):
        eng.predict_one(x[j])
    one = []
    for j in range(one_calls):
        t0 = time.perf_counter()
        eng.predict_one(x[j % len(x)])
        one.append(time.perf_counter() - t0)
    eng.serve(list(x))
    flush = []
    for _ in range(flushes):
        t0 = time.perf_counter()
        reqs = eng.serve(list(x))
        flush.append(time.perf_counter() - t0)
        for q in reqs:
            check(q.status == "answered", f"{tag}: request {q.req_id} "
                  f"{q.status}: {q.error!r}")
    row = {"predict_one_p50_ms": float(np.percentile(one, 50)) * 1e3,
           "predict_one_p99_ms": float(np.percentile(one, 99)) * 1e3,
           "flush_p50_ms": float(np.percentile(flush, 50)) * 1e3}
    print(f"engine {tag:28s}: predict_one p50 "
          f"{row['predict_one_p50_ms']:.3f} ms (p99 "
          f"{row['predict_one_p99_ms']:.3f}), flush of {BATCH} p50 "
          f"{row['flush_p50_ms']:.3f} ms")
    return row


def time_scans(device) -> dict:
    """``--time-scans``: the in-loop static scans (``lstm_scan`` /
    ``gru_scan``) of every tagger, float32, at B = 8 (R = 1) and B = 256
    (R = 1 and 4): device time per call from a trace and CUDA events,
    with cuDNN's for the same function beside them; the hoisted and
    pipeline scans likewise (:func:`time_hoisted_scans`); and the engines'
    ``predict_one`` p50 / p99 and flush-of-256 p50 (host clock).  It times
    whichever tree's ``repro_torch`` was imported: with
    ``--src`` an older tree (an unpacked parent commit) is timed the same
    way, so two trees are compared in one call by running the script
    twice on one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    out = {"kernels": [], "hoisted": [], "engines": []}
    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        r = cfg.rnn
        kern = (ls.lstm_scan_kernel if r.cell == "lstm"
                else gs.gru_scan_kernel)
        for B, reuse in ((SMALL_BATCHES[0], 1), (BATCH, 1), (BATCH, 4)):
            args = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                               torch.float32, 700 + i, device, batch=B)
            fn = lambda a=args, R=reuse: kern(*a, reuse=R)  # noqa: E731
            lib = library_call(f"{r.cell}_scan", args)
            with torch.inference_mode():
                err = max_err(fn(), lib())[0]
            # an older tree's in-loop scans are "scan kernels"
            dev_ms = per_call(fn, ("cluster scan kernels", "scan kernels"),
                              20)
            row = {"tagger": tag, "kernel": f"{r.cell}_scan", "B": B,
                   "R": reuse, "device_ms": dev_ms,
                   "ms": time_ms(fn, 50),
                   "cudnn_device_ms": per_call(lib, "other", 20),
                   "cudnn_ms": time_ms(lib, 50), "cudnn_max_abs_err": err}
            out["kernels"].append(row)
            print(f"scan {tag:20s} B={B:3d} R={reuse}: device "
                  f"{row['device_ms']:.4f} "
                  f"ms, events {row['ms']:.4f} ms; cuDNN device "
                  f"{row['cudnn_device_ms']:.4f}, events "
                  f"{row['cudnn_ms']:.4f} ms (err {err:.1e})")
        out["hoisted"].extend(time_hoisted_scans(tag, r, device, 700 + i))
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        eng = RNNServingEngine(cfg, params, impl="pallas", device=device)
        x = np.random.RandomState(750 + i).randn(
            BATCH, r.seq_len, r.input_size).astype(np.float32)
        out["engines"].append({"engine": tag, **time_engine(
            tag, eng, x, SCAN_ONE_CALLS, SCAN_FLUSHES)})
    return out


#: predict_one calls and flushes of BATCH requests timed per engine by
#: ``--time-products`` (a non-static or fixed-point scan launches two
#: products a step: 10-300x a static scan's time)
PRODUCT_ONE_CALLS, PRODUCT_FLUSHES = 20, 3
#: host calls per reading of the launch path's parts
HOST_CALLS = 2000


def product_shapes():
    """(tagger, side, K, N) of every tagger's two gate products."""
    from repro_torch.configs import get_config

    for tag in TAGGERS:
        r = get_config(tag).rnn
        g = 4 if r.cell == "lstm" else 3
        for side, K in (("x-side", r.input_size), ("h-side", r.hidden)):
            yield tag, side, K, g * r.hidden


def time_host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back calls
    (no synchronise inside: the launch path's own cost, the kernels running
    meanwhile)."""
    import torch

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def host_split(device) -> dict:
    """Where a call's host microseconds go, for ``col_matmul`` and
    ``quant_matmul`` at QuickDraw LSTM's h-side product (256 x 128 @ 128 x
    512, R = 1): the whole wrapper, and apart its checks, the output's
    ``torch.empty``, the stream fetch (``torch.cuda.current_stream`` and the
    raw binding), the three ``data_ptr`` reads, and the ctypes call itself
    (which launches the kernel)."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels import quantized as qm
    from repro_torch.kernels import reuse_matmul as rm

    M, K, N = MATMUL_SHAPE
    gen = torch.Generator(device=device).manual_seed(1300)
    xf = torch.randn(M, K, generator=gen, device=device)
    wf = torch.randn(K, N, generator=gen, device=device)
    xi = torch.randint(-128, 128, (M, K), generator=gen, device=device,
                       dtype=torch.int8)
    wi = torch.randint(-128, 128, (K, N), generator=gen, device=device,
                       dtype=torch.int8)
    stream = torch.cuda.current_stream(device).cuda_stream
    cases = {
        "col_matmul": (
            lambda: rm.col_matmul_kernel(xf, wf),
            lambda: cuda.require("col_matmul", xf.dtype, io=("x",), x=xf,
                                 w=wf),
            torch.float32, "reuse_matmul", xf, wf,
            lambda fn, o: fn(xf.data_ptr(), 0, wf.data_ptr(), o, M, K, N, 1,
                             stream)),
        "quant_matmul": (
            lambda: qm.quant_matmul_kernel(xi, wi),
            lambda: cuda.require_int8("quant_matmul", x=xi, w=wi),
            torch.int32, "quantized", xi, wi,
            lambda fn, o: fn(xi.data_ptr(), wi.data_ptr(), o, M, K, N, 1,
                             stream)),
    }
    out = {}
    for name, (wrapper, checks, odt, lib, x, w, c_call) in cases.items():
        o = torch.empty(M, N, dtype=odt, device=device)
        fn = getattr(cuda.library(lib), name)
        ptr = o.data_ptr()
        parts = {
            "wrapper": time_host_us(wrapper),
            "checks": time_host_us(checks),
            "torch_empty": time_host_us(
                lambda: torch.empty(M, N, dtype=odt, device=device)),
            "current_stream": time_host_us(
                lambda: torch.cuda.current_stream(device).cuda_stream),
            "raw_stream": time_host_us(
                lambda: torch._C._cuda_getCurrentRawStream(device.index)),
            "data_ptrs": time_host_us(
                lambda: (x.data_ptr(), w.data_ptr(), o.data_ptr())),
            "ctypes_call": time_host_us(lambda: c_call(fn, ptr)),
        }
        out[name] = parts
        print(f"host {name:12s} us a call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()))
    return out


def time_products(device) -> dict:
    """``--time-products``: ``col_matmul`` (f32), ``reuse_matmul`` (f32 and
    bf16) and ``quant_matmul`` (int8) at every tagger's x-side and h-side
    gate product, at B = 256 and B = 8 and R in ``REUSES`` (``reuse_matmul``
    where R divides K): CUDA-event ms over back-to-back calls and device ms
    from a trace, with ``torch.matmul`` / ``torch._int_mm`` (f32
    ``torch.matmul`` on the same integers where ``_int_mm`` refuses the
    shape) timed both ways beside them, and the bound; the host path's
    split (:func:`host_split`); whole QuickDraw LSTM scans, non-static and
    native ``ap_fixed<8,3>``, B = 256 (events ms, launches, the trace's busy
    time and idle share); and the six engines' ``predict_one`` and flush of
    256 in non-static mode and at ``fp=ap_fixed<8,3>`` (PTQ'd weights).  It
    times whichever tree's ``repro_torch`` was imported (``--src``), so two
    trees are compared in one call by running the script for each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import ptq_quantize_model
    from repro_torch.kernels import quantized as qm
    from repro_torch.kernels import reuse_matmul as rm
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    out = {"kernels": [], "host": host_split(device), "scans": [],
           "engines": []}
    gen = torch.Generator(device=device).manual_seed(1200)
    for tag, side, K, N in product_shapes():
        for B in (BATCH, SMALL_BATCHES[0]):
            xf = torch.randn(B, K, generator=gen, device=device)
            wf = torch.randn(K, N, generator=gen, device=device) / np.sqrt(K)
            xi = torch.randint(-128, 128, (B, K), generator=gen,
                               device=device, dtype=torch.int8)
            wi = torch.randint(-128, 128, (K, N), generator=gen,
                               device=device, dtype=torch.int8)
            xb, wb = xf.to(torch.bfloat16), wf.to(torch.bfloat16)
            for R in REUSES:
                for name, kern, lib, inputs, peak in (
                        ("col_matmul",
                         lambda R=R: rm.col_matmul_kernel(xf, wf, reuse=R),
                         lambda: torch.matmul(xf, wf), (xf, wf), F32_PEAK),
                        ("reuse_matmul",
                         lambda R=R: rm.reuse_matmul_kernel(xf, wf, reuse=R),
                         lambda: torch.matmul(xf, wf), (xf, wf), F32_PEAK),
                        ("reuse_matmul",
                         lambda R=R: rm.reuse_matmul_kernel(xb, wb, reuse=R),
                         lambda: torch.matmul(xb, wb), (xb, wb), BF16_PEAK),
                        ("quant_matmul",
                         lambda R=R: qm.quant_matmul_kernel(xi, wi, reuse=R),
                         int_matmul_library(xi, wi), (xi, wi), INT8_PEAK)):
                    if name == "reuse_matmul" and K % R:
                        continue        # R splits K: the x-side's K = 3, 6
                    dtype = str(inputs[0].dtype).split(".")[1]
                    with torch.inference_mode():
                        o = kern()
                    row = {"name": name, "dtype": dtype, "tagger": tag,
                           "side": side, "B": B, "K": K, "N": N, "R": R,
                           "ms": time_ms(kern, 200),
                           "device_ms": per_call(kern, name, 50),
                           "library_ms": time_ms(lib, 200),
                           "library_device_ms": per_call(lib, "other", 50),
                           "bound_ms": bound(inputs, o, 2.0 * B * K * N,
                                             peak)[0]}
                    out["kernels"].append(row)
                    print(f"product {name:12s} {dtype:8s} {tag:20s} {side} "
                          f"({B},{K})@"
                          f"({K},{N}) R={R}: device {row['device_ms']:.4f} "
                          f"ms, events {row['ms']:.4f}; library device "
                          f"{row['library_device_ms']:.4f}, events "
                          f"{row['library_ms']:.4f}; bound "
                          f"{row['bound_ms']:.5f}")

    from repro_torch.core.quant.fixed_point import quantize
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule

    fp = fixed_point_config(FP_NATIVE["int8"])
    r = get_config("quickdraw-lstm").rnn
    xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                              torch.float32, 1201, device)
    Wq, Uq, bq = (quantize(t, fp) for t in (W, U, b))
    for what, fn in (
            ("nonstatic", lambda: ops.lstm_scan(
                xs, W, U, b, schedule=KernelSchedule(mode="nonstatic"))),
            ("native_ap8_3", lambda: ops.lstm_scan(
                xs, Wq, Uq, bq, schedule=KernelSchedule(), fp=fp))):
        cuda.reset_launches()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        row = {"scan": what, "ms": time_ms(fn, 3, warmup=1),
               "launches": launches, "trace": device_trace(fn)}
        out["scans"].append(row)
        print(f"scan quickdraw-lstm B={BATCH} {what}: {row['ms']:.3f} ms, "
              f"launches {launches}; trace of one call: "
              f"{json.dumps(row['trace'])}")

    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        x = np.random.RandomState(1250 + i).randn(
            BATCH, cfg.rnn.seq_len, cfg.rnn.input_size).astype(np.float32)
        for mode, eng in (
                ("nonstatic", RNNServingEngine(cfg, params, mode="nonstatic",
                                               impl="pallas",
                                               device=device)),
                ("ap8_3", RNNServingEngine(cfg, ptq_quantize_model(params, fp),
                                           impl="pallas", device=device,
                                           fp=fp))):
            out["engines"].append({"engine": tag, "mode": mode, **time_engine(
                f"{tag} {mode}", eng, x, PRODUCT_ONE_CALLS,
                PRODUCT_FLUSHES)})
    return out


def time_hoisted_scans(tag, r, device, seed) -> list:
    """The hoisted and pipeline scans of one tagger on zx from the port's
    hoist stage, float32, at B = 8 and 256 and R in ``REUSES``: device ms
    per call (trace) and CUDA-event ms, with cuDNN's for the same function
    beside them (``--time-scans``)."""
    import torch

    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.kernels.ops import _hoist_stage
    from repro_torch.kernels.schedule import KernelSchedule

    mod = ls if r.cell == "lstm" else gs
    rows = []
    for B in (SMALL_BATCHES[0], BATCH):
        xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                                  torch.float32, seed, device, batch=B)
        zx = _hoist_stage(xs, W, KernelSchedule())
        args = ((zx.contiguous(), U, b) if r.cell == "lstm" else
                ((zx + b[0]).contiguous(), U, b[1].contiguous()))
        lib = library_call(f"{r.cell}_scan_hoisted", args)
        lib_dev = per_call(lib, "other", 20)
        lib_ms = time_ms(lib, 50)
        for kind in ("hoisted", "pipeline"):
            kern = getattr(mod, f"{r.cell}_scan_{kind}_kernel")
            for reuse in REUSES:
                fn = lambda R=reuse: kern(*args, reuse=R)  # noqa: E731
                with torch.inference_mode():
                    err = max_err(fn(), lib())[0]
                row = {"tagger": tag, "kernel": f"{r.cell}_scan_{kind}",
                       "B": B, "R": reuse,
                       "device_ms": per_call(fn, ("cluster scan kernels",
                                                  "scan kernels"), 20),
                       "ms": time_ms(fn, 50), "cudnn_device_ms": lib_dev,
                       "cudnn_ms": lib_ms, "cudnn_max_abs_err": err}
                rows.append(row)
                print(f"scan {tag:20s} {kind:8s} B={B:3d} R={reuse}: device "
                      f"{row['device_ms']:.4f} ms, events {row['ms']:.4f} "
                      f"ms; cuDNN device {lib_dev:.4f}, events "
                      f"{lib_ms:.4f} ms (err {err:.1e})")
    return rows


def time_decode(device) -> dict:
    """``--time-decode``: ``decode_matmul`` at gemma-2b's four per-token
    products (bf16, M = 4) and the taggers' decode-step products (f32, M =
    1 and 256), R in ``REUSES``: CUDA-event ms over back-to-back calls,
    device ms from a trace (the product and its fold), and device ms after
    an L2 flush (the gemma-2b products), each beside ``torch.matmul``'s and
    the bound; and gemma-2b's decode tick per key (R = 1, R = 4, einsum):
    host-clock latency of a step that ends in its logits, and its trace
    (busy ms, idle share, ``decode_matmul``'s kernels and device ms).  It
    times whichever tree's ``repro_torch`` was imported (``--src``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.model import build_model
    from repro_torch.serving import LMServingEngine

    out = {"kernels": [], "ticks": {}}
    for what, reuse, c in decode_calls(device, timing=True):
        with torch.inference_mode():
            o = c["kern"]()
        lib = c["library"]
        lm = what.startswith(LM)
        row = {"shape": c["shape"], "R": reuse,
               "ms": time_ms(c["kern"], 200),
               "device_ms": per_call(c["kern"], "decode_matmul", 50),
               "cold_ms": time_cold_ms(c["kern"], 50) if lm else None,
               "library_ms": time_ms(lib, 200),
               "library_device_ms": per_call(lib, "other", 50),
               "library_cold_ms": time_cold_ms(lib, 50) if lm else None,
               "bound_ms": bound(c["inputs"], o, c["flops"],
                                 c["peak"])[0]}
        out["kernels"].append(row)
        cold = ("" if not lm else f", L2 cold {row['cold_ms']:.4f} / "
                f"{row['library_cold_ms']:.4f}")
        print(f"decode {c['shape']:48s}: device {row['device_ms']:.4f} ms, "
              f"events {row['ms']:.4f}; torch.matmul device "
              f"{row['library_device_ms']:.4f}, events "
              f"{row['library_ms']:.4f}{cold}; bound {row['bound_ms']:.5f}")

    cfg = get_config(LM)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    eng = LMServingEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_SEQ,
                          device=device)
    tok0 = torch.tensor(np.random.RandomState(0).randint(
        2, cfg.vocab_size, (LM_BATCH, 1)), device=device)
    pos0 = torch.zeros(LM_BATCH, dtype=torch.int64, device=device)
    for key, sched in (("R1", KernelSchedule(reuse_factor=1)),
                       ("R4", KernelSchedule(reuse_factor=4)),
                       ("default", None)):
        dec = eng._decoder_for(sched)
        cache = init_cache(cfg, LM_BATCH, LM_SEQ, "float32", device)

        def step(dec=dec, cache=cache):
            with torch.inference_mode():
                return decode_step(cfg, eng.params, cache, tok0, pos0,
                                   schedule=dec.schedule, packed=dec.packed)

        lat = []
        for i in range(12):
            t0 = time.perf_counter()
            step()[0].float().cpu()
            if i >= 2:                      # the first two build and warm
                lat.append(time.perf_counter() - t0)
        trace = {}
        for _ in range(3):
            trace = device_trace(step)
            if trace:
                break
        out["ticks"][key] = {"tick_p50_ms": float(np.percentile(lat, 50))
                             * 1e3, "tick_min_ms": min(lat) * 1e3,
                             "trace": trace}
        print(f"tick {key:8s}: p50 {out['ticks'][key]['tick_p50_ms']:.3f} "
              f"ms (min {min(lat) * 1e3:.3f}); trace {json.dumps(trace)}")
    del eng, params
    torch.cuda.empty_cache()
    return out


def no_nan(obj):
    """``obj`` with every NaN (a reading the trace did not give) as None,
    so that the line is strict JSON."""
    if isinstance(obj, dict):
        return {k: no_nan(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [no_nan(v) for v in obj]
    return None if isinstance(obj, float) and obj != obj else obj


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--time-scans", action="store_true",
                      help="only time the in-loop scans and the engines "
                      "(see time_scans)")
    what.add_argument("--time-products", action="store_true",
                      help="only time col_matmul, reuse_matmul and "
                      "quant_matmul, the host path, the non-static and "
                      "fixed-point scans and engines (see time_products)")
    what.add_argument("--time-decode", action="store_true",
                      help="only time decode_matmul beside torch.matmul and "
                      "the LM decode tick per key (see time_decode)")
    ap.add_argument("--src", help="with --time-scans, --time-products or "
                    "--time-decode: import repro_torch from this directory "
                    "(default: this checkout's src)")
    opts = ap.parse_args()
    timing = {"time_scans": time_scans, "time_products": time_products,
              "time_decode": time_decode}
    only = next((k for k in timing if getattr(opts, k)), None)
    if opts.src:
        if not only:
            ap.error("--src goes with --time-scans, --time-products or "
                     "--time-decode")
        sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    # f32 parity: no TF32 in cuBLAS (hoist stage, references) or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    if only:
        import repro_torch

        src = Path(repro_torch.__file__).resolve().parents[1]
        print(f"{only}: repro_torch from {src}")
        res = timing[only](device)
        print(json.dumps({only: no_nan({"src": str(src), "card": card,
                                        **res})}))
        return 0

    t0 = time.perf_counter()
    paths = cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{[str(p.relative_to(ROOT)) for p in paths.values()]}")
    ptxas = ptxas_report(paths)
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            lines = log.read_text().splitlines()
            regs = [ln.strip() for ln in lines if "registers" in ln]
            spills = [ln.strip() for ln in lines
                      if "spill" in ln and " 0 bytes spill" not in ln]
            print(f"ptxas {p.name}: {len(regs)} kernels, e.g. "
                  f"{regs[0] if regs else 'n/a'}; spilling: "
                  f"{spills or 'none'}")
    for name in (*PRODUCT_LIBS, "decode_matmul", "decode_matmul_fold"):
        print(f"ptxas {name}: {json.dumps(ptxas_summary(ptxas, name))}")
    for name, frags in ZX_INSTANCES.items():
        print(f"ptxas {name} (cluster zx mode): "
              f"{json.dumps(ptxas_summary(ptxas, 'cluster_scan', *frags))}")

    errs = phase_kernels(device)
    launches = phase_serving(device)
    launches.update(phase_fixed_point(device))
    launches["lm_decode"], lm = phase_lm_decode(device)
    launches["rnn_decode"] = phase_rnn_decode(device)
    launches.update(phase_rglru(device))
    rows, scans = phase_timing(device)

    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "timings": rows, "nonstatic_scans": scans,
         "lm_decode": lm, "launches": launches, "max_abs_err": errs},
        indent=1))

    kernels = []
    for name, (replaces, source) in KERNELS.items():
        row = next(r for r in rows if r["name"] == name and r["headline"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(run[name] for run in launches.values()),
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": row["shape"], "card": card})
        if name in PRODUCT_LIBS or name == "decode_matmul":
            kernels[-1]["layout"] = row["layout"]
            kernels[-1]["ptxas"] = ptxas_summary(ptxas, name)
        if name == "decode_matmul":
            kernels[-1]["ptxas_fold"] = ptxas_summary(ptxas,
                                                      "decode_matmul_fold")
        if name in ZX_INSTANCES:
            kernels[-1]["layout"] = row["layout"]
            kernels[-1]["ptxas"] = ptxas_summary(ptxas, "cluster_scan",
                                                 *ZX_INSTANCES[name])
        if name in CLUSTER_SCANS:
            b8 = next(r for r in rows if r["name"] == name and r["reuse"] == 1
                      and r["tagger"].startswith(HEADLINE)
                      and r["shape"].endswith(f" B={SMALL_BATCHES[0]} R=1"))
            kernels[-1]["layout"] = row["layout"]
            kernels[-1]["b8"] = {k: b8[k] for k in (
                "ms", "device_ms", "library_ms", "library_device_ms",
                "bound_ms", "layout")}
    print(json.dumps({"kernels": no_nan(kernels)}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
