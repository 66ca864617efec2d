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
     steps, float32 and bfloat16, for seven ap_fixed configs, and at its
     edge values (+-0, NaN, +-inf, ties, the rails and just past them,
     |x * 2^F| >= 2^24, subnormals; NaN positions equal) in every config
     and dtype, with the input and the output at every element offset off
     16-byte alignment, through its C entry point;
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
     for bit, R = 2 and 4 equal to R = 1, the launch layout equal to its
     Python model) at (4, 12, 20), the ragged (9, 12, 200),
     recurrentgemma-9b's width (8, 2048, 4096), one sequence of it
     (1, 2048, 4096) and (3, 37, 1001) (a row stride off the 16-byte
     grid), R in {1, 2, 4}, float32, bfloat16 and both mixes, and through
     its C entry point at (3, 37, 200) with a, bx and out at every element
     offset off 16-byte alignment, every dtype pair; ``hadamard`` (bit for
     bit, and equal to ``torch.mul``) at (1500, 200) and (16384, 4096),
     float32 and bfloat16, at (1500, 200) with operands 4, 8 and 12 bytes
     off 16-byte alignment, and through its C entry point at a ragged
     length with a, b and out at every element offset off that alignment;
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
       autotune  design targets: each tagger through
                ``RNNServingEngine(cfg, params, device="cuda",
                max_batch=256)`` for three targets (latency, max_dsp=600,
                throughput >= 1e7 ev/s) x ``fp`` None, ap_fixed<16,6> and
                ap_fixed<8,3> (PTQ'd weights): ``auto_schedule(target,
                measure_top_k=3)``, whose ``measure_points`` must launch
                the scan kernels of the explorer's top three on the card;
                the selected point feasible and among them; 16
                ``submit(target=...)`` requests flushed on one key and one
                executor, and ``predict_one(target=...)``, bit for bit
                equal to ``predict`` of the batch and of one row under
                that schedule (batch-invariant) and within 3e-5 of
                ``backend="xla"``, and 16 requests without a schedule on
                the engine's new default (the measured pick) likewise; a
                target
                no tagger meets raises ``InfeasibleTargetError`` naming
                the nearest point ``explore`` predicts; a point the space
                prunes (an input width the cluster kernel cannot lay out)
                is refused by the launcher on the card, and every static
                and pipeline point of the six taggers' space, kept or
                pruned, gets the same answer from the launcher's
                ``card_layout`` as from ``space._card_legal``.  Each case
                prints
                the selected key, its FPGA-model latency at 200 MHz (the
                paper's model, not a time on the card), ``measure_points``'
                walls on the card and the served p50s;
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
       robustness  batch invariance: for the six taggers, every float
                mode (static, static + hoist, pipeline, non-static) and
                ``ap_fixed<16,6>`` / ``<8,3>`` at R in {1, 4},
                ``predict_one(x) == predict(x[None])[0] == predict(X)[i]
                == submit + flush`` of 256, bit for bit
                (``--batch-invariance`` prints the same report, launch by
                launch, for any tree without failing); the compile cache
                (``RNNServingEngine(cache_dir=...)``): each tagger cold,
                then a second engine over the same directory warm (no
                launch in ``prewarm``, no ``nvcc``, no residency query, no
                executor build, the same answers), each entry naming every
                library and C entry point of a real run; QuickDraw LSTM in
                fresh processes, cold then warm, with the first request's
                wall; a corrupted cache: one warning, one quarantine, a
                correct cold serve; the router: 3 replicas of flavor
                tagging's LSTM on the card with a crash, a straggler and a
                flapping replica armed, every request in exactly one
                terminal state, exact accounting, every answer bit for bit
                ``predict_one``; streaming: top tagging's GRU through
                ``StreamingPipeline`` over a 3-rung degradation ladder, a
                2x burst then a 0.5x tail in ``VirtualClock`` time, down
                the ladder and back, exact ``KeyCounts``, rung-0 answers
                bit for bit direct ``predict``;
       lm_decode  gemma-2b at its published width and depth (18 layers,
                d_model 2048, bf16, seeded weights drawn on the card)
                served through ``LMServingEngine(device="cuda")``: 4
                requests of 8 prompt + 8 new tokens on keys R = 1, R = 4
                (every projection on ``decode_matmul``, 72 calls a tick,
                and in a trace of one tick exactly the device kernels their
                layouts launch) and the default key (einsum); R = 1 and
                R = 4 give the same tokens and first-step logits bit for
                bit, the einsum logits agree within 2e-2; one executor per
                key; the R = 1 key's ``prewarm`` before the first tick
                (no launch);
       speculative  gemma-2b again, on six keys (``SPEC_KEYS``: R = 1,
                the default key, R = 1 + ``SpecConfig(k=4)`` (n-gram
                draft), the same with ``trim=True``, R = 1 +
                ``SpecConfig(k=2, draft=R4)``, the default key +
                ``SpecConfig(k=3)``): each speculative key's tokens equal
                its sequential key's bit for bit for every request,
                ``verify_spec_accounting`` holds, one verify executor and
                at most one draft executor, ``prewarm(..., spec=)``
                launches nothing, and ``decode_matmul`` is called exactly
                72 times a sequential R = 1 tick, a verify round and a
                draft step; then, outside the counts, ``decode_steps`` over
                5 tokens against 5 ``decode_step`` calls on a fresh cache
                (R = 1 and 4, logits and caches bit for bit), ``kv_trim``
                after wrong-branch writes (the clean prefix's cache bit for
                bit), ``decode_matmul(x)[rows] == decode_matmul(x[rows])``
                at M in {4, 8, 12, 20} at gemma-2b's four products, and the
                verify pass (B = 4, S = 5) and ``decode_matmul`` at M = 20
                timed beside one sequential step and ``torch.matmul``, with
                device traces; per key tokens/s (accepted tokens), round
                p50 / p99 and the accept rate;
       speculative_rnn  ``speculative_generate`` over a toy LM on the
                native ``ap_fixed<8,3>`` ``rnn_decode_step`` (``quant_matmul``)
                at k in {2, 4}: the tokens of sequential greedy decode;
       dense_lms  deepseek-coder-33b (4 of its 62 layers) and
                nemotron-4-340b (1 of 96) at their published widths, bf16,
                seeded weights drawn on the card, one after the other
                through ``LMServingEngine(device="cuda")`` on keys R = 1,
                R = 4 and the default: R = 1 and R = 4 give the same tokens
                and first-step logits bit for bit, the einsum logits agree
                within 2e-2, 4·L ``decode_matmul`` calls a scheduled tick;
                after ``del`` of each engine, and then of its params, at
                most 1 GB stays allocated (the residency cache holds its
                sources weakly: no cycle collection needed);
       families  the other LM families at their published widths and full
                depth, bf16, seeded weights drawn on the card, one model at
                a time (``FAMILY_LMS``: qwen2-moe-a2.7b, qwen3-moe-30b-a3b,
                mamba2-780m, recurrentgemma-9b, whisper-medium,
                phi-3-vision-4.2b) through ``LMServingEngine(device=
                "cuda")`` on keys R = 1, R = 4, the default and, for moe,
                enc-dec and vlm, R = 1 + an n-gram ``SpecConfig(k=4)``:
                phi-3-vision R = 1 == R = 4 bit for bit and 4·L
                ``decode_matmul`` calls a scheduled tick and verify round;
                the others R = 1 == R = 4 == default bit for bit (tokens,
                first-step logits) with no kernel of the port launched;
                speculative tokens == sequential; mamba2 and
                recurrentgemma refuse ``spec=``; each family's tiny config
                on the card within 3e-5 of the CPU; per model the peak
                allocation after init and while serving, tick p50 / p99,
                tokens/s and one tick's device busy and idle share;
                ``lm_decode``, ``dense_lms`` and ``families`` also run each
                model's sequence forward (``forward_report``:
                ``Model.forward`` at B = 2 x 512 prompt tokens; whisper
                1500 frames + 64 tokens, phi-3-vision 576 patches + 512
                tokens): logits finite, no port kernel, host ms of 5
                synchronised forwards, prompt tokens/s, peak allocation,
                one forward's device kernels and idle share;
       prefill  the sequence forward, the LM loss and the LM trainer (no
                kernel of the port lies on this path, as none in
                ``repro``'s; the counts must stay 0): each of the ten LMs'
                tiny configs, ``Model.forward`` and ``Model.loss`` with
                every parameter's gradient on the card within 3e-5 of the
                CPU, and the card's forward == its own teacher-forced
                ``decode_step`` chain within 5e-4 (MoE at capacity 8.0,
                whisper's cross K / V precomputed); gemma-2b at published
                width in float32, forward == its 32-step decode chain
                within 5e-4 of max |logit|; stablelm-3b's forward at
                published width; ``launch.train.train`` of gemma-2b,
                stablelm-3b and mamba2-780m at published width (20 steps
                of 4 x 256 tokens at the trainer's lr 1e-3, its AdamW in
                place): every loss finite and, but for stablelm-3b's
                (which rises: ROADMAP.md §3), the last below the first and
                the last five's mean below the first five's, peak
                allocation beside the state (gemma-2b and stablelm-3b
                under 1.7x), step time, device kernels and idle share;
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
       train    the taggers trained on the card through the port's trainer
                (``repro_torch.launch.train``; forward and backward on the
                reference path, as ``repro`` trains): top tagging's GRU
                and LSTM for 150 steps of 128 at lr 5e-3 to a held-out AUC
                > 0.9 (1000 events, seed 99) on the reference and on
                ``RNNServingEngine(device="cuda")`` (within 3e-5; the
                cluster scan and ``col_matmul`` launched), PTQ'd to
                ap_fixed<16,6> (AUC ratio > 0.98) and <6,6> (AUC down by
                more than 0.02), and the native <8,3> engine on
                ``quant_matmul`` bit for bit equal to the emulation;
                flavor tagging and QuickDraw, LSTM and GRU, 40 steps each
                (the mean loss of the last 5 below the first 5), served on
                the kernels within 3e-5; a run saved at step 3, restored
                and continued bit for bit equal to the uninterrupted one;
                ``grad_accum=2`` against the full batch; one run with
                compressed gradients; then, outside the counts, the
                port's conformance harness (``repro_torch.testing``) on
                the card and each tagger's training step timed (host
                clock, synchronised) and traced;
       serve    the single-card drivers: ``launch.serve.serve_rnn`` for
                the six taggers (seeded weights, 512 requests through the
                micro-batcher) in static mode (the cluster scan and
                ``col_matmul`` launched) and non-static mode
                (``col_matmul``), and top tagging's GRU with
                ``--fixed-point`` (the ap_fixed<16,6> emulation: no kernel
                of the port): every request served once, events/s and p50
                / p99 finite, the answers bit for bit the engine's
                ``predict`` and, in float, within 3e-5 of
                ``backend="xla"``; ``benchmark()`` at B = 1 and 256 on each
                tagger's default key (one executor build); ``serve_lm`` on
                gemma-2b's tiny config; ``examples.quickstart`` end to end
                (AUC > 0.9, <16,6> ratio > 0.98);
       distributed  distribution and launch (no kernel of the port on
                the path, as none on ``repro``'s; the counts must stay 0):
                (a) the dry run (``launch/dryrun.py``, a one-process
                ``"fake"`` group) of gemma-2b, stablelm-3b and mamba2-780m
                on a one-rank mesh, training at 4 x 256 (``remat="full"``,
                the trainer's step) and the forward at 2 x 512: its
                params + AdamW state bytes equal the card's tensors and
                the bytes asked of the allocator, exactly, its peak estimate
                printed beside phase ``prefill``'s measured peak; (b)
                ``FlopCounterMode`` of the forward on meta tensors equal to
                its count on the card, beside ``model_flops`` and the
                forward's share of the bf16 peak; (c) the stage pipeline
                (``core/rnn/pipeline.py``) over 4 ranks sharing the card
                (spawned here; gloo, one rank if the compute mode is
                exclusive) for top tagging's LSTM and GRU, plain and
                hoisted, within 1e-5 of the static scan kernels (rows 1 and
                3, a comparison outside the counts); (d)
                ``launch.train.train(mesh_shape=(1, 1))`` of a tiny LM on the
                card: DTensor params, pinned ``grad_shardings``, every loss
                within 2e-4 of the unsharded run's;
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

    python3 chip_smoke.py --time-elementwise [--src DIR]

likewise times only ``rglru_scan`` (``RGLRU_TIMED``: recurrentgemma-9b's
width at R = 1 and 4, in f32 and bf16, and one sequence, with its launch
layout and ``torch.mul(a, bx)`` as the floor for the same bytes),
``fixed_point`` (QuickDraw LSTM's gate block of one step and of all T
steps, f32 and bf16, every ``FP_GRID`` config) and ``hadamard``
(``HADAMARD_SHAPES``, f32 and bf16): events, device ms and device ms after
an L2 flush, beside ``fake_quantize_per_tensor_affine`` (rnd / sat
configs) and ``torch.mul``, and the bytes bound held against the L2-cold
time.

    python3 chip_smoke.py --families [--src DIR]

runs only phase 3 ``families`` (the kernels built on first use) and prints
its report as a JSON line of its own and no result line.

    python3 chip_smoke.py --prefill

runs only phase 3 ``prefill`` and the forward of every LM at published
width (each drawn, reported and freed in turn) and prints its report as a
JSON line of its own and no result line.

    python3 chip_smoke.py --serve

runs only phase 3 ``serve`` (the kernels built on first use) and prints
its report as a JSON line of its own and no result line.

    python3 chip_smoke.py --train-lm ARCH

trains only ``ARCH`` at published width as phase 3 ``prefill`` does
(``train_lm``) and prints its losses, peak allocation beside its state
and step time as a JSON line of its own; an LM that does not fit the card
ends the run with the allocator's out-of-memory error.

    python3 chip_smoke.py --distributed

runs only phase 3 ``distributed`` (the kernels built on first use) and
prints its report as a JSON line of its own and no result line.

    python3 chip_smoke.py --graphs

checks only the serving executors' CUDA graph replay
(``serving/graphs.py``, :func:`check_graphs`; also run after phase 3
``distributed`` in the full run): replayed answers bit for bit the eager
ones for static, non-static and pipeline QuickDraw LSTM at B = 1, 256
and 2048, 100 consecutive replays unaliased, 4 launches and 1 replay
recorded for a bulk call, the graph's kernels under their own names in
the trace; and prints the host wall of eager and replayed calls and a
chunk's copy onto the card (CUDA's pageable copy against staging
through a pinned buffer), as a JSON line of its own and no result line.

    python3 chip_smoke.py --batch-invariance [--src DIR]

builds the kernels and prints, for every case of phase 3's batch
invariance check, the largest difference between one event's answers in
every batch shape and launch by launch (the hoist's zx, the scan's final
h, the head's logits), for any tree, without failing on a difference.
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
#: rglru_scan's checked shapes (B, T, W): small, a ragged width, full width,
#: one sequence at full width, and a row stride W * itemsize that is no
#: multiple of 16 bytes (one element a thread)
RGLRU_SHAPES = ((4, 12, 20), (9, 12, 200), (RG_B, RG_T, RG_W),
                (1, RG_T, RG_W), (3, 37, 1001))
#: rglru_scan's offset checks: a, bx and out at every element offset off
#: the 16-byte grid, at a width whose rows keep that grid
RGLRU_OFFSET_SHAPE = (3, 37, 200)
#: hadamard's shapes: a ragged row count, and the RG-LRU path's (B*T, W)
HADAMARD_SHAPES = ((1500, 200), (RG_B * RG_T, RG_W))
#: the streaming kernels' (fixed_point, hadamard) edge checks: a length
#: that is no multiple of 4 vectors of 16 bytes (n = 304 297), at every
#: element offset of each operand and of the output off 16-byte alignment
RAGGED_STREAM = 1499 * 203
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


def fake_quantize_library(x, fp):
    """``fake_quantize_per_tensor_affine`` of ``x`` onto ``fp``'s grid: the
    same function as ``fixed_point`` where it rounds half to even and
    saturates (rnd / sat), else None."""
    import torch

    from repro_torch.core.quant.fixed_point import grid_constants

    if (fp.rounding, fp.saturation) != ("rnd", "sat"):
        return None
    scale, lo, hi = grid_constants(fp)
    return lambda: torch.fake_quantize_per_tensor_affine(x, 1.0 / scale, 0,
                                                         int(lo), int(hi))


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
                lib = (fake_quantize_library(x, fp)
                       if timing and dtype == torch.float32 else None)
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
                    (B, T, W) == (RG_B, RG_T, RG_W) and reuse == 1
                    and dt == torch.float32)
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
        # operands 4, 8 and 12 bytes off 16-byte alignment, alike and apart
        rows, cols = HADAMARD_SHAPES[0]
        base = torch.randn(2, rows * cols + 3, generator=gen, device=device)
        for ox, oy in ((1, 1), (2, 2), (3, 3), (1, 2), (3, 0)):
            x = base[0, ox:ox + rows * cols].view(rows, cols)
            y = base[1, oy:oy + rows * cols].view(rows, cols)
            yield (rows, cols), 1, call(
                "hadamard", f"({rows}, {cols}) float32 +{4 * ox}/+{4 * oy} B",
                lambda x=x, y=y: hd.hadamard_kernel(x, y),
                lambda x=x, y=y: hd.hadamard_plain(x, y),
                (x, y), float(x.numel()), lambda x=x, y=y: torch.mul(x, y))


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


def same_bits_nan(got, want) -> bool:
    """Equal bit for bit where ``want`` is a number, NaN where it is NaN
    (the payload and sign of a NaN are not compared)."""
    import torch

    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and same_bits(torch.where(nan, 0, got), torch.where(nan, 0, want)))


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


#: device kernels (by name) a trace reading lists, the longest first
TRACE_TOP = 6


def device_trace(fn, calls: int = 1, inference: bool = True) -> dict:
    """Read ``calls`` calls of ``fn`` from a ``torch.profiler`` trace of the
    device: the span from the first device event to the last, the time
    some device event ran (the union of their intervals) and its idle
    share, per group of kernels the launches and their device time, and
    the ``TRACE_TOP`` kernel names of the most device time.
    Empty where the trace holds no device event.  ``inference=False``
    leaves autograd on (a training step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(inference):
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
    names: dict = {}
    for start, stop, name in events:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        group = next((g for frag, g in KERNEL_GROUPS if frag in name),
                     "other")
        n, us = groups.get(group, (0, 0.0))
        groups[group] = (n + 1, us + stop - start)
        n, us = names.get(name[:80], (0, 0.0))
        names[name[:80]] = (n + 1, us + stop - start)
    span = end - events[0][0]
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:TRACE_TOP]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span if span else 0.0,
            "kernels": {g: {"launches": n, "device_ms": us / 1e3}
                        for g, (n, us) in groups.items()},
            "top": [[name, n, us / 1e3] for name, (n, us) in top]}


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
    check_stream_edges(device, errs)
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


def rglru_layouts(a, bx, out) -> tuple:
    """(the Python model's, the C launcher's) layout of ``rglru_scan`` for
    these tensors on their card: ``rglru_layout`` and ``rglru_scan_layout``
    at the same addresses and SM count."""
    import ctypes

    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.rglru_scan import RglruLayout, layout_of

    B, _, W = a.shape
    lay = (ctypes.c_longlong * len(RglruLayout._fields))()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    rc = cuda.function("rglru_scan", "rglru_scan_layout")(
        a.data_ptr(), int(a.dtype == torch.bfloat16), bx.data_ptr(),
        int(bx.dtype == torch.bfloat16), out.data_ptr(), B, W, sms, lay)
    check(rc == 0, f"rglru_scan_layout returned {rc}")
    return layout_of(a, bx, out), RglruLayout(*lay)


def check_elementwise(device, errs: dict) -> None:
    """``rglru_scan`` and ``hadamard`` bit for bit against their plain
    versions, R = 2 and 4 against R = 1, ``hadamard`` against
    ``torch.mul``, ``rglru_scan``'s launch layout against its Python model,
    and ``rglru_scan`` with its operands off the 16-byte grid
    (:func:`check_rglru_offsets`); the largest error per kernel goes into
    ``errs``."""
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
        if c["name"] == "rglru_scan":
            model, card = rglru_layouts(*c["inputs"], got)
            print(f"check rglru_scan {c['shape']:44s}: layout {card}, "
                  f"model {'equal' if model == card else model}")
            check(model == card, f"rglru_scan {c['shape']}: the launcher "
                  f"plans {card}, the model {model}")
        errs[c["name"]] = max(errs.get(c["name"], 0.0), err)
    check_rglru_offsets(device)


def check_rglru_offsets(device) -> None:
    """``rglru_scan`` through its C entry point at ``RGLRU_OFFSET_SHAPE``,
    every dtype pair, with a, bx and out at every element offset off the
    16-byte grid and R in {1, 2, 4}: bit for bit equal to
    ``rglru_scan_plain``, R = 2 and 4 equal to R = 1 (the same instance),
    and the launch layout equal to its Python model."""
    import itertools

    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.ops import rglru_tiles
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.schedule import KernelSchedule

    B, T, W = RGLRU_OFFSET_SHAPE
    gen = torch.Generator(device=device).manual_seed(820)
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, bdt in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)):
        a, bx = rglru_inputs(B, T, W, dt, gen, device, bdt)
        want = rglru_scan_plain(a, bx)
        elems = lambda d: range(16 // torch.empty((), dtype=d)  # noqa: E731
                                .element_size())
        bad, routes = [], set()
        for oa, ob, oo in itertools.product(elems(dt), elems(bdt), elems(dt)):
            av, bv = offset_copy(a, oa), offset_copy(bx, ob)
            first = None
            for reuse in (1, 2, 4):
                bb, bw, serial = rglru_tiles(KernelSchedule(
                    reuse_factor=reuse), B, W)
                # NaN in every output slot: a state of these inputs is none
                out = offset_copy(torch.full_like(a, float("nan")), oo)
                cuda.launch("rglru_scan", "rglru_scan", device,
                            av.data_ptr(), int(dt == bf16), bv.data_ptr(),
                            int(bdt == bf16), out.data_ptr(), B, T, W, bb, bw,
                            int(serial))
                torch.cuda.synchronize()
                got = out.view(B, T, W)
                first = got if first is None else first
                if not (same_bits(got, want) and same_bits(got, first)):
                    bad.append((oa, ob, oo, reuse))
            model, card = rglru_layouts(av.view(B, T, W), bv.view(B, T, W),
                                        out.view(B, T, W))
            check(model == card, f"rglru_scan at offsets {(oa, ob, oo)}: "
                  f"the launcher plans {card}, the model {model}")
            routes.add("ring" if card.ring else f"window vec={card.vec}")
        n = len(elems(dt)) ** 2 * len(elems(bdt))
        print(f"check rglru_scan offsets ({B},{T},{W}) {str(dt)[6:]}/"
              f"{str(bdt)[6:]}: {n} offsets of a / bx / out x R in 1, 2, 4, "
              f"bit for bit equal to the plain version and to R=1 at "
              f"{3 * n - len(bad)} of {3 * n}; routes {sorted(routes)}")
        check(not bad, f"rglru_scan {dt}/{bdt}: differs at element offsets "
              f"(a, bx, out, R) {bad[:8]}")


def offset_copy(t, elems: int):
    """A copy of ``t`` (flat) whose first element lies ``elems`` elements
    past a 16-byte boundary (PyTorch's allocations start on one)."""
    import torch

    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[elems:elems + t.numel()]
    view.copy_(t.reshape(-1))
    return view


def check_stream_edges(device, errs: dict) -> None:
    """The streaming body of ``fixed_point`` and ``hadamard`` through their
    C entry points at ``RAGGED_STREAM`` elements, with every operand and the
    output at every element offset off 16-byte alignment (a scalar head,
    vectors assembled from narrower loads, a scalar tail): ``hadamard``
    bit for bit equal to ``torch.mul``; ``fixed_point`` at ``edge_values``
    (tiled) in every ``FP_GRID`` mode bit for bit equal to its plain
    version, NaN positions equal."""
    import itertools

    import torch

    from repro_torch.core.quant.fixed_point import grid_constants
    from repro_torch.kernels import cuda
    from repro_torch.kernels.fixed_point import edge_values, fixed_point_plain

    gen = torch.Generator(device=device).manual_seed(810)
    for dt in (torch.float32, torch.bfloat16):
        offsets = range(16 // torch.empty((), dtype=dt).element_size())
        bf16 = int(dt == torch.bfloat16)
        a, b = (torch.randn(RAGGED_STREAM, generator=gen,
                            device=device).to(dt) for _ in range(2))
        want = torch.mul(a, b)
        bad = []
        for oa, ob, oo in itertools.product(offsets, repeat=3):
            av, bv = offset_copy(a, oa), offset_copy(b, ob)
            # NaN in every output slot: a product of numbers is none
            out = offset_copy(torch.full_like(a, float("nan")), oo)
            cuda.launch("hadamard", "hadamard", device, av.data_ptr(),
                        bv.data_ptr(), bf16, out.data_ptr(), RAGGED_STREAM)
            torch.cuda.synchronize()
            if not same_bits(out, want):
                bad.append((oa, ob, oo))
        print(f"check hadamard n={RAGGED_STREAM} {str(dt)[6:]}: "
              f"{len(offsets) ** 3} offsets of a / b / out, bit for bit "
              f"equal to torch.mul at {len(offsets) ** 3 - len(bad)}")
        check(not bad, f"hadamard {dt}: differs from torch.mul at element "
              f"offsets (a, b, out) {bad[:8]}")
        for spec in FP_GRID:
            fp = fixed_point_config(spec)
            x = edge_values(fp).to(device)
            x = x.repeat(RAGGED_STREAM // x.numel() + 1)[:RAGGED_STREAM]
            x = x.to(dt)
            want = fixed_point_plain(x, fp)
            scale, lo, hi = grid_constants(fp)
            bad, err = [], 0.0
            for ox, oo in itertools.product(offsets, repeat=2):
                xv = offset_copy(x, ox)
                # 0.3 in every output slot: on none of the grids
                out = offset_copy(torch.full_like(x, 0.3), oo)
                cuda.launch("quantized", "fixed_point", device, xv.data_ptr(),
                            bf16, out.data_ptr(), RAGGED_STREAM, scale, lo,
                            hi, int(fp.rounding == "rnd"),
                            int(fp.saturation == "sat"),
                            2.0 ** fp.total_bits)
                torch.cuda.synchronize()
                if not same_bits_nan(out, want):
                    bad.append((ox, oo))
                num = torch.isfinite(want)
                err = max(err, float((out[num].float() - want[num].float())
                                     .abs().max()))
            print(f"check fixed_point edges n={RAGGED_STREAM} "
                  f"{str(dt)[6:]:8s} ap{'_'.join(map(str, spec))}: "
                  f"{len(offsets) ** 2} offsets of x / out, max_abs_err "
                  f"{err:.3e} over the finite values, bit for bit (NaN "
                  f"positions equal) at {len(offsets) ** 2 - len(bad)}")
            check(not bad, f"fixed_point {spec} {dt}: differs from its "
                  f"plain version at element offsets (x, out) {bad[:8]}")
            errs["fixed_point"] = max(errs.get("fixed_point", 0.0), err)


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


#: batch invariance: the float modes and reuse factors checked for every
#: tagger, and the fixed-point configs (static, R in INVARIANCE_REUSES)
INVARIANCE_MODES = (("static", {}), ("static_hoist", {"hoist_input": True}),
                    ("pipeline", {"mode": "pipeline"}),
                    ("nonstatic", {"mode": "nonstatic"}))
INVARIANCE_REUSES = (1, 4)
INVARIANCE_FPS = (FP_EMULATED, FP_NATIVE["int8"])
#: the rows of a 256-row batch each case follows through every batch shape
INVARIANCE_ROWS = (0, 1, 137, BATCH - 1)


def bit_diff(a, b) -> float:
    """Largest |a - b| (0.0 where both are bit for bit equal; inf where
    the bits differ but the values do not, as +0.0 / -0.0)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if np.array_equal(a.view(np.int32), b.view(np.int32)):
        return 0.0
    d = float(np.abs(a - b).max())
    return d if d > 0 else float("inf")


def batch_invariance(device, strict: bool) -> dict:
    """One event's answer in every batch shape: for each tagger (seeded
    weights, ``RNNServingEngine(impl="pallas", max_batch=256)``), each
    float mode of ``INVARIANCE_MODES`` x R in ``INVARIANCE_REUSES`` and
    each fixed-point config of ``INVARIANCE_FPS`` at static R in the same,
    row i of ``INVARIANCE_ROWS`` as ``predict_one(X[i])``,
    ``predict(X[i:i+1])[0]``, ``predict(X)[i]`` (B = 256) and
    ``submit`` x 256 + ``flush``.  For the float cases it also prints the
    largest |difference| launch by launch, one row against its row of
    B = 256: the hoist's zx (``ops._hoist_stage``, where the schedule
    hoists), the scan's final h (``rnn_layer``) and the head's logits.
    ``strict``: every answer must be bit for bit equal (phase 3
    ``robustness``); otherwise only report (``--batch-invariance``, which
    also runs on an older tree)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rnn.layer import rnn_layer
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    rows = []
    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        rnn = cfg.rnn
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        eng = RNNServingEngine(cfg, params, impl="pallas", device=device,
                               max_batch=BATCH)
        X = np.random.RandomState(900 + i).randn(
            BATCH, rnn.seq_len, rnn.input_size).astype(np.float32)
        Xt = torch.from_numpy(X).to(device)
        wts = eng.model.weights
        W, U, b = (wts[f"rnn/{n}"] for n in ("kernel", "recurrent", "bias"))
        cases = [(m, R, kw, None) for m, kw in INVARIANCE_MODES
                 for R in INVARIANCE_REUSES]
        cases += [("static", R, {}, spec) for spec in INVARIANCE_FPS
                  for R in INVARIANCE_REUSES]
        for mode, R, kw, spec in cases:
            fp = None if spec is None else fixed_point_config(spec)
            fp_name = ("float" if fp is None else
                       f"ap_fixed<{fp.total_bits},{fp.integer_bits}>")
            sched = KernelSchedule(reuse_factor=R, **kw)
            full = eng.predict(X, schedule=sched, fp=fp)
            reqs = [eng.submit(X[j], schedule=sched, fp=fp)
                    for j in range(BATCH)]
            eng.flush(force=True)
            check(all(q.status == "answered" for q in reqs),
                  f"{tag} {mode}: a request was not answered")
            flushed = np.stack([q.result for q in reqs])
            row = {"tagger": tag, "mode": mode, "R": R, "fp": fp_name,
                   "one_vs_full": 0.0, "one_vs_p1": 0.0,
                   "flush_vs_full": 0.0}
            for j in INVARIANCE_ROWS:
                one = eng.predict_one(X[j], schedule=sched, fp=fp)
                p1 = eng.predict(X[j:j + 1], schedule=sched, fp=fp)[0]
                for k, d in (("one_vs_full", bit_diff(one, full[j])),
                             ("one_vs_p1", bit_diff(one, p1)),
                             ("flush_vs_full",
                              bit_diff(flushed[j], full[j]))):
                    row[k] = max(row[k], d)
            if fp is None:
                launch = {"zx": None, "h": 0.0, "logits": 0.0}
                hoists = sched.hoist_input or mode == "pipeline"
                with torch.inference_mode():
                    for j in INVARIANCE_ROWS:
                        x1 = Xt[j:j + 1]
                        if hoists and mode != "nonstatic":
                            one = ops._hoist_stage(
                                ops._pad_axis(x1, 0, 8), W,
                                sched)[0]
                            many = ops._hoist_stage(Xt, W, sched)[j]
                            launch["zx"] = max(launch["zx"] or 0.0,
                                               bit_diff(one.cpu(),
                                                        many.cpu()))
                        for k, fn in (
                                ("h", lambda x: rnn_layer(
                                    rnn, x, W, U, b, impl="pallas",
                                    schedule=sched)),
                                ("logits", lambda x: eng.model(
                                    x, impl="pallas", schedule=sched,
                                    return_logits=True))):
                            launch[k] = max(launch[k], bit_diff(
                                fn(x1)[0].cpu(), fn(Xt)[j].cpu()))
                row["launch"] = launch
            row["bitwise"] = (row["one_vs_full"] == row["one_vs_p1"]
                              == row["flush_vs_full"] == 0.0)
            rows.append(row)
            per_launch = ("" if fp is not None else
                          "; launch by launch: zx " + (
                              "-" if row["launch"]["zx"] is None
                              else f"{row['launch']['zx']:.3e}")
                          + f", final h {row['launch']['h']:.3e}, logits "
                          f"{row['launch']['logits']:.3e}")
            print(f"batch_invariance {tag:20s} {mode:12s} R{R} "
                  f"{fp_name:15s}: predict_one vs predict(X)[i] "
                  f"{row['one_vs_full']:.3e}, vs predict(x[None])[0] "
                  f"{row['one_vs_p1']:.3e}, flush vs predict(X) "
                  f"{row['flush_vs_full']:.3e}{per_launch}: "
                  f"{'bit for bit' if row['bitwise'] else 'DIFFERS'}")
            if strict:
                check(row["bitwise"], f"batch invariance: {tag} {mode} R{R} "
                      f"{fp_name} differs across batch shapes: {row}")
    n = sum(r["bitwise"] for r in rows)
    print(f"batch_invariance: {n} of {len(rows)} cases bit for bit equal "
          f"across predict_one, predict(x[None]), predict(X) and flush of "
          f"{BATCH}")
    return {"cases": len(rows), "bitwise": n, "rows": rows}


#: phase 3 ``robustness``: where the compile cache keeps its entries (made
#: anew each run, under the checkout's build directory), the tagger timed
#: cold against warm in fresh processes, the router's replicas and
#: requests, and the streaming replay's events
CACHE_ROOT = ROOT / "build" / "robustness_cache"
CACHE_CHILD_TAGGER = "quickdraw-lstm"
ROUTER_TAGGER = "flavor-tagging-lstm"
ROUTER_REPLICAS = 3
ROUTER_REQUESTS = 24
STREAM_TAGGER = "top-tagging-gru"
STREAM_EVENTS = (300, 400)        # the 2x burst, then the 0.5x tail


def tagger_engine(tag, device, **kw):
    """(cfg, params, engine) of one tagger with the seeded weights phase 3
    gives it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    cfg = get_config(tag)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(
        TAGGERS.index(tag)), "cpu")
    return cfg, params, RNNServingEngine(cfg, params, impl="pallas",
                                         device=device, **kw)


def tagger_events(cfg, n, seed):
    r = cfg.rnn
    return np.random.RandomState(seed).randn(
        n, r.seq_len, r.input_size).astype(np.float32)


def serve_flush(eng, x):
    reqs = eng.serve(list(x))
    check(all(q.status == "answered" for q in reqs),
          f"{eng.cfg.name}: a flushed request was not answered")
    return np.stack([q.result for q in reqs])


def counts_since(before: dict, now: dict) -> dict:
    """The calls of ``now`` (a ``cuda.LAUNCHES`` / ``cuda.ENTRIES``
    snapshot) made since ``before``, nonzero only."""
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def answer_digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()[:16]


def cache_child(cache_dir: str, tag: str) -> int:
    """``--cache-child DIR TAGGER``: a fresh process's first request over
    the compile cache in DIR: ``prewarm`` (launches counted), then one
    flush of ``BATCH`` events, timed from engine construction (the CUDA
    context is made first, untimed); prints one JSON line (counts,
    first-request wall, an answer digest)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.schedule import schedule_key

    device = torch.device("cuda", 0)
    x = tagger_events(get_config(tag), BATCH, 300 + TAGGERS.index(tag))
    torch.zeros(1, device=device)           # the CUDA context, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, eng = tagger_engine(tag, device, cache_dir=cache_dir)
    pre = eng.prewarm()
    prewarm_launches = sum(cuda.LAUNCHES.values())
    got = serve_flush(eng, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    key = schedule_key(eng.resolved_schedule)
    row = eng.serve_report()[key]["compile"]
    print(json.dumps({
        "tagger": tag, "key": key, "prewarm": pre[key]["status"],
        "prewarm_launches": prewarm_launches,
        "first_request_s": wall, "cold": row["cold"], "warm": row["warm"],
        "trace_count": eng.trace_count(key), "nvcc": cuda.COUNTS["nvcc"],
        "residency_queries": cuda.COUNTS["residency"],
        "launches": dict(cuda.LAUNCHES), "digest": answer_digest(got)}))
    return 0


def run_cache_child(root, cache_dir, tag) -> dict:
    """:func:`cache_child` in a fresh process, from the checkout at
    ``root`` (its ``src`` and its ``build/kernels``)."""
    out = subprocess.run(
        [sys.executable, str(Path(root) / "chip_smoke.py"), "--cache-child",
         str(cache_dir), tag], capture_output=True, text=True, timeout=300,
        cwd=root)
    check(out.returncode == 0, f"cache child failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_compile_cache(device) -> dict:
    """One engine per float tagger starts cold over a fresh cache; a second
    engine over the same directory readies its key warm (no launch, no
    ``nvcc``, no residency query, no executor build) and answers bit for
    bit as the first; each entry names every library and C entry point a
    real run of its key calls.  Then one tagger in fresh processes, cold
    and warm, with the first request's wall, and warm in a copy of the
    checkout with no ``build/kernels`` (its libraries come from the
    entry's copies, no ``nvcc``); then a corrupted cache: one warning,
    one quarantine, a correct cold serve."""
    import shutil
    import warnings

    from repro_torch.kernels import cuda
    from repro_torch.kernels.schedule import schedule_key
    from repro_torch.serving import corrupt_cache_entries
    from repro_torch.serving.compile_cache import CACHE_SUFFIX

    shutil.rmtree(CACHE_ROOT, ignore_errors=True)
    shared = CACHE_ROOT / "shared"
    lib_of = {fn: lib for lib, fns in cuda.SIGNATURES.items() for fn in fns}
    firsts = {}
    for i, tag in enumerate(TAGGERS):
        cfg, _, cold = tagger_engine(tag, device, cache_dir=shared)
        x = tagger_events(cfg, BATCH, 300 + i)
        key = schedule_key(cold.resolved_schedule)
        before = dict(cuda.ENTRIES)
        firsts[tag] = serve_flush(cold, x)
        used = counts_since(before, cuda.ENTRIES)
        crow = cold.serve_report()[key]["compile"]
        check(crow["cold"] == 1 and crow["warm"] == 0
              and cold.trace_count(key) == 1,
              f"{tag}: cold engine compile row {crow}")
        entry = next(p for p in shared.glob(f"{key[:48]}-*{CACHE_SUFFIX}")
                     if json.loads(p.read_text())["meta"]["cfg"]
                     == repr(cfg))
        doc = json.loads(entry.read_text())
        check(used and set(used) <= set(doc["entries"])
              and {lib_of[e] for e in used} <= set(doc["libraries"]),
              f"{tag}: entry declares {doc['libraries']} / "
              f"{doc['entries']}, a real run called {used}")
        _, _, warm = tagger_engine(tag, device, cache_dir=shared)
        counts, before = dict(cuda.COUNTS), dict(cuda.LAUNCHES)
        pre = warm.prewarm()[key]
        grew = counts_since(before, cuda.LAUNCHES)
        check(pre["status"] == "warm" and not grew
              and cuda.COUNTS == counts,
              f"{tag}: warm prewarm {pre}, launches {grew}, "
              f"counts {cuda.COUNTS} (before {counts})")
        again = serve_flush(warm, x)
        wrow = warm.serve_report()[key]["compile"]
        check(wrow["warm"] == 1 and wrow["cold"] == 0
              and warm.trace_count(key) == 0 and cuda.COUNTS == counts,
              f"{tag}: warm engine compile row {wrow}, "
              f"{warm.trace_count(key)} builds, counts {cuda.COUNTS}")
        check(np.array_equal(again.view(np.int32),
                             firsts[tag].view(np.int32)),
              f"{tag}: the warm engine's answers differ from the cold one's")
        print(f"robustness compile cache {tag:20s} {key}: cold engine "
              f"{crow['first_compile_s'] * 1e3:.1f} ms first flush "
              f"(libraries {sorted(doc['libraries'])}, "
              f"{len(doc['layouts'])} launch layouts); warm engine: prewarm "
              f"{pre['status']}, 0 launches, 0 nvcc, 0 residency queries, "
              f"0 builds, answers bit for bit the cold engine's")

    fresh = CACHE_ROOT / "fresh"
    cold_p = run_cache_child(ROOT, fresh, CACHE_CHILD_TAGGER)
    warm_p = run_cache_child(ROOT, fresh, CACHE_CHILD_TAGGER)
    bare = CACHE_ROOT / "bare"
    shutil.copytree(ROOT / "src" / "repro_torch", bare / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", bare / "chip_smoke.py")
    bare_p = run_cache_child(bare, fresh, CACHE_CHILD_TAGGER)
    copied = sorted(p.name for p in (bare / "build" / "kernels").glob("*.so"))
    check(cold_p["prewarm"] == "cold" and cold_p["trace_count"] == 1
          and cold_p["prewarm_launches"] == 0,
          f"fresh cold process: {cold_p}")
    check(warm_p["prewarm"] == "warm" and warm_p["cold"] == 0
          and warm_p["trace_count"] == 0 and warm_p["nvcc"] == 0
          and warm_p["residency_queries"] == 0
          and warm_p["prewarm_launches"] == 0
          and warm_p["digest"] == cold_p["digest"]
          == answer_digest(firsts[CACHE_CHILD_TAGGER]),
          f"fresh warm process: {warm_p} (cold: {cold_p})")
    check(bare_p["prewarm"] == "warm" and bare_p["cold"] == 0
          and bare_p["trace_count"] == 0 and bare_p["nvcc"] == 0
          and bare_p["residency_queries"] == 0
          and bare_p["digest"] == cold_p["digest"] and copied,
          f"warm process in a checkout without build/kernels: {bare_p}, "
          f"libraries {copied}")
    print(f"robustness compile cache, fresh processes, "
          f"{CACHE_CHILD_TAGGER}: first request (engine construction to "
          f"the flush of {BATCH} answered) cold "
          f"{cold_p['first_request_s'] * 1e3:.1f} ms ({cold_p['nvcc']} "
          f"nvcc, {cold_p['residency_queries']} residency queries), warm "
          f"{warm_p['first_request_s'] * 1e3:.1f} ms (0 nvcc, 0 residency "
          f"queries, 0 builds, 0 launches in prewarm); warm in a checkout "
          f"with no build/kernels {bare_p['first_request_s'] * 1e3:.1f} ms "
          f"(0 nvcc: {copied} loaded from the entry's copies); answers bit "
          f"for bit equal")

    n = corrupt_cache_entries(shared)
    tag = TAGGERS[0]
    cfg, _, eng = tagger_engine(tag, device, cache_dir=shared)
    key = schedule_key(eng.resolved_schedule)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = serve_flush(eng, tagger_events(cfg, BATCH, 300))
    unusable = [w for w in caught if "unusable" in str(w.message)]
    row = eng.serve_report()[key]["compile"]
    check(n >= len(TAGGERS) and len(unusable) == 1
          and "quarantined" in str(unusable[0].message)
          and row["errors"] == 1 and row["cold"] == 1 and eng.trace_count(key) == 1
          and np.array_equal(got.view(np.int32), firsts[tag].view(np.int32)),
          f"corrupted cache: {n} entries, {len(unusable)} warnings, "
          f"compile row {row}")
    print(f"robustness compile cache: {n} entries corrupted; {tag} served "
          f"with {len(unusable)} warning, 1 quarantined entry, 1 cold build, "
          f"answers bit for bit the first engine's")
    return {"cold_process": cold_p, "warm_process": warm_p,
            "warm_bare_checkout": bare_p, "corrupted": n}


def check_router(device) -> dict:
    """``ROUTER_REPLICAS`` replicas of one tagger on the card with a crash,
    a straggler and a flapping replica armed: every request reaches
    exactly one terminal state, the accounting is exact, and every
    answer is bit for bit a single engine's ``predict_one``."""
    from repro_torch.serving import (ReplicaPool, Router, RouterPolicy,
                                     crash_replica, flapping,
                                     format_router_report, slow_replica)

    cfg, params, oracle = tagger_engine(ROUTER_TAGGER, device)
    pool = ReplicaPool.build(cfg, params, ROUTER_REPLICAS, device=device)
    router = Router(pool, policy=RouterPolicy(
        timeout_s=0.01, hedge_after_s=1e-3, max_retries=2,
        consecutive_failures=2, probe_successes=2))
    crash_replica(pool.get("r0"), after=2, times=3)
    slow_replica(pool.get("r1"), 0.05, after=1, times=2)
    flapping(pool.get("r2"), period=2, times=3)
    x = tagger_events(cfg, ROUTER_REQUESTS, 400)
    reqs = [router.submit(x[i], now=i * 1e-3, defer=i % 3 == 2)
            for i in range(ROUTER_REQUESTS)]
    router.probe(now=0.5)
    router.flush(now=1.0)
    acc = router.verify_router_accounting()
    statuses = [q.status for q in reqs]
    check(all(s in ("answered", "failed", "shed") for s in statuses)
          and sum(a["in_flight"] for a in acc.values()) == 0
          and sum(a["submitted"] for a in acc.values()) == ROUTER_REQUESTS,
          f"router: statuses {statuses}, accounting {acc}")
    fired = sum(len(rep.faults.fired) for rep in pool)
    check(fired > 0, "router: no armed fault fired")
    for i, q in enumerate(reqs):
        if q.status == "answered":
            check(sum(a.outcome == "ok" for a in q.attempts) == 1
                  and np.array_equal(np.asarray(q.result).view(np.int32),
                                     oracle.predict_one(x[i]).view(
                                         np.int32)),
                  f"router: request {q.req_id} differs from predict_one")
    n = {s: statuses.count(s) for s in ("answered", "failed", "shed")}
    c = next(iter(router.counts.values()))
    print(f"robustness router {ROUTER_TAGGER}: {ROUTER_REPLICAS} replicas "
          f"on one card, crash / straggler / flapping armed ({fired} "
          f"faults fired); {ROUTER_REQUESTS} requests: {n}, retries "
          f"{c.retries}, timeouts {c.timeouts}, hedges {c.hedges} (wins "
          f"{c.hedge_wins}), events {router.events}; accounting exact, "
          f"every answer bit for bit predict_one")
    print(format_router_report(router))
    return {"statuses": n, "faults_fired": fired, "events": router.events}


def check_streaming(device) -> dict:
    """A ``StreamingPipeline`` over one tagger on the card with a 3-rung
    ladder (``autotune.degradation_ladder``): a 2x burst in
    ``VirtualClock`` time drives it down the ladder, a 0.5x tail back to
    rung 0; exactly one terminal state per event, exact ``KeyCounts``,
    and the rung-0 answers bit for bit direct ``predict``."""
    import warnings

    from repro_torch import autotune
    from repro_torch.serving import StreamingPipeline, VirtualClock

    cfg, _, eng = tagger_engine(STREAM_TAGGER, device, max_batch=8)
    spec = autotune.SpaceSpec(backends=("pallas_interpret",),
                              block_batches=(8,))
    base = autotune.select(cfg, autotune.DesignTarget(
        max_dsp=400, objective="latency"), spec)
    ladder = autotune.degradation_ladder(cfg, base, spec=spec, max_rungs=3)
    clk = VirtualClock()
    pipe = StreamingPipeline(eng, ladder, deadline_us=50.0, clock=clk,
                             prewarm=True)
    rate = pipe._rung_rate(0)
    reqs, rungs_seen = [], set()
    x = tagger_events(cfg, sum(STREAM_EVENTS), 500)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = 0
        for n, mult in zip(STREAM_EVENTS, (2.0, 0.5)):
            for _ in range(n):
                t = clk.advance(1.0 / (mult * rate)) if j else clk.t
                reqs.append(pipe.push(x[j], now=t))
                pipe.pump(now=t)
                rungs_seen.add(pipe.rung)
                j += 1
        pipe.drain()
    acc = pipe.verify_accounting()
    check(pipe.downgrades >= 1 and pipe.recoveries >= 1 and pipe.rung == 0
          and max(rungs_seen) >= 1,
          f"streaming: downgrades {pipe.downgrades}, recoveries "
          f"{pipe.recoveries}, rung {pipe.rung}")
    check(pipe.in_flight() == 0 and all(
        q.status in ("answered", "shed", "failed") for q in reqs),
          "streaming: a request has no terminal state")
    for key, c in acc.items():
        for s in ("answered", "shed", "failed"):
            check(c[s] == sum(1 for q in reqs if q.key == key
                              and q.status == s),
                  f"streaming: {key} {s} count {c[s]} disagrees")
    rung0 = [(i, q) for i, q in enumerate(reqs)
             if q.status == "answered" and q.rung == 0]
    idx = [i for i, _ in rung0]
    want = eng.predict(x[idx], schedule=ladder[0].schedule, fp=ladder[0].fp)
    got = np.stack([q.result for _, q in rung0])
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          "streaming: rung-0 answers differ from direct predict")
    tot = {s: sum(c[s] for c in acc.values())
           for s in ("answered", "shed", "failed")}
    print(f"robustness streaming {STREAM_TAGGER}: ladder "
          f"{[p.key for p in ladder]}; {len(reqs)} events (2x then 0.5x): "
          f"{tot}, downgrades {pipe.downgrades}, recoveries "
          f"{pipe.recoveries}; {len(rung0)} rung-0 answers bit for bit "
          f"direct predict; accounting exact")
    return {"events": len(reqs), **tot, "downgrades": pipe.downgrades,
            "recoveries": pipe.recoveries}


def check_card_legal(device) -> dict:
    """``autotune.space._card_legal`` (a model of the card's residency)
    and the launcher's ``card_layout`` (the card's answer) agree on every
    static and pipeline point of the six taggers' space, kept or pruned,
    and on the wide-input point the space prunes."""
    from repro_torch.autotune import space
    from repro_torch.config import ModelConfig, RNNConfig
    from repro_torch.configs import get_config
    from repro_torch.core.hls import gate_count
    from repro_torch.kernels import scan_layout as sl

    H, fin = WIDE_INPUT
    cfgs = [get_config(t) for t in TAGGERS] + [ModelConfig(
        name="wide-input", rnn=RNNConfig(cell="lstm", hidden=H,
                                         input_size=fin))]
    kept = pruned = 0
    for cfg in cfgs:
        rnn = cfg.rnn
        gate_dim = gate_count(rnn.cell) * rnn.hidden
        for s in space._raw_points(gate_dim, space.SpaceSpec()):
            if (s.mode == "nonstatic"
                    or sl.scan_route(rnn.hidden) != "cluster"):
                continue
            hoisted = s.hoist_input or s.mode == "pipeline"
            reuse = 1 if s.mode == "pipeline" else s.effective_reuse(
                gate_dim)
            try:
                sl.card_layout(s.block_batch, rnn.hidden,
                               0 if hoisted else rnn.input_size, rnn.cell,
                               reuse, False, device.index, hoisted)
                card = True
            except ValueError:
                card = False
            model = space._card_legal(s, cfg)
            check(card == model, f"{cfg.name} {s.key()}: the space says "
                  f"{model}, the card's launcher {card}")
            kept += card
            pruned += not card
    print(f"card_legal: {kept} kept and {pruned} pruned static / pipeline "
          f"points of the six taggers and the wide-input LSTM (H={H}, "
          f"in={fin}): card_layout on the card agrees with the space on "
          f"every one")
    return {"kept": kept, "pruned": pruned}


def phase_robustness(device) -> tuple:
    """Phase 3 ``robustness``: batch invariance, the compile cache, the
    router and the streaming pipeline, driven with the counts set to 0.
    Returns (launches, report)."""
    def run():
        t0 = time.perf_counter()
        rep = {"batch_invariance": batch_invariance(device, strict=True)}
        rep["batch_invariance_s"] = time.perf_counter() - t0
        rep["compile_cache"] = check_compile_cache(device)
        rep["router"] = check_router(device)
        rep["streaming"] = check_streaming(device)
        rep["seconds"] = time.perf_counter() - t0
        return rep

    launches, rep = drive("robustness", run, ("lstm_scan", "gru_scan",
                                              "lstm_scan_hoisted",
                                              "gru_scan_hoisted",
                                              "lstm_scan_pipeline",
                                              "gru_scan_pipeline",
                                              "col_matmul", "quant_matmul"))
    print(f"robustness: {rep['seconds']:.1f} s (batch invariance "
          f"{rep['batch_invariance_s']:.1f} s)")
    return launches, rep


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


#: design targets of phase 3's ``autotune`` path (tests/test_autotune.py's
#: three, which pick static R = 1, static at a higher R, and a pipeline or
#: non-static point), each with ``fp`` None, ap_fixed<16,6> (emulated)
#: and ap_fixed<8,3> (native int8), and one no tagger can meet
AUTOTUNE_TARGETS = (("latency", {"objective": "latency"}),
                    ("dsp600", {"max_dsp": 600}),
                    ("throughput", {"min_throughput_eps": 1e7,
                                    "objective": "throughput"}))
AUTOTUNE_INFEASIBLE = ("latency<0.05us", {"max_latency_us": 0.05})
AUTOTUNE_FPS = (None, FP_EMULATED, FP_NATIVE["int8"])
AUTOTUNE_TOP_K = 3               # candidates measure_points times
AUTOTUNE_REQUESTS = 16           # submit(target=...) requests a flush
AUTOTUNE_ONE_CALLS = 4           # predict_one(target=...) calls
FPGA_CLOCK_MHZ = 200.0           # the FPGA model's clock (paper Sec. 5)
#: (H, in) of an LSTM whose input width leaves the cluster kernel no
#: layout: the space prunes its static in-loop points
WIDE_INPUT = (16, 1024)


def scan_kernels_of(cell: str, schedule) -> set:
    """The kernels a float scan of a tagger (H <= 128) under ``schedule``
    launches on the card."""
    if schedule.mode == "nonstatic":
        return {"col_matmul"}
    if schedule.mode == "pipeline":
        return {f"{cell}_scan_pipeline"}
    return {f"{cell}_scan_hoisted" if schedule.hoist_input
            else f"{cell}_scan"}


def check_pruned_point_refused(device) -> None:
    """The point ``autotune.space`` prunes for an input width the cluster
    kernel cannot lay out is one the card's launcher refuses (no launch),
    and the hoisted point it keeps runs."""
    import torch

    from repro_torch import autotune
    from repro_torch.config import ModelConfig, RNNConfig
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule

    H, fin = WIDE_INPUT
    cfg = ModelConfig(name="wide-input",
                      rnn=RNNConfig(cell="lstm", hidden=H, input_size=fin))
    static = KernelSchedule(block_batch=8, backend="pallas_interpret")
    hoist = static.replace(hoist_input=True)
    space = [s.key() for s in autotune.enumerate_space(
        cfg, autotune.SpaceSpec(reuse_factors=(1,)))]
    check(static.key() not in space and hoist.key() in space,
          f"wide-input space {space}")
    gen = torch.Generator().manual_seed(11)
    xs, W, U, b = (torch.randn(*shape, generator=gen).to(device) * 0.1
                   for shape in ((8, 4, fin), (fin, 4 * H), (H, 4 * H),
                                 (4 * H,)))
    before = dict(cuda.LAUNCHES)
    try:
        ops.lstm_scan(xs, W, U, b, schedule=static)
    except ValueError as err:
        check("no cluster layout fits" in str(err), f"refusal: {err}")
        print(f"autotune: pruned point {static.key()} at H={H} in={fin} "
              f"refused on the card: {err}")
    else:
        check(False, f"{static.key()} at in={fin} launched on the card")
    check(cuda.LAUNCHES == before, "the refused scan launched a kernel")
    out = ops.lstm_scan(xs, W, U, b, schedule=hoist)
    want = ops.lstm_scan(xs, W, U, b, schedule=hoist.replace(backend="xla"))
    err, scale = max_err(out, want)
    check(err <= TOL["float32"] * scale, f"wide-input hoisted: err {err}")


def autotune_one(tag, eng, ref, x, what, target, measured) -> dict:
    """One (tagger, target, fp) of the ``autotune`` path:
    ``auto_schedule(target, measure_top_k=3)``, then requests that carry
    the target; see :func:`phase_autotune`."""
    from repro_torch import autotune

    spec = eng._default_spec(target)
    ex = autotune.explore(eng.cfg, target, spec)
    fp = target.fp
    fp_name = ("float" if fp is None
               else f"ap_fixed<{fp.total_bits},{fp.integer_bits}>")
    head = f"autotune {tag:20s} {what:14s} {fp_name:15s}"
    row = {"tagger": tag, "target": what, "fp": fp_name,
           "describe": target.describe()}
    if not ex.feasible:
        nearest = min(ex.points, key=lambda p: (
            autotune.violation(p, target), p.latency_cycles, p.key))
        try:
            eng.auto_schedule(target, measure_top_k=AUTOTUNE_TOP_K)
        except autotune.InfeasibleTargetError as err:
            check(err.nearest.key == nearest.key,
                  f"{head}: nearest {err.nearest.key}, explore: "
                  f"{nearest.key}")
            lat = err.nearest.latency_us(FPGA_CLOCK_MHZ)
            v = autotune.violation(err.nearest, target)
            print(f"{head}: infeasible, as explore predicts "
                  f"(InfeasibleTargetError): nearest {err.nearest.key}, "
                  f"FPGA model {lat:.3f} us at {FPGA_CLOCK_MHZ:g} MHz, "
                  f"violation {v:.1%}")
            row.update(infeasible=True, nearest=err.nearest.key,
                       fpga_model_latency_us=lat, violation=v)
            return row
        check(False, f"{head}: explore finds no feasible point, but "
              f"auto_schedule did not raise")
    top = ex.feasible[:AUTOTUNE_TOP_K]
    n = len(measured)
    pt = eng.auto_schedule(target, measure_top_k=AUTOTUNE_TOP_K)
    check(len(measured) == n + 1, f"{head}: measure_points ran "
          f"{len(measured) - n} times")
    walls, grew = measured[-1]
    check(autotune.is_feasible(pt, target)
          and pt.key in [p.key for p in top],
          f"{head}: selected {pt.key}, top {[p.key for p in top]}")
    check(sorted(walls) == sorted(p.key for p in top),
          f"{head}: measured {sorted(walls)}")
    cell = eng.cfg.rnn.cell
    want = set().union(*(scan_kernels_of(cell, p.schedule) for p in top))
    check(want <= {k for k, v in grew.items() if v > 0},
          f"{head}: measure_points launched {grew}, expected {want}")
    order = sorted(top, key=lambda p: (walls[p.key], p.dsp, p.key))
    # a request's target resolves over the engine's spec, unmeasured
    spt = eng.schedule_for_target(target)
    reqs = [eng.submit(x[j], target=target) for j in range(len(x))]
    eng.flush(force=True)
    for q in reqs:
        check(q.status == "answered",
              f"{head}: request {q.req_id} {q.status}: {q.error!r}")
    check({q.key for q in reqs} == {spt.key}
          and eng.trace_count(spt.key) == 1,
          f"{head}: keys {sorted({q.key for q in reqs})}, "
          f"{eng.trace_count(spt.key)} executors")
    got = np.stack([q.result for q in reqs])
    # one event's answer has the same bits in every batch shape: the flush
    # (padded to max_batch), predict of the unpadded rows, predict_one and
    # predict of one row
    unpadded = eng.predict(x, schedule=spt.schedule, fp=spt.fp)
    check(np.array_equal(got.view(np.int32), unpadded.view(np.int32)),
          f"{head}: flush vs predict under {spt.key}")
    ones = np.stack([eng.predict_one(x[j], target=target)
                     for j in range(AUTOTUNE_ONE_CALLS)])
    one_direct = np.stack([eng.predict(x[j:j + 1], schedule=spt.schedule,
                                       fp=spt.fp)[0]
                           for j in range(AUTOTUNE_ONE_CALLS)])
    check(np.array_equal(ones.view(np.int32), one_direct.view(np.int32))
          and np.array_equal(ones.view(np.int32),
                             unpadded[:AUTOTUNE_ONE_CALLS].view(np.int32)),
          f"{head}: predict_one vs predict under {spt.key}")
    # the selected point is the engine's default: requests without a
    # schedule run it (a request's target resolves unmeasured, above, and
    # may land on another point)
    dreqs = [eng.submit(x[j]) for j in range(len(x))]
    eng.flush(force=True)
    check({q.key for q in dreqs} == {pt.key}
          and all(q.status == "answered" for q in dreqs)
          and eng.trace_count(pt.key) == 1,
          f"{head}: default queue keys {sorted({q.key for q in dreqs})}")
    dgot = np.stack([q.result for q in dreqs])
    ddirect = eng.predict(x, schedule=pt.schedule, fp=pt.fp)
    check(np.array_equal(dgot.view(np.int32), ddirect.view(np.int32)),
          f"{head}: default flush vs predict under {pt.key}")
    want_out = ref.predict(x)
    for what_out, g in (("flush", got), ("predict", unpadded),
                        ("default flush", dgot)):
        check_served(tag, f"autotune {what} {fp_name} {what_out}", g,
                     want_out)
    rep = eng.serve_report(FPGA_CLOCK_MHZ)[spt.key]
    check(rep["analytical"] == spt.estimate.report_row(FPGA_CLOCK_MHZ),
          f"{head}: analytical row")
    row.update(
        key=pt.key, served_key=spt.key,
        fpga_model_latency_us=pt.latency_us(FPGA_CLOCK_MHZ),
        fpga_model_ii_cycles=pt.ii_cycles, dsp=pt.dsp,
        analytic_top=[p.key for p in top],
        measure_points_ms={k: walls[k] * 1e3 for k in walls},
        measured_order=[p.key for p in order],
        pick_agrees=pt.key == top[0].key,
        ranking_agrees=[p.key for p in order] == [p.key for p in top],
        measure_launches=grew,
        flush_p50_ms=rep["measured"]["latency_p50_s"] * 1e3,
        predict_one_p50_ms=rep["fast_path"]["latency_p50_s"] * 1e3)
    ms = ", ".join(f"{k} {v:.3f}" for k, v in
                   row["measure_points_ms"].items())
    print(f"{head}: selected {pt.key} (analytic #"
          f"{[p.key for p in top].index(pt.key) + 1} of {len(top)}; "
          f"measured ranking {'agrees' if row['ranking_agrees'] else 'differs'}"
          f"); FPGA model {row['fpga_model_latency_us']:.3f} us at "
          f"{FPGA_CLOCK_MHZ:g} MHz, II {pt.ii_cycles}, DSP {pt.dsp}; "
          f"measure_points on the card (ms, batch 32): {ms}; target "
          f"requests on {spt.key}: flush p50 {row['flush_p50_ms']:.3f} ms, "
          f"predict_one p50 {row['predict_one_p50_ms']:.3f} ms; flush, "
          f"predict_one and predict of one row bit for bit predict of the "
          f"batch; default queue on {pt.key} likewise")
    return row


def phase_autotune(device) -> tuple:
    """Phase 3's ``autotune`` path: each tagger at its published widths
    through ``RNNServingEngine(cfg, params, device="cuda", max_batch=256)``
    under every ``AUTOTUNE_TARGETS`` target and ``AUTOTUNE_FPS`` config:
    ``auto_schedule(target, measure_top_k=3)`` (``measure_points`` times
    the explorer's top three on the card: the scan kernels of each must
    launch), the selected point feasible and among them; 16 requests by
    ``submit(target=...)`` + ``flush`` on one key and one executor, and
    ``predict_one(target=...)``, bit for bit equal to ``predict`` under
    that schedule and within 3e-5 of ``backend="xla"``.  The infeasible
    target raises ``InfeasibleTargetError`` naming the nearest point
    ``explore`` predicts.  Returns (launches, one row per case)."""
    import torch

    from repro_torch.autotune import DesignTarget, explorer
    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import ptq_quantize_model
    from repro_torch.kernels import cuda
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    check_pruned_point_refused(device)
    check_card_legal(device)
    measured = []                   # (walls, launches grown) per call
    real = explorer.measure_points

    def measure(*args, **kw):
        before = dict(cuda.LAUNCHES)
        walls = real(*args, **kw)
        measured.append((walls, {k: n - before.get(k, 0)
                                 for k, n in cuda.LAUNCHES.items()
                                 if n > before.get(k, 0)}))
        return walls

    def run():
        rows = []
        for i, tag in enumerate(TAGGERS):
            cfg = get_config(tag)
            rnn = cfg.rnn
            params = init_params(param_specs(cfg),
                                 torch.Generator().manual_seed(i), "cpu")
            x = np.random.RandomState(100 + i).randn(
                AUTOTUNE_REQUESTS, rnn.seq_len,
                rnn.input_size).astype(np.float32)
            for spec in AUTOTUNE_FPS:
                fp = None if spec is None else fixed_point_config(spec)
                # a fixed-point design serves its PTQ'd weights
                w = params if fp is None else ptq_quantize_model(params, fp)
                eng = RNNServingEngine(cfg, w, device=device,
                                       max_batch=BATCH)
                ref = RNNServingEngine(cfg, w, impl="xla", fp=fp,
                                       device=device)
                for what, kw in AUTOTUNE_TARGETS + (AUTOTUNE_INFEASIBLE,):
                    rows.append(autotune_one(
                        tag, eng, ref, x, what, DesignTarget(fp=fp, **kw),
                        measured))
        return rows

    explorer.measure_points = measure
    try:
        launches, rows = drive("autotune", run, ())
    finally:
        explorer.measure_points = real
    return launches, rows


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
    from repro_torch.kernels import cuda
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
    # the R = 1 key's decode step readied before its first tick, launching
    # nothing
    before = dict(cuda.LAUNCHES)
    t0 = time.perf_counter()
    pre = eng.prewarm(schedules=[scheds["R1"]])
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    r1_key = scheds["R1"].key()
    check(pre[r1_key]["status"] == "cold" and cuda.LAUNCHES == before
          and eng.trace_count(r1_key) == 1,
          f"{LM}: prewarm {pre}, launches {cuda.LAUNCHES} (before "
          f"{before})")
    print(f"{LM}: prewarm of {r1_key} before the first tick: "
          f"{pre[r1_key]['status']}, {prewarm_s * 1e3:.1f} ms, no launch")

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
    report["forward"] = forward_report(LM, cfg, params, device)
    del eng, params, decs
    torch.cuda.empty_cache()
    return launches, report


#: phase 3 ``speculative``: label -> (reuse factor of the key's schedule or
#: None for the default key's einsum path, SpecConfig keywords or None for
#: sequential decode; ``draft`` as a reuse factor)
SPEC_KEYS = {"R1": (1, None),
             "default": (None, None),
             "R1 + ngram k4": (1, {"k": 4}),
             "R1 + ngram k4 trim": (1, {"k": 4, "trim": True}),
             "R1 + draft R4 k2": (1, {"k": 2, "draft": 4}),
             "default + ngram k3": (None, {"k": 3})}
#: the verify pass's chunk checked against the sequential chain
SPEC_CHUNK = 5
#: decode_matmul's rows checked independent of M (the verify pass runs M =
#: LM_BATCH * (k+1) = 20 at k = 4)
SPEC_ROWS = (4, 8, 12, 20)
#: the dense LMs at their published widths, cut in depth to fit one card
#: (bf16 params): deepseek-coder-33b 4 of 62 layers (~4.2 GB of layers,
#: 0.9 GB of embeddings), nemotron-4-340b 1 of 96 (~6.9 GB, 18.9 GB of
#: untied embed and unembed)
DENSE_LMS = {"deepseek-coder-33b": 4, "nemotron-4-340b": 1}
#: the speculative loop over the native ap_fixed<8,3> rnn_decode_step
#: oracle: draft lengths, prompt, new tokens
ORACLE_KS = (2, 4)
ORACLE_PROMPT = (3, 1, 3, 1)
ORACLE_NEW = 8


def spec_schedule(reuse):
    from repro_torch.kernels.schedule import KernelSchedule

    return None if reuse is None else KernelSchedule(reuse_factor=reuse)


def spec_config(kw):
    from repro_torch.serving import SpecConfig

    if kw is None:
        return None
    kw = dict(kw)
    draft = kw.pop("draft", None)
    return SpecConfig(**kw, draft=spec_schedule(draft))


def check_verify_chain(cfg, params, packed, device) -> dict:
    """One ``decode_steps`` chunk of ``SPEC_CHUNK`` tokens a row against as
    many sequential ``decode_step`` calls on a fresh cache, at R = 1 and R =
    4: the same bits in the logits and both caches.  Then ``kv_trim``: the
    chunk written past a 3-token prefix, trimmed back, gives the prefix's
    cache bit for bit, and the next step from it the same logits."""
    import torch

    from repro_torch.models.decode import (decode_step, decode_steps,
                                           init_cache, kv_trim)

    B, S = LM_BATCH, SPEC_CHUNK
    gen = torch.Generator(device=device).manual_seed(41)
    toks = torch.randint(2, cfg.vocab_size, (B, S + 3), generator=gen,
                         device=device)
    pos0 = torch.tensor([0, 3, 9, 17][:B], device=device)
    out = {}
    with torch.inference_mode():
        for r in (1, 4):
            s = spec_schedule(r)
            cache = init_cache(cfg, B, LM_SEQ, "float32", device)
            seq = []
            for i in range(S):
                li, cache = decode_step(cfg, params, cache,
                                        toks[:, i:i + 1], pos0 + i,
                                        schedule=s, packed=packed)
                seq.append(li)
            want = torch.cat(seq, 1)
            got, gcache = decode_steps(
                cfg, params, init_cache(cfg, B, LM_SEQ, "float32", device),
                toks[:, :S], pos0, schedule=s, packed=packed)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{cfg.name}: decode_steps logits not finite (R={r})")
            check(same_bits(got, want) and all(
                same_bits(gcache[k], cache[k]) for k in cache),
                f"{cfg.name}: decode_steps over {S} tokens differs from "
                f"{S} decode_steps (R={r}): logits "
                f"{float((got.float() - want.float()).abs().max())}")
            out[f"R{r}"] = True
        s = spec_schedule(1)
        clean = init_cache(cfg, B, LM_SEQ, "float32", device)
        for i in range(3):
            _, clean = decode_step(cfg, params, clean, toks[:, i:i + 1],
                                   pos0 + i, schedule=s, packed=packed)
        _, dirty = decode_steps(cfg, params, dict(clean), toks[:, 3:3 + S],
                                pos0 + 3, schedule=s, packed=packed)
        trimmed = kv_trim(dirty, pos0 + 3)
        nxt = [decode_step(cfg, params, c, toks[:, 3:4], pos0 + 3,
                           schedule=s, packed=packed)[0]
               for c in (trimmed, clean)]
        torch.cuda.synchronize()
    check(not same_bits(dirty["cache/k"], clean["cache/k"]),
          f"{cfg.name}: the wrong-branch chunk wrote nothing")
    check(all(same_bits(trimmed[k], clean[k]) for k in clean)
          and same_bits(*nxt),
          f"{cfg.name}: kv_trim does not give the clean prefix's cache")
    out["kv_trim"] = True
    print(f"{cfg.name}: decode_steps over {S} tokens == {S} decode_steps "
          f"bit for bit (logits, caches) at R=1 and R=4; kv_trim after "
          f"{S} wrong-branch writes == the clean prefix bit for bit")
    return out


def check_rows_independent_of_m(cfg, device) -> dict:
    """``decode_matmul(x)[rows] == decode_matmul(x[rows])`` at every M of
    ``SPEC_ROWS``, at the model's four products (bf16, R = 1 and 4): the
    verify pass's rows have the sequential step's bits.  Outside the
    counts."""
    import torch

    from repro_torch.kernels.decode_step import (decode_layout,
                                                 decode_matmul_kernel)

    gen = torch.Generator(device=device).manual_seed(43)
    M = max(SPEC_ROWS)
    layouts = {}
    for prod, (K, N) in lm_products(cfg).items():
        x = torch.randn(M, K, generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn(K, N, generator=gen, device=device)
             / np.sqrt(K)).to(torch.bfloat16)
        for r in REUSES:
            full = decode_matmul_kernel(x, w, reuse=r)
            for m in SPEC_ROWS:
                picks = torch.randperm(M, generator=gen, device=device)
                for rows in (torch.arange(m, device=device),
                             torch.arange(M - m, M, device=device),
                             picks[:m].sort().values):
                    got = decode_matmul_kernel(x[rows], w, reuse=r)
                    check(same_bits(got, full[rows]),
                          f"{cfg.name} {prod} R={r}: decode_matmul rows "
                          f"{rows.tolist()} differ between M={m} and "
                          f"M={M}")
        layouts[prod] = {m: decode_layout(m, K, N, 1, True)._asdict()
                         for m in SPEC_ROWS}
    torch.cuda.synchronize()
    print(f"{cfg.name}: decode_matmul rows bit for bit independent of M in "
          f"{SPEC_ROWS} at the four products, R in {REUSES}")
    return layouts


def time_verify(cfg, params, packed, device) -> dict:
    """The verify pass beside the sequential step at B = ``LM_BATCH``
    (CUDA events, R = 1), each with a device trace; and ``decode_matmul``
    at the verify pass's M = ``LM_BATCH * SPEC_CHUNK`` (20) against
    ``torch.matmul`` at the model's four products (events, device time,
    L2-cold events, bound)."""
    import torch

    from repro_torch.kernels.decode_step import (decode_layout,
                                                 decode_matmul_kernel)
    from repro_torch.models.decode import (decode_step, decode_steps,
                                           init_cache)

    B, S = LM_BATCH, SPEC_CHUNK
    s = spec_schedule(1)
    cache = init_cache(cfg, B, LM_SEQ, "float32", device)
    toks = torch.full((B, S), 7, dtype=torch.int64, device=device)
    pos = torch.full((B,), 20, dtype=torch.int64, device=device)
    calls = {"verify": lambda: decode_steps(cfg, params, cache, toks, pos,
                                            schedule=s, packed=packed),
             "step": lambda: decode_step(cfg, params, cache, toks[:, :1],
                                         pos, schedule=s, packed=packed)}
    out = {}
    for what, fn in calls.items():
        ms = time_ms(fn, 10)
        trace = {}
        for _ in range(3):
            trace = device_trace(fn)
            if trace:
                break
        out[what] = {"ms": ms, "trace": trace}
    kernels = cfg.n_layers * sum(decode_layout(B * S, K, N, 1, True).launches
                                 for K, N in lm_products(cfg).values())
    got = out["verify"]["trace"].get("kernels", {}).get(
        "decode_matmul", {}).get("launches")
    check(got == kernels, f"{cfg.name}: a verify pass's trace shows {got} "
          f"decode_matmul kernels, expected {kernels}")
    out["verify"]["decode_matmul_kernels"] = got
    gen = torch.Generator(device=device).manual_seed(44)
    rows = []
    for prod, (K, N) in lm_products(cfg).items():
        x = torch.randn(B * S, K, generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn(K, N, generator=gen, device=device)
             / np.sqrt(K)).to(torch.bfloat16)
        kern = (lambda x=x, w=w: decode_matmul_kernel(x, w, reuse=1))
        lib = (lambda x=x, w=w: torch.matmul(x, w))
        b_ms, b_by, _ = bound((x, w), kern(), 2.0 * B * S * K * N,
                              BF16_PEAK)
        lay = decode_layout(B * S, K, N, 1, True)
        row = {"product": prod, "M": B * S, "K": K, "N": N,
               "ms": time_ms(kern, 50), "library_ms": time_ms(lib, 50),
               "device_ms": per_call(kern, "decode_matmul", 20),
               "library_device_ms": per_call(lib, "other", 20),
               "cold_ms": time_cold_ms(kern, 20),
               "library_cold_ms": time_cold_ms(lib, 20),
               "bound_ms": b_ms, "bound_by": b_by,
               "m_tiles": lay.m_tiles, "layout": lay._asdict()}
        rows.append(row)
        print(f"  decode_matmul {prod:8s} ({B * S},{K})@({K},{N}) bf16: "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}, L2 cold "
              f"{row['cold_ms']:.4f}; {lay.m_tiles} m tiles), torch.matmul "
              f"{row['library_ms']:.4f} ms (device "
              f"{row['library_device_ms']:.4f}, L2 cold "
              f"{row['library_cold_ms']:.4f}), bound {b_ms:.4f} ms ({b_by})")
    out["decode_matmul_m20"] = rows
    print(f"  verify pass (B={B}, S={S}, R=1): {out['verify']['ms']:.3f} ms "
          f"(trace {json.dumps(out['verify']['trace'])}); one sequential "
          f"step: {out['step']['ms']:.3f} ms (trace "
          f"{json.dumps(out['step']['trace'])})")
    return out


def phase_speculative(device) -> tuple:
    """gemma-2b at its published width and depth (seeded weights drawn on
    the card) through ``LMServingEngine(device="cuda")`` on the keys of
    ``SPEC_KEYS``: each speculative key's tokens equal its sequential key's
    bit for bit for every request, exact accounting, one verify executor
    and at most one draft executor, a ``prewarm`` that launches nothing,
    and exactly 4·L ``decode_matmul`` calls a verify round and a draft
    step (the R = 1 sequential key: 4·L a tick).  Then, outside the
    counts, the verify chunk against the sequential chain, ``kv_trim``,
    ``decode_matmul`` rows against M, and the verify pass's time and trace.
    Returns (launches, a report)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models.model import build_model
    from repro_torch.serving import LMServingEngine

    print(f"speculative: {card_line()}")
    cfg = get_config(LM)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    eng = LMServingEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_SEQ,
                          device=device)
    keys = {}
    for label, (r, kw) in SPEC_KEYS.items():
        sched, spec = spec_schedule(r), spec_config(kw)
        keys[label] = eng._key_for(sched, spec)
        if spec is not None:
            before = dict(cuda.LAUNCHES)
            pre = eng.prewarm([sched], spec=spec)[keys[label]]
            check(cuda.LAUNCHES == before and all(
                v["status"] == "cold" for v in pre.values()),
                f"{LM} {label}: prewarm {pre}, launches {cuda.LAUNCHES} "
                f"(before {before})")
            print(f"{LM}: prewarm of {keys[label]}: "
                  f"{ {k: v['status'] for k, v in pre.items()} }, no launch")
    prompts = np.random.RandomState(1).randint(
        2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).tolist()
    ids = {label: [] for label in SPEC_KEYS}

    def serve():
        for label, (r, kw) in SPEC_KEYS.items():
            for p in prompts:
                ids[label].append(eng.add_request(
                    p, max_new=LM_NEW, schedule=spec_schedule(r),
                    spec=spec_config(kw)))
        return eng.run_to_completion()

    t0 = time.perf_counter()
    launches, out = drive("speculative", serve, ("decode_matmul",))
    serve_s = time.perf_counter() - t0
    toks = {label: [out[i] for i in v] for label, v in ids.items()}
    decs = {label: eng._decoders[keys[label]] for label in SPEC_KEYS}
    acc = eng.verify_spec_accounting()
    rep = eng.serve_report()
    per_pass = 4 * cfg.n_layers
    want_calls = 0
    for label, (r, kw) in SPEC_KEYS.items():
        t = toks[label]
        check(len(t) == LM_BATCH and all(
            len(x) == LM_PROMPT + LM_NEW and x[:LM_PROMPT] == p
            for x, p in zip(t, prompts)), f"{LM} {label}: tokens {t}")
        sd = decs[label].spec_dec
        if kw is None:
            check(decs[label].traces == 1, f"{LM} {label}: executors")
            if r:
                want_calls += per_pass * decs[label].ticks
            continue
        seq = "R1" if r else "default"
        check(t == toks[seq], f"{LM} {label}: speculative tokens differ "
              f"from the sequential key's: {t} vs {toks[seq]}")
        a = acc[keys[label]]
        check(a["drafted"] == a["accepted"] + a["rejected"],
              f"{LM} {label}: accounting {a}")
        check(sd.verify_traces == 1 and sd.draft_traces
              == (0 if sd.spec.draft is None else 1),
              f"{LM} {label}: executors {sd.verify_traces} verify, "
              f"{sd.draft_traces} draft")
        if r:
            want_calls += per_pass * (sd.rounds + sd.draft_steps)
        else:
            check(sd.draft_steps == 0, f"{LM} {label}: draft steps")
    check(launches["decode_matmul"] == want_calls,
          f"{LM}: {launches['decode_matmul']} decode_matmul launches on the "
          f"speculative path, expected {want_calls} ({per_pass} a tick, a "
          f"verify round and a draft step)")
    report = {"model": LM, "card": card_line(), "serve_s": serve_s,
              "decode_matmul_calls":
              launches["decode_matmul"], "keys": {}}
    for label in SPEC_KEYS:
        dec, row = decs[label], rep[keys[label]]
        m = row["measured"]
        report["keys"][label] = {
            "key": keys[label], "ticks_or_rounds": dec.ticks,
            "draft_steps": dec.spec_dec.draft_steps if dec.spec_dec else 0,
            "accept_rate": row["accept_rate"], "spec": row["spec"],
            **{k: m[k] for k in ("tokens", "tokens_per_s",
                                 "tick_latency_p50_s", "tick_latency_p99_s")}}
        r = report["keys"][label]
        acc_txt = ("" if row["spec"] is None else
                   f", accept rate {r['accept_rate']}, drafted "
                   f"{row['spec']['drafted']}, accepted "
                   f"{row['spec']['accepted']}")
        print(f"  key {r['key']:48s}: {r['ticks_or_rounds']} "
              f"{'rounds' if row['spec'] else 'ticks'}, p50 "
              f"{r['tick_latency_p50_s'] * 1e3:.3f} ms, p99 "
              f"{r['tick_latency_p99_s'] * 1e3:.3f} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s{acc_txt}")
    print(f"served {LM} on {len(SPEC_KEYS)} keys in {serve_s:.2f} s: every "
          f"speculative key's tokens == its sequential key's bit for bit; "
          f"{launches['decode_matmul']} decode_matmul calls == {per_pass} a "
          f"tick, verify round and draft step")
    packed = eng._packed
    report["verify_chain"] = check_verify_chain(cfg, eng.params, packed,
                                                device)
    report["rows_layouts"] = check_rows_independent_of_m(cfg, device)
    report["timing"] = time_verify(cfg, eng.params, packed, device)
    del eng, params, decs, packed
    torch.cuda.empty_cache()
    return launches, report


def phase_speculative_rnn(device) -> tuple:
    """``speculative_generate`` over a stateless toy LM on the native
    ``ap_fixed<8,3>`` ``rnn_decode_step`` (one-hot embedding, the quantized
    LSTM step over the context on ``quant_matmul``, h onto the vocab; as
    ``repro``'s tests/test_speculative.py builds it) at k in ``ORACLE_KS``,
    driven with the counts set to 0: the tokens equal sequential greedy's
    over the same oracle, and the counters add up.  Returns (launches, a
    report)."""
    import torch

    from repro_torch.config import FixedPointConfig
    from repro_torch.core.quant.fixed_point import quantize_np
    from repro_torch.core.rnn.cells import initial_state
    from repro_torch.kernels.decode_step import rnn_decode_step
    from repro_torch.serving import speculative_generate

    fp = FixedPointConfig(*FP_NATIVE["int8"][:2])
    sched = spec_schedule(2)
    vocab, hidden = 12, 8
    rng = np.random.RandomState(0)
    W = quantize_np(rng.randn(vocab, 4 * hidden).astype(np.float32) * .4, fp)
    U = quantize_np(rng.randn(hidden, 4 * hidden).astype(np.float32) * .4,
                    fp)
    b = np.zeros((4 * hidden,), np.float32)
    E = rng.randn(hidden, vocab).astype(np.float32)
    Wt, Ut, bt, Et = (torch.from_numpy(a).to(device) for a in (W, U, b, E))
    eye = torch.eye(vocab, device=device)

    def step_fn(ctx):
        state = initial_state("lstm", 1, hidden, torch.float32, device)
        with torch.inference_mode():
            for t in ctx:
                h, state = rnn_decode_step("lstm", eye[int(t)][None], state,
                                           Wt, Ut, bt, schedule=sched, fp=fp)
            return (h @ Et)[0]

    def greedy(prompt, n):
        toks = list(prompt)
        for _ in range(n):
            toks.append(int(np.argmax(step_fn(toks).float().cpu().numpy())))
        return toks[len(prompt):]

    want = greedy(ORACLE_PROMPT, ORACLE_NEW)

    def run():
        return {k: speculative_generate(step_fn, ORACLE_PROMPT, ORACLE_NEW,
                                        k=k) for k in ORACLE_KS}

    launches, got = drive("speculative_rnn", run, ("quant_matmul",))
    report = {"sequential": want}
    for k, (toks, stats) in got.items():
        check(toks == want, f"speculative_generate k={k} over the native "
              f"<8,3> oracle: {toks} vs sequential {want}")
        check(stats["drafted"] == stats["accepted"] + stats["rejected"],
              f"speculative_generate k={k}: {stats}")
        report[f"k{k}"] = stats
        print(f"speculative_generate k={k} over the native ap_fixed<8,3> "
              f"rnn_decode_step oracle: tokens == sequential greedy "
              f"{toks}; {stats}")
    report["quant_matmul_launches"] = launches["quant_matmul"]
    return launches, report


def phase_dense_lms(device) -> tuple:
    """deepseek-coder-33b and nemotron-4-340b at their published widths,
    cut in depth (``DENSE_LMS``), seeded weights drawn on the card, each
    through ``LMServingEngine(device="cuda")`` on keys R = 1, R = 4 and the
    default (einsum), driven with the counts set to 0: R = 1 and R = 4
    decode the same tokens with the same first-step logits bit for bit,
    the einsum logits within the bf16 tolerance, 4·L ``decode_matmul``
    calls a scheduled tick exactly, one executor a key.  One model at a
    time, freed before the next.  Returns (launches, a report)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda, ops
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serving import LMServingEngine

    total = {}
    report = {}
    for name, layers in DENSE_LMS.items():
        full = get_config(name)
        cfg = full.replace(n_layers=layers)
        resident = free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        before = torch.cuda.memory_allocated()
        eng = LMServingEngine(cfg, params, max_batch=LM_BATCH,
                              max_seq=LM_SEQ, device=device)
        scheds = {"R1": spec_schedule(1), "R4": spec_schedule(4),
                  "default": None}
        prompts = np.random.RandomState(2).randint(
            2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).tolist()
        ids = {k: [] for k in scheds}

        def serve():
            for k, s in scheds.items():
                for p in prompts:
                    ids[k].append(eng.add_request(p, max_new=LM_NEW,
                                                  schedule=s))
            return eng.run_to_completion()

        t0 = time.perf_counter()
        launches, out = drive(f"dense {name}", serve, ("decode_matmul",))
        serve_s = time.perf_counter() - t0
        add_launches(total, launches)
        toks = {k: [out[i] for i in v] for k, v in ids.items()}
        check(toks["R1"] == toks["R4"], f"{name}: R=1 and R=4 decoded "
              f"different tokens")
        decs = {k: eng._decoder_for(s) for k, s in scheds.items()}
        ticks = decs["R1"].ticks + decs["R4"].ticks
        check(launches["decode_matmul"] == 4 * cfg.n_layers * ticks,
              f"{name}: {launches['decode_matmul']} decode_matmul launches "
              f"for {ticks} scheduled ticks, expected {4 * cfg.n_layers} "
              f"each")
        check(all(eng.trace_count(k) == 1 for k in eng.keys()),
              f"{name}: executors "
              f"{[(k, eng.trace_count(k)) for k in eng.keys()]}")
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
            f"{name}: first-step logits not finite or misshaped")
        check(same_bits(logits["R1"], logits["R4"]),
              f"{name}: R=1 and R=4 first-step logits differ")
        err, scale = max_err(logits["default"], logits["R1"])
        check(err <= TOL["bfloat16"] * scale, f"{name}: einsum logits "
              f"differ from the scheduled path's by {err} (scale {scale})")
        rep = eng.serve_report()
        report[name] = {
            "layers": f"{layers} of {full.n_layers}", "d_model": cfg.d_model,
            "param_gb": gb, "init_s": init_s, "serve_s": serve_s,
            "first_step_logits_max_abs_err": err,
            "resident_before_gb": resident, "init_peak_gb": init_peak,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "default_key_requests_same_tokens": sum(
                a == b for a, b in zip(toks["default"], toks["R1"])),
            "decode_matmul_calls": launches["decode_matmul"],
            "keys": {k: {"key": dec.key, "ticks": dec.ticks,
                         **{m: rep[dec.key]["measured"][m] for m in (
                             "tokens_per_s", "tick_latency_p50_s",
                             "tick_latency_p99_s")}}
                     for k, dec in decs.items()}}
        print(f"served {name} at d_model {cfg.d_model}, {layers} of "
              f"{full.n_layers} layers ({gb:.2f} GB of bf16 params drawn on "
              f"the card in {init_s:.2f} s): R=1 == R=4 tokens and "
              f"first-step logits bit for bit, einsum within {err:.3e} "
              f"(tol {TOL['bfloat16'] * scale:.2e}); "
              f"{launches['decode_matmul']} decode_matmul calls; peak "
              f"allocated {init_peak:.1f} GB after init, "
              f"{report[name]['peak_gb']:.1f} GB while serving "
              f"({resident:.2f} GB allocated before init)")
        for k, row in report[name]["keys"].items():
            print(f"  key {row['key']:32s}: {row['ticks']} ticks, p50 "
                  f"{row['tick_latency_p50_s'] * 1e3:.3f} ms, p99 "
                  f"{row['tick_latency_p99_s'] * 1e3:.3f} ms, "
                  f"{row['tokens_per_s']:.1f} tokens/s")
        report[name]["forward"] = forward_report(name, cfg, params, device)
        # as in phase_families: all allocated since ``before`` goes (the
        # einsum check's ``cache`` too, and ``dec``, the loop's last
        # decoder, whose executor holds the params), ``params`` only after
        # the check
        del eng, decs, logits, cache, dec
        report[name]["left_after_del_gb"] = check_engine_freed(name, before)
        print(f"  {name}: the deleted engine left "
              f"{report[name]['left_after_del_gb']:.3f} GB allocated")
        # the weights too: the residency cache holds its sources weakly,
        # so the model's params go with their last reference (no cycle
        # collection), whatever entries the cache keeps
        del params
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() / 1e9 - resident
        report[name]["left_after_params_del_gb"] = left
        check(left <= ENGINE_LEFT_GB, f"{name}: {left:.2f} GB still "
              f"allocated after the engine and its params were deleted")
        print(f"  {name}: with its params deleted, {left:.3f} GB above the "
              f"{resident:.2f} GB allocated before init "
              f"({len(ops.RESIDENT_WEIGHTS)} residency entries)")
        torch.cuda.empty_cache()
    return total, report


#: phase 3 ``families``: the moe, ssm, hybrid, enc-dec and vlm LMs at their
#: published widths, every one at full depth (bf16 params from
#: ``param_count``: 28.6, 61.1, 1.5, 17.1, 1.5 and 7.6 GB), one at a time
FAMILY_LMS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "mamba2-780m",
              "recurrentgemma-9b", "whisper-medium", "phi-3-vision-4.2b")
#: the keys each family model serves (label -> (reuse factor or None, an
#: n-gram k or None)); the speculative key only where speculation is
#: exact (not ssm / hybrid, whose refusal is checked instead)
FAMILY_KEYS = {"R1": (1, None), "R4": (4, None), "default": (None, None),
               "R1 + ngram k4": (1, 4)}
#: decode steps of the tiny-config conformance check (card vs CPU)
FAMILY_TINY_STEPS = 6


def free_card() -> float:
    """Hand the allocator's cached blocks back to the card and return the
    GB still allocated (a deleted engine's tensors are gone by then: its
    executors hold no reference back to it)."""
    import torch

    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


#: what a deleted engine may leave allocated beside what was there before
#: it was built (GB)
ENGINE_LEFT_GB = 1.0


def check_engine_freed(name: str, before: int) -> float:
    """The GB allocated above ``before`` (``torch.cuda.memory_allocated``
    just before the engine was built), read after the engine and every
    reference to its decoders were deleted, with no cycle collection:
    at most ``ENGINE_LEFT_GB``."""
    import torch

    torch.cuda.synchronize()
    left = (torch.cuda.memory_allocated() - before) / 1e9
    check(left <= ENGINE_LEFT_GB, f"{name}: {left:.2f} GB still allocated "
          f"after the engine was deleted")
    return left


def family_inputs(cfg, batch, max_len, device, seed):
    """A zero decode cache of ``cfg`` on ``device``, with an enc-dec
    model's ``cache/xk`` / ``cache/xv`` filled from ``seed``: both engines
    leave the encoder's keys and values to the caller, as ``repro``'s do,
    so seeded values stand in for them and make the cross-attention read
    something."""
    import torch

    from repro_torch.models.decode import init_cache

    cache = init_cache(cfg, batch, max_len, "float32", device)
    if cfg.enc_dec:
        gen = torch.Generator().manual_seed(seed)
        for k in ("cache/xk", "cache/xv"):
            cache[k] = torch.randn(cache[k].shape, generator=gen).to(device)
    return cache


def check_family_tiny(name, device) -> dict:
    """``name`` at the port's ``testing.tiny_config`` (f32), weights drawn
    on the CPU: ``FAMILY_TINY_STEPS`` chained ``decode_step`` calls on the
    card against the same calls on the CPU, the einsum path (and for a
    decode-schedulable family the R = 1 scheduled path, ``decode_matmul``
    on the card against its plain version), logits and every cache entry
    within the float32 tolerance.  Returns the largest error."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_schedulable, decode_step
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config

    cfg = tiny_config(get_config(name))
    params = build_model(cfg).init(torch.Generator().manual_seed(5), "cpu")
    on_card = {k: v.to(device) for k, v in params.items()}
    B, S = LM_BATCH, 16
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (B, FAMILY_TINY_STEPS)))
    scheds = {"einsum": None}
    if decode_schedulable(cfg):
        scheds["R1"] = spec_schedule(1)
    worst = {}
    with torch.inference_mode():
        for label, sched in scheds.items():
            cc = family_inputs(cfg, B, S, "cpu", 7)
            gc = {k: v.to(device) for k, v in cc.items()}
            err = 0.0
            for t in range(FAMILY_TINY_STEPS):
                pos = torch.full((B,), t, dtype=torch.int64)
                cl, cc = decode_step(cfg, params, cc, toks[:, t:t + 1], pos,
                                     schedule=sched)
                gl, gc = decode_step(cfg, on_card, gc,
                                     toks[:, t:t + 1].to(device),
                                     pos.to(device), schedule=sched)
                for g, c in [(gl, cl)] + [(gc[k], cc[k]) for k in cc]:
                    e, scale = max_err(g.cpu(), c)
                    check(e <= TOL["float32"] * scale,
                          f"{name} tiny {label} step {t}: card vs CPU "
                          f"differ by {e} (scale {scale})")
                    err = max(err, e)
            worst[label] = err
    return worst


def phase_families(device) -> tuple:
    """The moe, ssm, hybrid, enc-dec and vlm families at their published
    widths and full depth (``FAMILY_LMS``), seeded bf16 weights drawn on
    the card, one model at a time, freed before the next, each served
    through ``LMServingEngine(device="cuda")``: ``LM_BATCH`` requests of
    ``LM_PROMPT`` + ``LM_NEW`` tokens on keys R = 1, R = 4, the default
    (einsum) and, where speculation is exact (moe, enc-dec, vlm), R = 1 +
    an n-gram ``SpecConfig(k=4)``, driven with the counts set to 0.
    Checks: vlm (phi-3-vision) R = 1 == R = 4 tokens and first-step
    logits bit for bit, einsum within the bf16 tolerance, exactly 4·L
    ``decode_matmul`` calls a scheduled tick and verify round; moe, ssm,
    hybrid and enc-dec R = 1, R = 4 and the default give the same tokens
    and first-step logits bit for bit (one code path: the check is of
    determinism, the MoE combine's included) and launch no kernel of the
    port; every speculative key's tokens equal its sequential key's; ssm
    and hybrid refuse ``spec=`` (engine, request, ``SpeculativeDecoder``);
    one executor a key; logits finite and of the padded vocab; each
    family's tiny config on the card within 3e-5 of the CPU.  Prints per
    model the params' GB, the peak allocation after init and while
    serving, tick p50 / p99 and tokens/s per key, and one tick's device
    busy time and idle share from a trace.  Returns (launches, a
    report)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_schedulable, decode_step
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serving import LMServingEngine, SpecConfig
    from repro_torch.serving.speculative import SpeculativeDecoder

    total: dict = {}
    report: dict = {}
    for name in FAMILY_LMS:
        t_model = time.perf_counter()
        cfg = get_config(name)
        vlm = decode_schedulable(cfg)
        exact_spec = cfg.family not in ("ssm", "hybrid")
        resident = free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        eng = LMServingEngine(cfg, params, max_batch=LM_BATCH,
                              max_seq=LM_SEQ, device=device)
        keys = {k: (spec_schedule(r), SpecConfig(k=n) if n else None)
                for k, (r, n) in FAMILY_KEYS.items() if exact_spec or not n}
        if not exact_spec:
            spec = SpecConfig(k=4)
            refused = []
            for what, call in (
                    ("engine", lambda: LMServingEngine(
                        cfg, params, max_batch=LM_BATCH, max_seq=LM_SEQ,
                        device=device, spec=spec)),
                    ("request", lambda: eng.add_request(
                        [1], schedule=spec_schedule(1), spec=spec)),
                    ("decoder", lambda: SpeculativeDecoder(
                        cfg, "k", None, spec, max_batch=LM_BATCH,
                        max_seq=LM_SEQ, cache_dtype="float32",
                        params=params, device=device))):
                try:
                    call()
                except ValueError as e:
                    refused.append(what)
                    msg = str(e)
            check(refused == ["engine", "request", "decoder"],
                  f"{name}: spec= refused by {refused} only")
            print(f"{name}: spec= refused by the engine, a request and "
                  f"SpeculativeDecoder: {msg}")
        prompts = np.random.RandomState(3).randint(
            2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).tolist()
        ids = {k: [] for k in keys}

        def serve():
            for k, (s, spc) in keys.items():
                for p in prompts:
                    ids[k].append(eng.add_request(p, max_new=LM_NEW,
                                                  schedule=s, spec=spc))
            return eng.run_to_completion()

        t0 = time.perf_counter()
        launches, out = drive(f"families {name}", serve,
                              ("decode_matmul",) if vlm else ())
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_peak = torch.cuda.max_memory_allocated() / 1e9
        add_launches(total, launches)
        toks = {k: [out[i] for i in v] for k, v in ids.items()}
        for k, v in toks.items():
            check(len(v) == LM_BATCH and all(
                len(t) == LM_PROMPT + LM_NEW and t[:LM_PROMPT] == p
                and all(0 <= x < padded_vocab(cfg) for x in t)
                for t, p in zip(v, prompts)), f"{name} key {k}: tokens {v}")
        same = ("R1", "R4") if vlm else ("R1", "R4", "default")
        check(all(toks[k] == toks["R1"] for k in same),
              f"{name}: keys {same} decoded different tokens: "
              f"{[toks[k] for k in same]}")
        if "R1 + ngram k4" in toks:
            check(toks["R1 + ngram k4"] == toks["R1"],
                  f"{name}: the speculative key's tokens differ from R1's")
        decs = {k: eng._decoder_for(s, spc) for k, (s, spc) in keys.items()}
        check(len(eng.keys()) == len(keys)
              and all(eng.trace_count(k) == 1 for k in eng.keys()),
              f"{name}: executors "
              f"{[(k, eng.trace_count(k)) for k in eng.keys()]}")
        spec_rep = eng.verify_spec_accounting()
        per_tick = 4 * cfg.n_layers
        if vlm:
            # no local name may keep a decoder (and its packed weights)
            # past ``del eng, decs`` below: check_engine_freed reads them
            calls = (decs["R1"].ticks + decs["R4"].ticks
                     + decs["R1 + ngram k4"].spec_dec.rounds)
            check(launches["decode_matmul"] == per_tick * calls,
                  f"{name}: {launches['decode_matmul']} decode_matmul calls "
                  f"for {calls} scheduled ticks and rounds, expected "
                  f"{per_tick} each")
        else:
            check(sum(launches.values()) == 0,
                  f"{name}: kernels of the port launched: {launches}")

        tok0 = torch.tensor([p[:1] for p in prompts], device=device)
        pos0 = torch.zeros(LM_BATCH, dtype=torch.int64, device=device)
        logits = {}
        with torch.inference_mode():
            for k in ("R1", "R4", "default"):
                cache = family_inputs(cfg, LM_BATCH, LM_SEQ, device, 1)
                logits[k] = decode_step(cfg, eng.params, cache, tok0, pos0,
                                        schedule=decs[k].schedule,
                                        packed=decs[k].packed)[0]
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(v).all()) and v.shape == (
            LM_BATCH, 1, padded_vocab(cfg)) for v in logits.values()),
            f"{name}: first-step logits not finite or misshaped")
        check(same_bits(logits["R1"], logits["R4"]),
              f"{name}: R=1 and R=4 first-step logits differ")
        err, scale = max_err(logits["default"], logits["R1"])
        if vlm:
            check(err <= TOL["bfloat16"] * scale, f"{name}: einsum logits "
                  f"differ from the scheduled path's by {err}")
        else:
            check(same_bits(logits["default"], logits["R1"]),
                  f"{name}: the default key's first-step logits differ from "
                  f"R1's ({err}): the step is not deterministic")

        # one tick in a device trace (the R1 key's step; for vlm also the
        # default key's einsum step)
        traces = {}
        cache = family_inputs(cfg, LM_BATCH, LM_SEQ, device, 1)
        for k in (("R1", "default") if vlm else ("R1",)):
            for _ in range(3):          # a trace now and then comes back empty
                tr = device_trace(lambda k=k: decode_step(
                    cfg, eng.params, cache, tok0, pos0,
                    schedule=decs[k].schedule, packed=decs[k].packed))
                if tr:
                    break
            traces[k] = tr
        rep = eng.serve_report()
        report[name] = {
            "family": cfg.family, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(),
            "resident_before_gb": resident,
            "active_params": cfg.active_param_count(), "param_gb": gb,
            "init_s": init_s, "init_peak_gb": init_peak,
            "serve_peak_gb": serve_peak, "serve_s": serve_s,
            "decode_matmul_calls": launches.get("decode_matmul", 0),
            "first_step_default_vs_r1": err,
            "spec": spec_rep,
            "keys": {k: {"key": dec.key, "ticks": dec.ticks,
                         **{m: rep[dec.key]["measured"][m] for m in (
                             "tokens", "tokens_per_s", "tick_latency_p50_s",
                             "tick_latency_p99_s")}}
                     for k, dec in decs.items()},
            "trace": traces}
        report[name]["forward"] = forward_report(name, cfg, params, device)
        del eng, decs, logits, cache
        report[name]["left_after_del_gb"] = check_engine_freed(name, before)
        params.clear()
        del params
        free_card()
        report[name]["tiny_card_vs_cpu"] = check_family_tiny(name, device)
        report[name]["phase_s"] = time.perf_counter() - t_model
        r = report[name]
        print(f"served {name} ({cfg.family}, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, full depth): {gb:.2f} GB of bf16 params "
              f"drawn on the card in {init_s:.2f} s; peak allocated "
              f"{init_peak:.2f} GB after init, {serve_peak:.2f} GB while "
              f"serving ({resident:.2f} GB allocated before init); "
              f"{len(out)} requests of {LM_PROMPT}+{LM_NEW} tokens on "
              f"{len(keys)} keys in {serve_s:.2f} s; "
              f"{r['decode_matmul_calls']} decode_matmul calls; first-step "
              f"default vs R1 {err:.3e}; the deleted engine left "
              f"{r['left_after_del_gb']:.3f} GB; tiny config card vs CPU "
              f"{r['tiny_card_vs_cpu']}; {r['phase_s']:.1f} s in all")
        for k, row in r["keys"].items():
            print(f"  key {row['key']:40s}: {row['ticks']} ticks, p50 "
                  f"{row['tick_latency_p50_s'] * 1e3:.3f} ms, p99 "
                  f"{row['tick_latency_p99_s'] * 1e3:.3f} ms, "
                  f"{row['tokens_per_s']:.1f} tokens/s")
        for k, tr in traces.items():
            print(f"  trace of one {k} tick: {json.dumps(tr)}")
    return total, report


def only_families(device) -> dict:
    """``--families``: phase 3 ``families`` alone (kernels built on first
    use), for a quick run on the card; its report and launch counts."""
    launches, report = phase_families(device)
    return {"launches": launches, "families": report}


#: phase 3 ``prefill`` and the forward at published width of every LM
PREFILL_BATCH = 2
PREFILL_SEQ = 512                # prompt tokens a row (vlm: after its patches)
PREFILL_FRAMES = 1500            # whisper: encoder frames (30 s of audio)
PREFILL_ENC_DEC_TOKENS = 64      # whisper: decoder tokens
PREFILL_REPEATS = 5              # timed forwards after one warm-up
PREFILL_LMS = ("gemma-2b", "stablelm-3b", "deepseek-coder-33b",
               "nemotron-4-340b", *FAMILY_LMS)
CHAIN_TOL = 5e-4                 # repro's forward == decode bar
CHAIN_TINY_SEQ = 12              # decode steps of each tiny chain
CHAIN_WIDE_SEQ = 32              # gemma-2b f32 at published width
LM_TRAIN = ("gemma-2b", "stablelm-3b", "mamba2-780m")
LM_TRAIN_STEPS = 20
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 256
LM_TRAIN_TIMED = 5               # synchronised steps timed after two
#: the LMs of ``LM_TRAIN`` whose loss does not fall in 20 steps at the
#: trainer's learning rate (``launch.train.train``'s 1e-3, which every LM
#: trains at): stablelm-3b's rises (ROADMAP.md §3, open).  The phase holds
#: their losses finite and their peak, and reports the losses unchecked.
LM_TRAIN_LOSS_OPEN = ("stablelm-3b",)
#: a dense LM's training peak over its state (params, grads, f32 m and v):
#: the in-place AdamW holds the state once (the out-of-place one held
#: gemma-2b at 2.15x)
LM_TRAIN_PEAK_RATIO = 1.7


def prefill_inputs(cfg, batch, seq, device, seed, n_img=None,
                   frames=PREFILL_FRAMES) -> dict:
    """An LM batch on ``device``: ``tokens`` [batch, seq] (an enc-dec
    model: at most ``PREFILL_ENC_DEC_TOKENS``) drawn from ``seed``, with
    the frontend stubs' embeddings the family needs (whisper's ``frames``,
    phi-3-vision's ``n_img`` patches, its config's count by default),
    normal draws in the compute dtype."""
    import torch

    from repro_torch.models.transformer import required_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.enc_dec:
        seq = min(seq, PREFILL_ENC_DEC_TOKENS)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device=device)}
    rows = {"frame_embeds": frames,
            "img_embeds": cfg.n_frontend_tokens if n_img is None else n_img}
    for k in required_inputs(cfg):
        out[k] = torch.randn((batch, rows[k], cfg.d_model), generator=gen,
                             device=device).to(cdt)
    return out


def forward_report(name, cfg, params, device) -> dict:
    """``Model.forward`` of ``cfg`` on ``params`` (already on the card) at
    ``PREFILL_BATCH`` x ``PREFILL_SEQ`` (whisper: frames + decoder tokens,
    phi-3-vision: patches + text): logits finite and of the padded vocab,
    no kernel of the port launched; the host clock around
    ``PREFILL_REPEATS`` synchronised forwards after one warm-up (median
    and range), prompt tokens/s, the peak allocation above what was
    allocated before, and one forward's device kernels and idle share
    from a trace.  Returns the report."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab

    model = build_model(cfg)
    batch = prefill_inputs(cfg, PREFILL_BATCH, PREFILL_SEQ, device, 9)
    positions = batch["tokens"].shape[1] + (
        batch["img_embeds"].shape[1] if "img_embeds" in batch else 0)
    before = dict(cuda.LAUNCHES)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with torch.inference_mode():
        for i in range(PREFILL_REPEATS + 1):
            t0 = time.perf_counter()
            logits = model.forward(params, batch)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(tuple(logits.shape) == (PREFILL_BATCH, positions,
                                  padded_vocab(cfg))
          and bool(torch.isfinite(logits).all()),
          f"{name}: forward logits {tuple(logits.shape)} not finite or "
          f"misshaped")
    del logits
    trace = {}
    for _ in range(3):                  # a trace now and then comes back empty
        trace = device_trace(lambda: model.forward(params, batch))
        if trace:
            break
    check(dict(cuda.LAUNCHES) == before,
          f"{name}: the forward launched kernels of the port: "
          f"{cuda.LAUNCHES} (before {before})")
    kernels = sum(g["launches"] for g in trace.get("kernels", {}).values())
    med = float(np.median(walls))
    rep = {"batch": PREFILL_BATCH, "positions": positions,
           "frames": (batch["frame_embeds"].shape[1]
                      if "frame_embeds" in batch else 0),
           "layers": cfg.n_layers, "ms": med, "ms_min": min(walls),
           "ms_max": max(walls),
           "prompt_tokens_per_s": PREFILL_BATCH * positions / med * 1e3,
           "peak_gb_above_params": peak, "device_kernels": kernels,
           "busy_ms": trace.get("busy_ms"),
           "idle_share": trace.get("idle_share")}
    print(f"forward {name} ({cfg.n_layers} layers, d_model {cfg.d_model}): "
          f"B={PREFILL_BATCH} x {positions} positions"
          f"{' + %d frames' % rep['frames'] if rep['frames'] else ''}: "
          f"{med:.2f} ms median of {PREFILL_REPEATS} [{min(walls):.2f}-"
          f"{max(walls):.2f}] (host clock, synchronised), "
          f"{rep['prompt_tokens_per_s']:.0f} prompt tokens/s, peak "
          f"{peak:.2f} GB above the {base / 1e9:.2f} GB allocated before; one "
          f"forward: {kernels} device kernels, busy "
          f"{trace.get('busy_ms', float('nan')):.2f} of "
          f"{trace.get('span_ms', float('nan')):.2f} ms (idle "
          f"{trace.get('idle_share', float('nan')):.1%}); logits finite, no "
          f"port kernel; {card_line()}")
    rep["top"] = trace.get("top")
    print(f"  longest kernels (name, launches, device ms): "
          f"{json.dumps(rep['top'])}")
    return rep


def decode_chain_gap(cfg, params, batch, device) -> float:
    """The largest gap between ``Model.forward``'s logits and a teacher-
    forced chain of ``decode_step`` calls over the same tokens (the einsum
    path, a float32 cache) at every position, over max |logit|.  An
    enc-dec model's encoder runs once and its cross K / V go into
    ``cache/xk`` / ``cache/xv`` first, as ``repro``'s
    ``tests/test_decode.py`` does; a vlm's batch has no patches (decode
    takes text)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.model import build_model

    toks = batch["tokens"]
    B, S = toks.shape
    with torch.inference_mode():
        full = build_model(cfg).forward(params, batch).float()
        cache = init_cache(cfg, B, S + 4, "float32", device)
        if cfg.enc_dec:
            cdt = getattr(torch, cfg.compute_dtype)
            enc = tf._encode(cfg, params, batch["frame_embeds"].to(cdt))
            st = tf.slice_layer(params, "xdecoder/")
            for n, w in (("cache/xk", "xdecoder/xattn/wk"),
                         ("cache/xv", "xdecoder/xattn/wv")):
                cache[n] = torch.stack([torch.einsum(
                    "bsd,dhk->bshk", enc, st[w][l].to(enc.dtype)).float()
                    for l in range(cfg.n_decoder_layers)])
        gap = 0.0
        for t in range(S):
            logits, cache = decode_step(
                cfg, params, cache, toks[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int64, device=device))
            gap = max(gap, float((logits[:, 0].float()
                                  - full[:, t]).abs().max()))
    return gap / max(1.0, float(full.abs().max()))


def check_prefill_tiny(name, device) -> dict:
    """``name`` at the port's ``testing.tiny_config`` (f32), weights drawn
    on the CPU: ``Model.forward`` logits and ``Model.loss`` with the
    gradient of every parameter on the card within 3e-5 of the CPU, and
    the card's forward == its own decode chain within ``CHAIN_TOL`` (MoE
    at capacity 8.0, as ``repro``'s bar).  Returns the largest errors."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config

    cfg = tiny_config(get_config(name))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, eval_capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    on_card = {k: v.to(device) for k, v in params.items()}
    batch = prefill_inputs(cfg, PREFILL_BATCH, 40, "cpu", 6, frames=44)
    n = batch["img_embeds"].shape[1] if "img_embeds" in batch else 0
    batch["labels"] = torch.from_numpy(np.random.RandomState(7).randint(
        -1, cfg.vocab_size, (PREFILL_BATCH, batch["tokens"].shape[1] + n)))

    def run(p, b):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        loss, metrics = model.loss(leaves, b)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.inference_mode():
            logits = model.forward(p, b)
        return [logits, loss, *metrics.values(), *grads]

    cpu = run(params, batch)
    card = run(on_card, {k: v.to(device) for k, v in batch.items()})
    worst = 0.0
    for g, c in zip(card, cpu):
        e, scale = max_err(g.detach().cpu(), c.detach())
        check(e <= TOL["float32"] * scale, f"{name} tiny: card vs CPU "
              f"differ by {e} (scale {scale})")
        worst = max(worst, e)
    chain = prefill_inputs(cfg, PREFILL_BATCH, CHAIN_TINY_SEQ, device, 8,
                           n_img=0, frames=44)
    gap = decode_chain_gap(cfg, on_card, chain, device)
    check(gap < CHAIN_TOL, f"{name} tiny: forward vs decode chain {gap}")
    return {"card_vs_cpu": worst, "forward_vs_decode": gap}


def train_lm(name, device) -> dict:
    """``launch.train.train(name, steps=LM_TRAIN_STEPS,
    batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, device="cuda")`` at
    published width (its log, a line a step, read for every loss): every
    loss finite and, but for ``LM_TRAIN_LOSS_OPEN``, the last below the
    first and the mean of the last five below the first five's; its
    peak allocation beside its state (params, grads, f32 m and v), for a
    dense LM under ``LM_TRAIN_PEAK_RATIO`` times it; then
    ``LM_TRAIN_TIMED`` synchronised steps of the trainer's step
    (``make_train_step(..., donate=True)``) on the trained parameters
    (host clock, after two warm-up steps) and one step's device kernels
    and idle share from a trace."""
    import contextlib
    import io
    import re

    import torch

    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.launch.train import _lm_batches, train
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.training import adamw_init, make_train_step

    free_card()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        params, _ = train(name, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                          seq_len=LM_TRAIN_SEQ, log_every=1, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in re.findall(r"loss=(\S+)", log.getvalue())]
    falls = (losses[-1] < losses[0]
             and np.mean(losses[-5:]) < np.mean(losses[:5]))
    check(len(losses) == LM_TRAIN_STEPS
          and all(np.isfinite(v) for v in losses)
          and (falls or name in LM_TRAIN_LOSS_OPEN),
          f"train {name}: losses {losses}")
    cfg = get_config(name)
    state_gb = sum(t.numel() * (2 * t.element_size() + 8)
                   for t in params.values()) / 1e9
    if cfg.family == "dense":
        check(peak < LM_TRAIN_PEAK_RATIO * state_gb,
              f"train {name}: peak {peak:.2f} GB for {state_gb:.2f} GB of "
              f"state")

    opt = OptimizerConfig(lr=1e-3, warmup_steps=5,
                          total_steps=LM_TRAIN_STEPS, weight_decay=0.01)
    step = make_train_step(build_model(cfg), TrainConfig(optimizer=opt),
                           grad_accum=1, donate=True)
    st = adamw_init(params, opt)
    batch = next(_lm_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, device))
    walls = []
    for i in range(LM_TRAIN_TIMED + 2):
        t0 = time.perf_counter()
        params, st, _ = step(params, st, batch)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    trace = device_trace(lambda: step(params, st, batch), inference=False)
    kernels = sum(g["launches"] for g in trace.get("kernels", {}).values())
    del params, st
    free_card()
    rep = {"losses": losses, "loss_falls": bool(falls), "train_s": wall, "peak_gb": peak,
           "state_gb": state_gb, "ms_per_step": float(np.median(walls)),
           "ms_min": min(walls), "ms_max": max(walls),
           "device_kernels": kernels,
           "busy_ms": trace.get("busy_ms"),
           "idle_share": trace.get("idle_share")}
    print(f"train {name} at published width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, remat {cfg.remat}): {LM_TRAIN_STEPS} steps of "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in "
          f"{wall:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f} (first "
          f"five {np.mean(losses[:5]):.4f}, last five "
          f"{np.mean(losses[-5:]):.4f}); peak {peak:.2f} GB for "
          f"{state_gb:.2f} GB of state ({peak / state_gb:.2f}x); a step "
          f"{rep['ms_per_step']:.1f} ms median of {LM_TRAIN_TIMED} "
          f"[{min(walls):.1f}-{max(walls):.1f}] (host clock, "
          f"synchronised), {kernels} device kernels, busy "
          f"{trace.get('busy_ms', float('nan')):.1f} of "
          f"{trace.get('span_ms', float('nan')):.1f} ms (idle "
          f"{trace.get('idle_share', float('nan')):.1%}); {card_line()}")
    rep["top"] = trace.get("top")
    print(f"  longest kernels (name, launches, device ms): "
          f"{json.dumps(rep['top'])}")
    return rep


def phase_prefill(device) -> tuple:
    """Phase 3 ``prefill``, driven with the counts set to 0 (no kernel of
    the port is on this path, as none is in ``repro``'s): the ten LMs'
    tiny configs on the card (``check_prefill_tiny``); gemma-2b at its
    published width in float32, forward == a ``CHAIN_WIDE_SEQ``-step
    decode chain within ``CHAIN_TOL`` of max |logit|; and ``train_lm``
    for ``LM_TRAIN``.  Every launch count must stay 0.  (The forward at
    published width of each LM runs in the phase that holds its weights:
    ``forward_report``.)  Returns (launches, a report)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    def run():
        rep = {"tiny": {}}
        for name in PREFILL_LMS:
            rep["tiny"][name] = check_prefill_tiny(name, device)
            print(f"prefill {name} tiny: {json.dumps(rep['tiny'][name])}")
        cfg = get_config(LM).replace(param_dtype="float32",
                                     compute_dtype="float32")
        free_card()
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device)
        batch = prefill_inputs(cfg, PREFILL_BATCH, CHAIN_WIDE_SEQ, device,
                               10)
        gap = decode_chain_gap(cfg, params, batch, device)
        check(gap < CHAIN_TOL, f"{LM} f32: forward vs decode chain {gap}")
        rep["chain_f32"] = {"model": LM, "tokens": CHAIN_WIDE_SEQ,
                            "gap_over_max_logit": gap}
        print(f"prefill {LM} f32 at published width: forward vs its "
              f"{CHAIN_WIDE_SEQ}-step decode chain {gap:.3e} of max |logit| "
              f"(bar {CHAIN_TOL})")
        del params
        # the one LM no other phase draws, at published width (bf16)
        cfg = get_config("stablelm-3b")
        free_card()
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device)
        rep["forward"] = {"stablelm-3b": forward_report(
            "stablelm-3b", cfg, params, device)}
        del params
        rep["train"] = {name: train_lm(name, device) for name in LM_TRAIN}
        return rep

    launches, rep = drive("prefill", run, ())
    check(sum(launches.values()) == 0,
          f"prefill: kernels of the port launched: {launches}")
    return launches, rep


def prefill_widths(device) -> dict:
    """``--prefill``'s forward of every LM at published width but
    stablelm-3b's (``phase_prefill`` runs it), one model at a time
    (deepseek-coder-33b and nemotron-4-340b at ``DENSE_LMS``'s depths),
    each freed before the next: ``forward_report``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    out = {}
    for name in PREFILL_LMS:
        if name == "stablelm-3b":
            continue
        cfg = get_config(name)
        if name in DENSE_LMS:
            cfg = cfg.replace(n_layers=DENSE_LMS[name])
        free_card()
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device)
        out[name] = forward_report(name, cfg, params, device)
        params.clear()
        del params
    free_card()
    return out


def only_prefill(device) -> dict:
    """``--prefill``: phase 3 ``prefill`` alone, then every LM's forward at
    published width; its report and launch counts."""
    launches, report = phase_prefill(device)
    return {"launches": launches, "prefill": report,
            "forward": prefill_widths(device)}


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


TRAIN_TOP = ("top-tagging-gru", "top-tagging-lstm")
TRAIN_OTHERS = ("flavor-tagging-lstm", "flavor-tagging-gru",
                "quickdraw-lstm", "quickdraw-gru")
TRAIN_STEPS = 150                # repro's tests/test_system.py: steps,
TRAIN_BATCH = 128                # batch and learning rate of the top
TRAIN_LR = 5e-3                  # tagger it trains to AUC > 0.9
TRAIN_SHORT = 40                 # steps of the other four taggers
HELD_OUT = (1000, 99)            # top tagging's held-out events, seed
LOW_PRECISION = (500, 98)        # events, seed of the ap_fixed<6,6> check
AUC_MIN = 0.9
AUC_RATIO_MIN = 0.98             # ap_fixed<16,6> / float
AUC_DROP_MIN = 0.02              # float - ap_fixed<6,6>
TIMED_STEPS = 10                 # synchronised steps timed per tagger
RESTART_TAGGERS = ("top-tagging-gru", "flavor-tagging-lstm")
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
SWEEP_MODES = (("static", {}), ("static_hoist", {"hoist_input": True}),
               ("nonstatic", {"mode": "nonstatic"}),
               ("pipeline", {"mode": "pipeline"}))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def tagger_dataset(arch: str, n: int, seed: int):
    """(x, y) of ``arch``'s task from the port's generators."""
    from repro_torch.launch.train import RNN_DATA

    return next(fn for key, fn in RNN_DATA.items() if key in arch)(n, seed)


def train_setup(arch: str, steps: int, **train_kw):
    """The model, optimizer config and step of ``launch.train.train``'s
    loop for ``steps`` steps (``train_kw`` into its ``TrainConfig``)."""
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.training import make_train_step

    m = build_model(get_config(arch))
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps, weight_decay=0.01)
    return m, opt, make_train_step(m, TrainConfig(optimizer=opt, **train_kw))


def train_losses(arch: str, device, steps: int = TRAIN_SHORT, **train_kw):
    """``train``'s loop from its seeded init over its batches, keeping
    every step's loss: (params, losses)."""
    import torch

    from repro_torch.launch.train import _rnn_batches
    from repro_torch.training import adamw_init

    m, opt, step = train_setup(arch, steps, **train_kw)
    params = m.init(torch.Generator().manual_seed(0), device=device)
    st = adamw_init(params, opt)
    batches = _rnn_batches(m.cfg, TRAIN_BATCH, device=device)
    losses = []
    for _ in range(steps):
        params, st, metrics = step(params, st, next(batches))
        losses.append(metrics["loss"])
    return params, [float(v) for v in losses]


def serve_trained(cfg, params, x, device) -> tuple:
    """The trained weights on the kernels (``RNNServingEngine``, default
    schedule) and on the reference forward: (served, reference, launches
    of the served call)."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.models.rnn_tagger import forward
    from repro_torch.serving import RNNServingEngine

    eng = RNNServingEngine(cfg, params, device=device)
    before = dict(cuda.LAUNCHES)
    got = eng.predict(x)
    sync(device)
    launched = counts_since(before, dict(cuda.LAUNCHES))
    with torch.inference_mode():
        want = forward(cfg, params, torch.from_numpy(x).to(device))
    want = want.cpu().numpy()
    check_served(cfg.name, "trained weights", got, want)
    return got, want, launched


def check_top_tagger(arch: str, device) -> dict:
    """``launch.train.train`` at ``repro``'s system-test settings, then the
    paper's pipeline on what it learned: AUC on the reference and on the
    kernels, PTQ to <16,6> and <6,6>, the native <8,3> engine."""
    import torch

    from repro_torch.config import FixedPointConfig
    from repro_torch.core.quant.ptq import binary_auc, ptq_quantize_model
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import train
    from repro_torch.models.rnn_tagger import forward
    from repro_torch.registry import get_config
    from repro_torch.serving import RNNServingEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params, loss = train(arch, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                         lr=TRAIN_LR, log_every=50, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    xt, yt = tagger_dataset(arch, *HELD_OUT)
    got, want, launched = serve_trained(cfg, params, xt, device)
    auc = {"reference": binary_auc(want[:, 0], yt),
           "kernels": binary_auc(got[:, 0], yt)}
    check(min(auc.values()) > AUC_MIN, f"{arch}: held-out AUC {auc}")

    def auc_at(params_, x, y, fp):
        with torch.inference_mode():
            p = forward(cfg, params_, torch.from_numpy(x).to(device), fp=fp)
        return binary_auc(p.cpu().numpy()[:, 0], y)

    fp16 = FixedPointConfig(16, 6)
    auc["ap16_6"] = auc_at(ptq_quantize_model(params, fp16), xt, yt, fp16)
    ratio = auc["ap16_6"] / auc["reference"]
    check(ratio > AUC_RATIO_MIN, f"{arch}: <16,6> AUC ratio {ratio}")
    xl, yl = tagger_dataset(arch, *LOW_PRECISION)
    fp66 = FixedPointConfig(6, 6)
    auc["float_500"] = auc_at(params, xl, yl, None)
    auc["ap6_6"] = auc_at(ptq_quantize_model(params, fp66), xl, yl, fp66)
    check(auc["ap6_6"] < auc["float_500"] - AUC_DROP_MIN,
          f"{arch}: <6,6> kept AUC {auc['ap6_6']} of {auc['float_500']}")

    fp8 = fixed_point_config(FP_NATIVE["int8"])
    q8 = ptq_quantize_model(params, fp8)
    before = dict(cuda.LAUNCHES)
    native = RNNServingEngine(cfg, q8, fp=fp8, device=device).predict(xt)
    sync(device)
    native_launched = counts_since(before, dict(cuda.LAUNCHES))
    emulated = RNNServingEngine(cfg, q8, fp=fp8, impl="xla",
                                device=device).predict(xt)
    check(np.array_equal(native.view(np.int32), emulated.view(np.int32)),
          f"{arch}: native <8,3> differs from the emulation by "
          f"{float(np.abs(native - emulated).max())}")
    auc["ap8_3_native"] = binary_auc(native[:, 0], yt)
    rep = {"train_s": wall, "last_loss": loss, "auc": auc,
           "ap16_6_ratio": ratio, "served_max_abs_err":
           float(np.abs(got - want).max()), "served_launches": launched,
           "native_launches": native_launched}
    print(f"train {arch}: {TRAIN_STEPS} steps of {TRAIN_BATCH} at lr "
          f"{TRAIN_LR} in {wall:.1f} s (launch.train.train); held-out AUC "
          f"{auc['reference']:.4f} reference, {auc['kernels']:.4f} on the "
          f"kernels (max |diff| {rep['served_max_abs_err']:.2e}, launches "
          f"{launched}); <16,6> ratio {ratio:.4f}; <6,6> {auc['ap6_6']:.4f} "
          f"vs float {auc['float_500']:.4f}; native <8,3> AUC "
          f"{auc['ap8_3_native']:.4f}, bit for bit equal to the emulation "
          f"(launches {native_launched})")
    return rep


def check_short_training(arch: str, device, **train_kw) -> dict:
    """``TRAIN_SHORT`` steps of ``train``'s loop: the mean loss of the last
    5 steps below that of the first 5; the result served on the kernels
    within 3e-5 of the reference."""
    from repro_torch.registry import get_config

    params, losses = train_losses(arch, device, **train_kw)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    what = "compressed grads" if train_kw else "loss"
    check(last < first, f"{arch} ({what}): loss {first} -> {last}")
    x, _ = tagger_dataset(arch, BATCH, HELD_OUT[1])
    got, want, launched = serve_trained(get_config(arch), params, x, device)
    rep = {"first5_loss": first, "last5_loss": last,
           "served_max_abs_err": float(np.abs(got - want).max()),
           "served_launches": launched}
    print(f"train {arch}{' (compress_grads)' if train_kw else ''}: "
          f"{TRAIN_SHORT} steps, mean loss of the first 5 {first:.4f} -> "
          f"last 5 {last:.4f}; served on the kernels within "
          f"{rep['served_max_abs_err']:.2e} of the reference (launches "
          f"{launched})")
    return rep


def same_tensors(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        same_bits(got[k], want[k]) for k in want)


def check_restart(arch: str, device) -> dict:
    """Save at step 3, restore into a fresh state on ``device``, continue:
    bit for bit the uninterrupted 6 steps (parameters and moments), as
    ``repro``'s ``tests/test_system.py`` holds."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.training import adamw_init, make_train_step

    m = build_model(get_config(arch))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=20,
                          weight_decay=0.0)
    step = make_train_step(m, TrainConfig(optimizer=opt))
    x, y = tagger_dataset(arch, 256, 0)

    def run(params, st, steps):
        for i in steps:
            idx = np.random.RandomState(100 + i).randint(0, len(x), 32)
            params, st, _ = step(params, st, {
                "x": torch.from_numpy(x[idx]).to(device),
                "y": torch.from_numpy(y[idx]).to(device)})
        return params, st

    p0 = m.init(torch.Generator().manual_seed(0), device=device)
    pa, sa = run(p0, adamw_init(p0, opt), range(6))
    pb, sb = run(p0, adamw_init(p0, opt), range(3))
    ckpt = TRAIN_CKPT / arch
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt))
    mgr.save(3, pb, sb)
    _, pr, o = mgr.restore(device=device)
    sr = adamw_init(pr, opt)._replace(
        step=torch.tensor(o["step"], dtype=torch.int32, device=device),
        m=o["m"], v=o["v"])
    pc, sc = run(pr, sr, range(3, 6))
    check(same_tensors(pc, pa) and same_tensors(sc.m, sa.m)
          and same_tensors(sc.v, sa.v) and int(sc.step) == int(sa.step),
          f"{arch}: the restarted run differs from the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"train {arch}: saved at step 3, restored on {device}, 3 more "
          f"steps: parameters and moments bit for bit the uninterrupted 6")
    return {"bit_for_bit": True}


def check_grad_accum(device) -> dict:
    """``grad_accum=2`` against one step on the full batch (rtol 1e-4, as
    ``repro``'s ``tests/test_optimizer.py`` holds it)."""
    import torch

    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.training import adamw_init, make_train_step

    m = build_model(get_config("top-tagging-gru"))
    tc = TrainConfig(optimizer=OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=10, grad_clip=0,
        weight_decay=0))
    x, y = tagger_dataset("top-tagging-gru", TRAIN_BATCH, HELD_OUT[1])
    batch = {"x": torch.from_numpy(x).to(device),
             "y": torch.from_numpy(y).to(device)}
    p = m.init(torch.Generator().manual_seed(0), device=device)
    st = adamw_init(p, tc.optimizer)
    p1, _, m1 = make_train_step(m, tc, grad_accum=1)(p, st, batch)
    p2, _, m2 = make_train_step(m, tc, grad_accum=2)(p, st, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    check(abs(l1 - l2) <= 1e-5 * abs(l1), f"accum 2 loss {l2} vs {l1}")
    worst = 0.0
    for k in p1:
        a, b = p1[k].cpu().numpy(), p2[k].cpu().numpy()
        check(bool(np.all(np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b))),
              f"accum 2 {k}: differs by {float(np.abs(a - b).max())}")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"train top-tagging-gru: grad_accum=2 matches the full batch of "
          f"{TRAIN_BATCH} (loss {l1:.6f} vs {l2:.6f}, params within "
          f"{worst:.2e})")
    return {"loss": [l1, l2], "max_abs_diff": worst}


def train_path(device) -> dict:
    """Phase 3 ``train``'s path: the six taggers trained on ``device`` and
    served on the kernels, the restart, microbatches and compression."""
    rep = {a: check_top_tagger(a, device) for a in TRAIN_TOP}
    rep.update({a: check_short_training(a, device) for a in TRAIN_OTHERS})
    rep["restart"] = {a: check_restart(a, device) for a in RESTART_TAGGERS}
    rep["grad_accum"] = check_grad_accum(device)
    rep["compress_grads"] = check_short_training(
        "flavor-tagging-gru", device, compress_grads=True)
    return rep


def conformance_sweep(device) -> dict:
    """The port's ``testing.assert_schedule_conformance`` on ``device``:
    lstm and gru in every float mode at R in {1, 4}, rglru and
    reuse_matmul at R in {1, 4}, float32 and bfloat16."""
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.testing import assert_schedule_conformance

    worst: dict = {}
    cells = 0
    for dtype in ("float32", "bfloat16"):
        for kernel in ("lstm", "gru", "rglru", "reuse_matmul"):
            modes = SWEEP_MODES if kernel in ("lstm", "gru") else \
                SWEEP_MODES[:1]
            for what, kw in modes:
                for reuse in REUSES:
                    err = assert_schedule_conformance(
                        kernel, KernelSchedule(reuse_factor=reuse, **kw),
                        dtype=dtype, device=device)
                    key = f"{kernel} {dtype}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    cells += 1
    print(f"conformance harness on {device}: {cells} cells within "
          f"CONFORMANCE_TOL; max abs err {worst}")
    return {"cells": cells, "max_abs_err": worst}


def step_timing(arch: str, device) -> dict:
    """One tagger's training step on the card: ``TIMED_STEPS`` steps, each
    on the host clock around a call that ends synchronised, after two
    warm-up steps; and the device kernels of one step from a
    ``torch.profiler`` trace."""
    import torch

    from repro_torch.training import adamw_init

    m, opt, step = train_setup(arch, TRAIN_STEPS)
    params = m.init(torch.Generator().manual_seed(0), device=device)
    st = adamw_init(params, opt)
    x, y = tagger_dataset(arch, TRAIN_BATCH, 7)
    batch = {"x": torch.from_numpy(x).to(device),
             "y": torch.from_numpy(y).to(device)}
    walls = []
    for i in range(TIMED_STEPS + 2):
        t0 = time.perf_counter()
        params, st, _ = step(params, st, batch)
        sync(device)
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    trace = device_trace(lambda: step(params, st, batch), inference=False)
    kernels = sum(g["launches"] for g in trace.get("kernels", {}).values())
    rep = {"ms_per_step": float(np.median(walls)), "ms_min": min(walls),
           "ms_max": max(walls), "trace": trace, "device_kernels": kernels}
    print(f"train {arch}: {float(np.median(walls)):.2f} ms/step (median of "
          f"{TIMED_STEPS}, {min(walls):.2f}-{max(walls):.2f}; batch "
          f"{TRAIN_BATCH}, host clock, synchronised); one step: {kernels} "
          f"device kernels, busy {trace.get('busy_ms', float('nan')):.3f} of "
          f"{trace.get('span_ms', float('nan')):.3f} ms (idle "
          f"{trace.get('idle_share', float('nan')):.1%}); {card_line()}")
    return rep


def phase_train(device) -> tuple:
    """Phase 3 ``train``, driven with the counts set to 0: the taggers
    trained on the card through the port's trainer and served on the
    kernels (``train_path``).  Then, outside the counts, the conformance
    harness on the card and each tagger's training step timed and traced.
    Returns (launches, report)."""
    t0 = time.perf_counter()
    launches, rep = drive("train", lambda: train_path(device),
                          ("lstm_scan", "gru_scan", "col_matmul",
                           "quant_matmul"))
    for arch in (*TRAIN_TOP, *TRAIN_OTHERS):
        served = rep[arch]["served_launches"]
        scan = "lstm_scan" if arch.endswith("lstm") else "gru_scan"
        check(served.get(scan, 0) > 0 and served.get("col_matmul", 0) > 0,
              f"{arch}: the trained weights were not served on {scan} and "
              f"col_matmul: {served}")
    for arch in TRAIN_TOP:
        check(rep[arch]["native_launches"].get("quant_matmul", 0) > 0,
              f"{arch}: native <8,3> launched {rep[arch]['native_launches']}")
    rep["conformance"] = conformance_sweep(device)
    rep["steps"] = {a: step_timing(a, device)
                    for a in (*TRAIN_TOP, *TRAIN_OTHERS)}
    rep["seconds"] = time.perf_counter() - t0
    print(f"train: {rep['seconds']:.1f} s")
    return launches, rep


#: phase 3 ``serve``: ``launch/serve.py``'s request load a (tagger,
#: mode), two full flushes of the engine's ``max_batch``
SERVE_REQUESTS = 2 * BATCH
SERVE_MODES = ("static", "nonstatic")
SERVE_FP_TAGGER = "top-tagging-gru"   # also served with --fixed-point
SERVE_BENCH_BATCHES = (1, BATCH)      # benchmark() on the default key
SERVE_BENCH_ITERS = 20
SERVE_LM = "gemma-2b"                 # serve_lm's tiny config
SERVE_LM_REQUESTS = 12


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def serve_run(tag: str, mode: str, fixed_point: bool, device) -> tuple:
    """``launch.serve.serve_rnn`` of one tagger in one mode (seeded
    weights, ``SERVE_REQUESTS`` requests through the micro-batcher),
    driven with the counts set to 0: a static run launches the tagger's
    cluster scan and ``col_matmul`` (the head), a non-static one
    ``col_matmul``, ``--fixed-point`` (the ap_fixed<16,6> emulation) no
    kernel of the port.  Every request served once, events/s and p50 /
    p99 finite and positive, the answers bit for bit the engine's
    ``predict`` of the same rows and, in float, within 3e-5 of
    ``backend="xla"``.  Returns (launches, report, engine)."""
    from repro_torch.launch.serve import serve_rnn
    from repro_torch.serving import RNNServingEngine

    scan = "lstm_scan" if tag.endswith("lstm") else "gru_scan"
    kernels = (() if fixed_point else
               (scan, "col_matmul") if mode == "static" else ("col_matmul",))
    path = f"serve {tag} {mode}{' fixed-point' if fixed_point else ''}"
    launches, rep = drive(path, lambda: serve_rnn(
        tag, mode, SERVE_REQUESTS, fixed_point, 1, device=device), kernels)
    if fixed_point:
        check(sum(launches.values()) == 0,
              f"{path}: the ap_fixed<16,6> emulation launched {launches}")
    eng, got, x = rep.pop("engine"), rep.pop("answers"), rep.pop("x")
    check(rep["served"] == SERVE_REQUESTS and got.shape == (
        SERVE_REQUESTS, eng.cfg.rnn.n_outputs)
        and bool(np.isfinite(got).all()),
        f"{path}: served {rep['served']} of {SERVE_REQUESTS}, answers "
        f"{got.shape}")
    check(all(np.isfinite(rep[k]) and rep[k] > 0 for k in (
        "events_per_s", "latency_p50_ms", "latency_p99_ms")),
        f"{path}: {rep}")
    want = eng.predict(x)
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          f"{path}: served answers differ from predict by "
          f"{float(np.abs(got - want).max())}")
    if not fixed_point:
        ref = RNNServingEngine(eng.cfg, eng.params, mode=mode, impl="xla",
                               device=device).predict(x)
        check_served(tag, path, got, ref)
    rep["launches"] = {k: v for k, v in launches.items() if v}
    return launches, rep, eng


def serve_benchmark(tag: str, eng) -> dict:
    """``eng.benchmark`` at ``SERVE_BENCH_BATCHES`` on the engine's
    default key: finite times, one key, one executor build across both
    batch sizes."""
    rows = {b: eng.benchmark(b, iters=SERVE_BENCH_ITERS)
            for b in SERVE_BENCH_BATCHES}
    key = rows[SERVE_BENCH_BATCHES[0]]["key"]
    check(all(r["key"] == key and np.isfinite(r["latency_s"])
              and r["latency_s"] > 0 for r in rows.values()),
          f"benchmark {tag}: {rows}")
    check(eng.trace_count(key) == 1, f"benchmark {tag}: key {key} built "
          f"{eng.trace_count(key)} executors")
    print(f"benchmark {tag} key {key}: " + "; ".join(
        f"B={b} {r['latency_s'] * 1e3:.3f} ms, {r['throughput_eps']:.0f} "
        f"ev/s" for b, r in rows.items())
        + f" (FPGA model: {rows[1]['latency_cycles']} cycles, II "
        f"{rows[1]['ii_cycles']}, {rows[1]['dsp']} DSP); one executor")
    return {str(b): r for b, r in rows.items()}


def phase_serve(device) -> tuple:
    """Phase 3 ``serve``: the single-card drivers of the main path.
    ``serve_run`` for the six taggers in ``SERVE_MODES`` and
    ``SERVE_FP_TAGGER`` with ``--fixed-point``; ``serve_benchmark`` on
    each tagger's static engine (driven with the counts set to 0: the
    scans and the head launched); ``launch.serve.serve_lm`` on
    ``SERVE_LM``'s tiny config (the einsum key, no kernel of the port);
    and ``examples.quickstart`` end to end (150 training steps on the
    reference, held-out AUC > 0.9, ap_fixed<16,6> ratio > 0.98, a batch-1
    ``benchmark`` on the emulation: no kernel of the port).  Returns
    (launches, report)."""
    from repro_torch.examples import quickstart
    from repro_torch.launch.serve import serve_lm

    t0 = time.perf_counter()
    total: dict = {}
    report: dict = {"runs": {}}
    engines = {}
    for tag in TAGGERS:
        for mode in SERVE_MODES:
            launches, rep, eng = serve_run(tag, mode, False, device)
            add_launches(total, launches)
            report["runs"][f"{tag} {mode}"] = rep
            if mode == "static":
                engines[tag] = eng
    launches, rep, _ = serve_run(SERVE_FP_TAGGER, "static", True, device)
    add_launches(total, launches)
    report["runs"][f"{SERVE_FP_TAGGER} static fixed-point"] = rep

    launches, report["benchmark"] = drive(
        "serve benchmark", lambda: {t: serve_benchmark(t, e)
                                    for t, e in engines.items()},
        ("lstm_scan", "gru_scan", "col_matmul"))
    add_launches(total, launches)
    del engines

    launches, lm = drive("serve lm", lambda: serve_lm(
        SERVE_LM, SERVE_LM_REQUESTS, device=device), ())
    add_launches(total, launches)
    finished = lm.pop("finished")
    check(lm["requests"] == SERVE_LM_REQUESTS and all(
        len(v) >= 2 + 8 for v in finished.values())
        and sum(launches.values()) == 0,
        f"serve lm: {lm}, launches {launches}")
    report["lm"] = lm

    launches, qs = drive("serve quickstart",
                         lambda: quickstart.main(device=device), ())
    add_launches(total, launches)
    ratio = qs["auc_ap16_6"] / qs["auc_float"]
    check(qs["auc_float"] > AUC_MIN and ratio > AUC_RATIO_MIN
          and np.isfinite(qs["benchmark"]["latency_s"])
          and sum(launches.values()) == 0,
          f"quickstart: {qs}, launches {launches}")
    report["quickstart"] = qs
    report["seconds"] = time.perf_counter() - t0
    print(f"serve: {report['seconds']:.1f} s; {card_line()}")
    return total, report


def only_serve(device) -> dict:
    """``--serve``: phase 3 ``serve`` alone (kernels built on first use);
    its report and launch counts."""
    launches, report = phase_serve(device)
    return {"launches": launches, "serve": report}


def only_train_lm(arch: str):
    """``--train-lm ARCH``: ``train_lm`` of one LM alone (its
    peak beside its state, its losses and step time); an LM that does not
    fit the card ends the run with the allocator's out-of-memory error."""
    return lambda device: {"train_lm": {arch: train_lm(arch, device)}}


#: phase 3 ``distributed``: the LMs whose training state the dry run
#: predicts on a one-rank mesh (the three that phase 3 ``prefill`` trains)
DIST_LMS = LM_TRAIN
#: ranks of the stage pipeline, all on the one card (gloo, host-staged)
PIPE_RANKS = 4
PIPE_TAGGERS = ("top-tagging-lstm", "top-tagging-gru")
PIPE_BATCH = 16
PIPE_TOL = 1e-5                  # repro's bar for the pipeline
#: synchronised forwards timed for the share of the bf16 peak (after one
#: warm-up; host-clock spans of one forward vary by up to 1.6x, PR 32)
DIST_FORWARD_REPEATS = 10
#: the sharded trainer's tiny LM, its steps and repro's sharded-loss bar
DIST_TRAIN_LM = "stablelm-3b"
DIST_TRAIN_STEPS = 5
DIST_TRAIN_TOL = 2e-4


def round_block(nbytes: int) -> int:
    """The caching allocator's block of an ``nbytes`` tensor: a multiple
    of 512 bytes, at least 512."""
    return max(512, -(-nbytes // 512) * 512)


def allocator_blocks(tensors) -> tuple:
    """(bytes requested, bytes granted) of the caching allocator's active
    blocks that hold ``tensors`` (``torch.cuda.memory_snapshot``: each
    block's ``requested_size`` and ``size``; each block once).  The grant
    is the request in 512-byte blocks, or more where a cached block was
    reused without a split."""
    import torch

    ptrs = {t.data_ptr() for t in tensors}
    seen = set()
    requested = granted = 0
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated" and blk["address"] in ptrs \
                    and blk["address"] not in seen:
                seen.add(blk["address"])
                requested += blk.get("requested_size", blk["size"])
                granted += blk["size"]
    check(len(seen) == len(ptrs), f"allocator blocks: {len(seen)} of "
          f"{len(ptrs)} tensors found")
    return requested, granted


def dry_vs_card(name: str, device, measured_peaks: dict) -> dict:
    """(a) and (b) for one LM at published width: the dry run on a
    one-rank mesh of the training shape of phase 3 ``prefill``
    (``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``, ``remat="full"``) and of its
    forward (``PREFILL_BATCH`` x ``PREFILL_SEQ``); the predicted params +
    AdamW state bytes equal, exactly, the bytes of the tensors the card
    allocates for them and to the bytes the caching allocator was asked
    for (its granted blocks, the prediction in 512-byte blocks and the
    growth of ``memory_allocated`` over the draw reported beside); the
    peak estimate beside
    ``measured_peaks`` (the trainer's ``max_memory_allocated`` from phase
    3 ``prefill``, where this run has it); ``FlopCounterMode``'s count of
    the forward on meta tensors equal, exactly, to its count of the same
    forward on the card, with ``model_flops`` and the forward's share of
    the bf16 peak (median of ``DIST_FORWARD_REPEATS`` synchronised
    forwards)."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import OptimizerConfig, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.training import adamw_init

    cfg = get_config(name)
    model = build_model(cfg)
    train_shape = ShapeConfig("train_lm", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                              "train")
    fwd_shape = ShapeConfig("forward", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    mesh = dryrun.dryrun_mesh((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    # the trainer's step: no microbatches (grad_accum=1)
    rec = {"train": dryrun.cell_record(cfg, train_shape, mesh, "one_rank",
                                       grad_accum=1),
           "forward": dryrun.cell_record(cfg, fwd_shape, mesh, "one_rank")}
    dry_s = time.perf_counter() - t0
    dist.destroy_process_group()
    mem = rec["train"]["memory"]
    predicted = mem["params_bytes"] + mem["opt_state_bytes"]

    free_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    st = adamw_init(params, OptimizerConfig())
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    state = (list(params.values()) + list(st.m.values())
             + list(st.v.values()) + [st.step])
    exact = sum(t.numel() * t.element_size() for t in state)
    blocks = sum(round_block(t.numel() * t.element_size()) for t in state)
    requested, held = allocator_blocks(state)
    check(predicted == exact == requested, f"distributed {name}: the dry "
          f"run predicts {predicted} bytes of params + AdamW state, the "
          f"card's tensors hold {exact}, the allocator was asked for "
          f"{requested}")
    del st

    batch = prefill_inputs(cfg, PREFILL_BATCH, PREFILL_SEQ, device, 9)
    meta_params = model.abstract_params()
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
    with torch.inference_mode():
        with FlopCounterMode(display=False) as on_meta:
            model.forward(meta_params, meta_batch)
        with FlopCounterMode(display=False) as on_card:
            model.forward(params, batch)
        torch.cuda.synchronize()
        walls = []
        for i in range(DIST_FORWARD_REPEATS + 1):
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
    meta_flops, card_flops = on_meta.get_total_flops(), \
        on_card.get_total_flops()
    check(meta_flops == card_flops, f"distributed {name}: FlopCounterMode "
          f"counts {meta_flops} on meta, {card_flops} on the card")
    med = float(np.median(walls))
    mf = model_flops(cfg, fwd_shape)
    del params, batch
    free_card()
    measured = measured_peaks.get(name)
    rep = {"dry_run_s": dry_s, "predicted_state_bytes": predicted,
           "card_state_bytes": exact, "allocated_growth_bytes": grown,
           "allocator_requested_bytes": requested,
           "allocator_granted_bytes": held,
           "allocator_blocks_of_prediction": blocks,
           "train_record": rec["train"], "forward_record": rec["forward"],
           "peak_estimate_gb": mem["peak_bytes"] / 1e9,
           "max_memory_allocated_gb": measured,
           "forward_flops_meta": meta_flops,
           "forward_flops_card": card_flops, "model_flops": mf,
           "forward_ms": med * 1e3,
           "forward_ms_range": [min(walls) * 1e3, max(walls) * 1e3],
           "model_flops_share_bf16_peak": mf / (med * BF16_PEAK),
           "counted_flops_share_bf16_peak": card_flops / (med * BF16_PEAK)}
    print(f"distributed {name}: dry run on a 1-rank mesh in {dry_s:.1f} s "
          f"(train {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, forward "
          f"{PREFILL_BATCH} x {PREFILL_SEQ}): params + AdamW state "
          f"predicted {predicted} B == {exact} B on the card "
          f"({predicted / 1e9:.2f} GB) == {requested} B asked of the "
          f"allocator (granted {held} B, the prediction in 512-byte blocks "
          f"{blocks} B; memory_allocated grew {grown} B); peak estimate "
          f"{rep['peak_estimate_gb']:.2f} GB beside max_memory_allocated "
          f"{'%.2f GB' % measured if measured else 'not measured in this run'}"
          f"; forward FLOPs meta {meta_flops:.6e} == card {card_flops:.6e}, "
          f"model_flops {mf:.6e}; forward {med * 1e3:.2f} ms median of "
          f"{DIST_FORWARD_REPEATS} (host clock, synchronised) = "
          f"{rep['model_flops_share_bf16_peak']:.2%} of the bf16 peak "
          f"(counted FLOPs {rep['counted_flops_share_bf16_peak']:.2%}); "
          f"{card_line()}")
    return rep


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pipeline_inputs(arch: str, seed: int) -> dict:
    """Seeded numpy inputs of ``arch``'s RNN layer at published width:
    xs [PIPE_BATCH, T, in], W, U, b (scaled as ``repro``'s pipeline
    test)."""
    from repro_torch.registry import get_config

    r = get_config(arch).rnn
    g = 4 if r.cell == "lstm" else 3
    rng = np.random.RandomState(seed)
    return {
        "xs": rng.randn(PIPE_BATCH, r.seq_len, r.input_size).astype(
            np.float32),
        "W": rng.randn(r.input_size, g * r.hidden).astype(np.float32) * .3,
        "U": rng.randn(r.hidden, g * r.hidden).astype(np.float32) * .3,
        "b": rng.randn(*((g * r.hidden,) if r.cell == "lstm"
                         else (2, g * r.hidden))).astype(np.float32) * .1}


def pipeline_child(rank: int, world: int, port: int, out: str) -> int:
    """One rank of (c): ``pipelined_rnn`` of every ``PIPE_TAGGERS`` entry,
    plain and hoisted, on tensors on the card, over a gloo group of
    ``world`` ranks; its outputs and host-clock walls under ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.rnn.pipeline import pipelined_rnn
    from repro_torch.registry import get_config

    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res, walls = {}, {}
    for i, arch in enumerate(PIPE_TAGGERS):
        r = get_config(arch).rnn
        args = [torch.from_numpy(v).to(device)
                for v in pipeline_inputs(arch, 40 + i).values()]
        for hoist in (False, True):
            key = f"{arch}/{'hoist' if hoist else 'plain'}"
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = pipelined_rnn(r, *args, hoist_input=hoist)
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            check(o.device == device, f"pipeline rank {rank}: output on "
                  f"{o.device}")
            res[key] = o.cpu().numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(walls))
    dist.destroy_process_group()
    return 0


def check_pipeline(device) -> dict:
    """(c): ``PIPE_RANKS`` processes (one rank if the card's compute mode is
    exclusive) run the stage pipeline on the card, spawned here; each
    rank's answer within ``PIPE_TOL`` of the port's static scan kernel
    (``ops.lstm_scan`` / ``ops.gru_scan`` on the card: rows 1 and 3, a
    comparison launch outside every count) on the same inputs."""
    import socket

    import torch

    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.registry import get_config

    mode = compute_mode()
    ranks = PIPE_RANKS if mode == "Default" else 1
    out = ROOT / "build" / "pipeline"
    out.mkdir(parents=True, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--pipeline-rank", str(r), str(ranks),
                               str(port), str(out)])
             for r in range(ranks)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t0
    check(rcs == [0] * ranks, f"pipeline ranks exited {rcs}")
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(ranks)]
    walls = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(ranks)]
    rep = {"compute_mode": mode, "ranks": ranks, "spawn_s": spawn_s,
           "errors": {}, "walls_s": walls[0]}
    for i, arch in enumerate(PIPE_TAGGERS):
        r = get_config(arch).rnn
        args = [torch.from_numpy(v).to(device)
                for v in pipeline_inputs(arch, 40 + i).values()]
        scan = ops.lstm_scan if r.cell == "lstm" else ops.gru_scan
        before = dict(cuda.LAUNCHES)
        with torch.inference_mode():
            want = scan(*args, schedule=KernelSchedule()).cpu().numpy()
        torch.cuda.synchronize()
        kname = f"{r.cell}_scan"
        check(cuda.LAUNCHES[kname] > before.get(kname, 0),
              f"pipeline reference: {kname} was not launched")
        for mode_ in ("plain", "hoist"):
            key = f"{arch}/{mode_}"
            err = max(float(np.abs(g[key] - want).max()) for g in got)
            check(err <= PIPE_TOL, f"pipeline {key}: {err} from the static "
                  f"scan kernel over {ranks} ranks")
            rep["errors"][key] = err
    print(f"distributed pipeline: {ranks} ranks on the one card (compute "
          f"mode {mode}; gloo, state staged through the host), "
          f"{PIPE_TAGGERS} at published width, B={PIPE_BATCH}, plain and "
          f"hoisted: max |pipeline - static scan kernel| "
          f"{json.dumps(rep['errors'])} (bar {PIPE_TOL}); rank 0's walls "
          f"{json.dumps(walls[0])} s; {spawn_s:.1f} s with spawning")
    return rep


def check_sharded_trainer(device) -> dict:
    """(d): ``launch.train.train`` of ``DIST_TRAIN_LM``'s tiny config on
    the card, unsharded and with ``mesh_shape=(1, 1)`` (a one-rank NCCL
    group the trainer starts): the sharded run's parameters are DTensors,
    its step was built with ``grad_shardings``, and every step's loss (read
    from the step function) within ``DIST_TRAIN_TOL`` of the unsharded
    run's; whether they are equal bit for bit is reported."""
    import contextlib
    import io

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as tlaunch

    real = tlaunch.make_train_step
    losses, pinned = [], []

    def recording(*a, **kw):
        step = real(*a, **kw)
        pinned.append(kw.get("grad_shardings") is not None)

        def run(params, opt_state, batch):
            out = step(params, opt_state, batch)
            loss = out[2]["loss"]
            losses[-1].append(float(loss.full_tensor() if isinstance(
                loss, DTensor) else loss))
            return out
        return run

    kw = dict(steps=DIST_TRAIN_STEPS, batch=8, seq_len=64, tiny=True,
              device=device, log_every=DIST_TRAIN_STEPS)
    tlaunch.make_train_step = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            losses.append([])
            tlaunch.train(DIST_TRAIN_LM, **kw)
            losses.append([])
            params, _ = tlaunch.train(DIST_TRAIN_LM, mesh_shape=(1, 1), **kw)
    finally:
        tlaunch.make_train_step = real
    single, sharded = losses
    is_dt = all(isinstance(v, DTensor) for v in params.values())
    del params
    if dist.is_initialized():
        dist.destroy_process_group()
    err = max(abs(a - b) for a, b in zip(single, sharded))
    check(len(single) == len(sharded) == DIST_TRAIN_STEPS,
          f"sharded trainer: {len(single)} / {len(sharded)} steps")
    check(is_dt and pinned == [False, True],
          f"sharded trainer: DTensor params {is_dt}, grad_shardings {pinned}")
    check(err <= DIST_TRAIN_TOL, f"sharded trainer: losses {sharded} vs "
          f"{single} ({err})")
    rep = {"lm": DIST_TRAIN_LM, "losses_single": single,
           "losses_sharded": sharded, "max_abs_diff": err,
           "bit_equal": single == sharded}
    print(f"distributed trainer: {DIST_TRAIN_LM} tiny on the card, "
          f"mesh_shape=(1, 1): DTensor params, grad_shardings pinned; "
          f"losses {['%.6f' % v for v in sharded]} vs unsharded max diff "
          f"{err:.3e} (bar {DIST_TRAIN_TOL}; bit for bit: {rep['bit_equal']})")
    return rep


def phase_distributed(device, prefill_report=None) -> tuple:
    """Phase 3 ``distributed`` (no kernel of the port is on this path, as
    none is on ``repro``'s: launch counts must stay 0): (a) + (b)
    ``dry_vs_card`` for ``DIST_LMS``, (c) ``check_pipeline``, (d)
    ``check_sharded_trainer``.  (e), the dropped model's params, is
    checked in phase ``dense_lms``.  Returns (launches, a report)."""
    peaks = {k: v["peak_gb"] for k, v in
             ((prefill_report or {}).get("train") or {}).items()}

    def run():
        rep = {"lms": {n: dry_vs_card(n, device, peaks) for n in DIST_LMS}}
        rep["trainer"] = check_sharded_trainer(device)
        return rep

    launches, rep = drive("distributed", run, ())
    check(sum(launches.values()) == 0,
          f"distributed: kernels of the port launched: {launches}")
    rep["pipeline"] = check_pipeline(device)
    return launches, rep


def only_distributed(device) -> dict:
    """``--distributed``: phase 3 ``distributed`` alone; its report."""
    launches, report = phase_distributed(device)
    return {"launches": launches, "distributed": report}


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
        elif c["name"] == "rglru_scan":
            row["layout"] = rglru_layouts(*c["inputs"], out)[1]._asdict()
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


def report_batch_invariance(device) -> dict:
    """``--batch-invariance``: build the kernels, then
    :func:`batch_invariance` in report mode."""
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    return batch_invariance(device, strict=False)


def time_scans(device) -> dict:
    """``--time-scans``: the in-loop static scans (``lstm_scan`` /
    ``gru_scan``) of every tagger, float32, at B = 8 (R = 1) and B = 256
    (R = 1 and 4): device time per call from a trace and CUDA events,
    with cuDNN's for the same function beside them; the hoisted and
    pipeline scans likewise (:func:`time_hoisted_scans`); and the engines'
    ``predict_one`` p50 / p99 and flush-of-256 p50 (host clock), on the
    default static schedule and on pipeline R = 1.  It times
    whichever tree's ``repro_torch`` was imported: with
    ``--src`` an older tree (an unpacked parent commit) is timed the same
    way, so two trees are compared in one call by running the script
    twice on one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.kernels.schedule import KernelSchedule
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
        x = np.random.RandomState(750 + i).randn(
            BATCH, r.seq_len, r.input_size).astype(np.float32)
        for what, sched in (("", None),
                            (" pipeline", KernelSchedule(mode="pipeline"))):
            eng = RNNServingEngine(cfg, params, impl="pallas",
                                   device=device, schedule=sched)
            out["engines"].append({"engine": tag + what, **time_engine(
                tag + what, eng, x, SCAN_ONE_CALLS, SCAN_FLUSHES)})
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


#: ``rglru_scan``'s timed cases (B, T, W, dtype, R): recurrentgemma-9b's
#: width at R = 1 and 4, in bf16, and one sequence
RGLRU_TIMED = ((RG_B, RG_T, RG_W, "float32", 1),
               (RG_B, RG_T, RG_W, "float32", 4),
               (RG_B, RG_T, RG_W, "bfloat16", 1),
               (1, RG_T, RG_W, "float32", 1))


def time_elementwise(device) -> dict:
    """``--time-elementwise``: ``rglru_scan`` at ``RGLRU_TIMED``,
    ``fixed_point`` at ``FXP_SHAPES`` x {f32, bf16} x ``FP_GRID`` and
    ``hadamard`` at ``HADAMARD_SHAPES`` x {f32, bf16}: CUDA-event ms over
    back-to-back calls, device ms from a trace, and CUDA-event ms of calls
    that each find L2 cold, beside the library call's
    (``fake_quantize_per_tensor_affine`` where it computes the same
    function, rnd / sat; ``torch.mul``) and the bytes bound, held against
    the L2-cold time.  It times whichever tree's ``repro_torch`` was
    imported (``--src``)."""
    import torch

    from repro_torch.kernels import fixed_point as fx
    from repro_torch.kernels import hadamard as hd

    gen = torch.Generator(device=device).manual_seed(950)
    rows = rglru_rows(device)

    def row(name, shape, kern, lib, inputs, flops):
        with torch.inference_mode():
            out = kern()
        r = {"name": name, "shape": shape, "ms": time_ms(kern, 200),
             "device_ms": per_call(kern, name, 50),
             "cold_ms": time_cold_ms(kern, 50),
             "library_ms": time_ms(lib, 200) if lib else None,
             "library_device_ms": per_call(lib, "other", 50) if lib else None,
             "library_cold_ms": time_cold_ms(lib, 50) if lib else None,
             "bound_ms": bound(inputs, out, flops)[0]}
        # the bound counts every byte from HBM: only a call that finds L2
        # cold is held to it (a warm call may read its input from L2)
        r["cold_share_of_bound"] = r["bound_ms"] / r["cold_ms"]
        rows.append(r)
        lib_txt = ("n/a" if lib is None else
                   f"device {r['library_device_ms']:.4f}, events "
                   f"{r['library_ms']:.4f}, L2 cold "
                   f"{r['library_cold_ms']:.4f}")
        print(f"elementwise {name:11s} {shape:32s}: device "
              f"{r['device_ms']:.4f} ms, events {r['ms']:.4f} (L2 warm), "
              f"L2 cold {r['cold_ms']:.4f}; library {lib_txt}; HBM bytes "
              f"bound {r['bound_ms']:.5f}, {r['cold_share_of_bound']:.1%} "
              f"of the L2-cold time")

    for shape in FXP_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(*shape, generator=gen, device=device) * 8).to(dt)
            for spec in FP_GRID:
                fp = fixed_point_config(spec)
                row("fixed_point", f"{tuple(shape)} {str(dt)[6:]} "
                    f"ap{'_'.join(map(str, spec))}",
                    lambda x=x, fp=fp: fx.fixed_point_kernel(x, fp),
                    fake_quantize_library(x, fp), (x,), 0.0)
    for shape in HADAMARD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, y = (torch.randn(*shape, generator=gen, device=device).to(dt)
                    for _ in range(2))
            row("hadamard", f"{shape} {str(dt)[6:]}",
                lambda x=x, y=y: hd.hadamard_kernel(x, y),
                lambda x=x, y=y: torch.mul(x, y), (x, y), float(x.numel()))
    return {"kernels": rows}


def rglru_rows(device) -> list:
    """``rglru_scan`` at ``RGLRU_TIMED`` through its wrapper, with the tiles
    ``ops.rglru_scan`` hands it at that R: device ms (trace), CUDA-event ms
    L2 warm and L2 cold, the bytes bound and its share of the L2-cold time,
    the launch layout (where the imported tree has a layout model), and
    ``torch.mul(a, bx)`` on the same inputs: another function, only a
    measured floor for the same bytes (two operands read, one written), not
    a library call for the recurrence."""
    import torch

    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels.ops import rglru_tiles
    from repro_torch.kernels.schedule import KernelSchedule

    gen = torch.Generator(device=device).manual_seed(960)
    rows = []
    for B, T, W, dt, reuse in RGLRU_TIMED:
        dtype = getattr(torch, dt)
        a, bx = rglru_inputs(B, T, W, dtype, gen, device)
        bb, bw, serial = rglru_tiles(KernelSchedule(reuse_factor=reuse), B, W)
        kern = lambda a=a, bx=bx, k=(bb, bw, serial): (  # noqa: E731
            rg.rglru_scan_kernel(a, bx, block_batch=k[0], block_width=k[1],
                                 serial_width=k[2]))
        floor = lambda a=a, bx=bx: torch.mul(a, bx)  # noqa: E731
        with torch.inference_mode():
            out = kern()
        r = {"name": "rglru_scan", "shape": f"({B},{T},{W}) {dt} R={reuse}",
             "ms": time_ms(kern, 80),
             "device_ms": per_call(kern, "rglru_scan", 20),
             "cold_ms": time_cold_ms(kern, 20),
             "same_bytes_mul_device_ms": per_call(floor, "other", 50),
             "same_bytes_mul_cold_ms": time_cold_ms(floor, 50),
             "bound_ms": bound((a, bx), out, 2.0 * B * T * W)[0],
             "layout": (rg.layout_of(a, bx, out)._asdict()
                        if hasattr(rg, "layout_of") else None)}
        r["cold_share_of_bound"] = r["bound_ms"] / r["cold_ms"]
        rows.append(r)
        print(f"elementwise rglru_scan {r['shape']:30s}: device "
              f"{r['device_ms']:.4f} ms, events {r['ms']:.4f} (L2 warm), L2 "
              f"cold {r['cold_ms']:.4f}; HBM bytes bound "
              f"{r['bound_ms']:.5f}, {r['cold_share_of_bound']:.1%} of the "
              f"L2-cold time; torch.mul(a, bx) (same bytes, not the same "
              f"function) device {r['same_bytes_mul_device_ms']:.4f}, L2 "
              f"cold {r['same_bytes_mul_cold_ms']:.4f}; layout "
              f"{r['layout']}")
    return rows


def no_nan(obj):
    """``obj`` with every NaN (a reading the trace did not give) as None,
    so that the line is strict JSON."""
    if isinstance(obj, dict):
        return {k: no_nan(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [no_nan(v) for v in obj]
    return None if isinstance(obj, float) and obj != obj else obj


#: the batches of the graph replay check: predict_one's, a flush's and the
#: bulk cell's chunk
GRAPH_BATCHES = (1, BATCH, 2048)
#: consecutive replays of the aliasing check, over GRAPH_CHUNKS chunks
GRAPH_REPLAYS = 100
GRAPH_CHUNKS = 4


def copy_in_us(x, device, threads: int, calls: int = 200) -> dict:
    """Median time (us) from the start of a chunk's copy to the card to its
    end (synchronised), at ``threads`` of PyTorch's threads, the ways in
    turns: ``pageable``, CUDA's asynchronous copy from ``x`` (what a
    replayed call does); ``pinned_np`` / ``pinned_torch``, ``np.copyto`` /
    PyTorch's ``copy_`` into a pinned buffer, then its copy."""
    import torch

    pinned = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
    view = pinned.numpy()
    dst = torch.empty(x.shape, dtype=torch.float32, device=device)
    ways = {
        "pageable": lambda: dst.copy_(torch.from_numpy(x), non_blocking=True),
        "pinned_np": lambda: (np.copyto(view, x),
                              dst.copy_(pinned, non_blocking=True)),
        "pinned_torch": lambda: (pinned.copy_(torch.from_numpy(x)),
                                 dst.copy_(pinned, non_blocking=True))}
    was = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        runs = {k: [] for k in ways}
        for _ in range(calls):
            for k, way in ways.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                way()
                torch.cuda.synchronize()
                runs[k].append(time.perf_counter() - t)
    finally:
        torch.set_num_threads(was)
    return {k: float(np.median(v)) * 1e6 for k, v in runs.items()}


def check_graphs(device) -> dict:
    """The serving executors' CUDA graph replay (``serving/graphs.py``) on
    the card, on QuickDraw LSTM (the bulk cell's tagger).  For static,
    non-static and pipeline schedules at B in ``GRAPH_BATCHES``: the first
    ``predict`` eager, the second captured, two more replayed, each
    replayed answer bit for bit the eager one, one capture and three
    replays counted.  At B = 2048: ``GRAPH_REPLAYS`` consecutive replays
    over ``GRAPH_CHUNKS`` chunks, every answer its chunk's eager one and no
    two sharing memory; a replayed call recorded by ``tracing`` with 4
    launches and 1 replay; 20 replayed calls under ``torch.profiler`` list
    the cluster scan and ``col_matmul`` under their own names, 12 kernels
    a call; the host wall of the bulk and the ``predict_one`` executor's
    call, eager against replayed, in turns; a chunk's copy onto the card,
    CUDA's from pageable memory against staging through a pinned
    buffer (:func:`copy_in_us`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.kernels import cuda
    from repro_torch.kernels.schedule import KernelSchedule

    tag = "quickdraw-lstm"
    report = {}
    for mode in ("static", "nonstatic", "pipeline"):
        cfg, _, eng = tagger_engine(tag, device,
                                    schedule=KernelSchedule(mode=mode))
        for b in GRAPH_BATCHES:
            x = tagger_events(cfg, b, 700 + b)
            graphs0 = dict(cuda.GRAPHS)
            eager = eng.predict(x)
            replayed = [eng.predict(x) for _ in range(3)]
            grew = {k: cuda.GRAPHS[k] - graphs0[k] for k in graphs0}
            same = all(np.array_equal(r.view(np.int32), eager.view(np.int32))
                       for r in replayed)
            check(same and grew == {"captures": 1, "replays": 3},
                  f"graphs {tag} {mode} B={b}: replayed answers equal the "
                  f"eager one: {same}; counted {grew}")
            report[f"{mode}_B{b}"] = {"bits_equal": same, **grew}
            print(f"graphs {tag} {mode} B={b}: 1 eager, 1 capture, 2 "
                  f"replays: answers bit for bit the eager one")
        eng.close()

    cfg, _, eng = tagger_engine(tag, device)
    chunks = [tagger_events(cfg, GRAPH_BATCHES[-1], 800 + i)
              for i in range(GRAPH_CHUNKS)]
    eng.predict(chunks[0])
    eng.predict(chunks[0])
    (replay,) = eng._replays
    want = [replay._eager(c, None) for c in chunks]
    got = [eng.predict(chunks[i % GRAPH_CHUNKS])
           for i in range(GRAPH_REPLAYS)]
    right = all(np.array_equal(g.view(np.int32),
                               want[i % GRAPH_CHUNKS].view(np.int32))
                for i, g in enumerate(got))
    shared = sum(np.may_share_memory(g, h)
                 for i, g in enumerate(got) for h in got[:i])
    check(right and not shared,
          f"graphs: {GRAPH_REPLAYS} replays over {GRAPH_CHUNKS} chunks: "
          f"each its chunk's eager answer {right}, {shared} pairs share "
          f"memory")
    print(f"graphs: {GRAPH_REPLAYS} consecutive replays over "
          f"{GRAPH_CHUNKS} chunks: each its chunk's eager answer bit for "
          f"bit, no two sharing memory")

    with tracing.recording() as rec:
        for c in chunks:
            eng.predict(c)
    roots = [s.counters for s in rec.spans if s.parent == -1]
    names = sorted({s.name for s in rec.spans if s.parent != -1})
    check(all(r["launches"] == 4 and r["graph_replays"] == 1
              and r["graph_captures"] == 0 for r in roots)
          and names == ["engine.d2h", "engine.h2d", "engine.replay"],
          f"graphs: recorded replayed calls {roots}, spans {names}")
    print(f"graphs: a replayed bulk call records {roots[0]}, spans {names}")

    calls = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            eng.predict(chunks[i % GRAPH_CHUNKS])
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [n for n in ops if "memcpy" not in n.lower()
               and "memset" not in n.lower()]
    scans = sum("cluster_scan_kernel<0, false" in n for n in kernels)
    heads = sum("col_matmul_kernel" in n for n in kernels)
    check(scans == calls and heads == 3 * calls
          and len(kernels) == 12 * calls,
          f"graphs: the trace of {calls} replayed calls lists {scans} "
          f"cluster scans, {heads} col_matmul, {len(kernels)} kernels "
          f"(names {sorted(set(n[:60] for n in kernels))})")
    print(f"graphs: the trace of {calls} replayed calls lists {scans} "
          f"cluster scans, {heads} col_matmul, {len(kernels) / calls:g} "
          f"kernels and {(len(ops) - len(kernels)) / calls:g} copies a call")
    report["trace"] = {"kernels_per_call": len(kernels) / calls,
                       "copies_per_call": (len(ops) - len(kernels)) / calls,
                       "names": sorted(set(ops))}

    one = chunks[0][:1]
    eng.predict_one(one[0])
    eng.predict_one(one[0])
    replay_one = eng._replays[1]
    for what, fn, xs in (("bulk", replay, chunks),
                         ("one", replay_one, [one])):
        walls = {"eager": [], "replayed": []}
        for _ in range(5):
            for how, call in (("eager", lambda c: fn._eager(c, None)),
                              ("replayed", fn)):
                t = time.perf_counter()
                for i in range(100):
                    call(xs[i % len(xs)])
                walls[how].append((time.perf_counter() - t) / 100 * 1e3)
        report[f"{what}_executor_wall_ms"] = walls
        print(f"graphs: host wall of the {what} executor's call (ms, 5 "
              f"rounds of 100, in turns): eager "
              f"{[round(w, 4) for w in walls['eager']]}, replayed "
              f"{[round(w, 4) for w in walls['replayed']]}")
    report["copy_in_us"] = {t: copy_in_us(chunks[0], device, t)
                            for t in (1, 8)}
    print(f"graphs: a chunk ({chunks[0].nbytes} B) onto the card, median "
          f"us to the copy's end, by PyTorch's threads: "
          f"{report['copy_in_us']}")
    eng.close()
    check(not replay.graphs(), "graphs: close() left a graph")
    return report


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
    what.add_argument("--time-elementwise", action="store_true",
                      help="only time fixed_point and hadamard beside their "
                      "library calls (see time_elementwise)")
    what.add_argument("--families", action="store_true",
                      help="only run phase 3 families: the moe, ssm, "
                      "hybrid, enc-dec and vlm LMs served on the card (see "
                      "phase_families)")
    what.add_argument("--prefill", action="store_true",
                      help="only run phase 3 prefill and every LM's "
                      "forward at published width (see phase_prefill, "
                      "prefill_widths)")
    what.add_argument("--serve", action="store_true",
                      help="only run phase 3 serve: launch/serve.py for the "
                      "six taggers, benchmark(), serve_lm and the "
                      "quickstart example on the card (see phase_serve)")
    what.add_argument("--train-lm", metavar="ARCH",
                      help="only train one LM at published width as phase "
                      "3 prefill does, and report its peak (see train_lm)")
    what.add_argument("--distributed", action="store_true",
                      help="only run phase 3 distributed: the dry run "
                      "against the card, the stage pipeline over ranks "
                      "sharing the card, the (1, 1)-mesh trainer (see "
                      "phase_distributed)")
    what.add_argument("--graphs", action="store_true",
                      help="only check the serving executors' CUDA graph "
                      "replay (see check_graphs)")
    what.add_argument("--batch-invariance", action="store_true",
                      help="only report one event's answer across batch "
                      "shapes, launch by launch (see batch_invariance)")
    ap.add_argument("--cache-child", nargs=2, metavar=("DIR", "TAGGER"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--pipeline-rank", nargs=4, type=str,
                    metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--src", help="with a --time-* or --batch-invariance "
                    "option: import "
                    "repro_torch from this directory (default: this "
                    "checkout's src)")
    opts = ap.parse_args()
    timing = {"time_scans": time_scans, "time_products": time_products,
              "time_decode": time_decode,
              "time_elementwise": time_elementwise,
              "families": only_families, "prefill": only_prefill,
              "serve": only_serve, "distributed": only_distributed,
              "train_lm": only_train_lm(opts.train_lm),
              "graphs": check_graphs,
              "batch_invariance": report_batch_invariance}
    only = next((k for k in timing if getattr(opts, k)), None)
    if opts.src:
        if not only:
            ap.error("--src goes with a --time-* or --batch-invariance "
                     "option")
        sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    if opts.cache_child:
        return cache_child(*opts.cache_child)
    if opts.pipeline_rank:
        r, w, port, out = opts.pipeline_rank
        return pipeline_child(int(r), int(w), int(port), out)
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
    launches["autotune"], autotune_rows = phase_autotune(device)
    launches["robustness"], robustness = phase_robustness(device)
    launches.update(phase_fixed_point(device))
    launches["lm_decode"], lm = phase_lm_decode(device)
    launches["speculative"], spec_rep = phase_speculative(device)
    launches["speculative_rnn"], spec_rnn = phase_speculative_rnn(device)
    launches["dense_lms"], dense_lms = phase_dense_lms(device)
    launches["families"], families = phase_families(device)
    launches["prefill"], prefill = phase_prefill(device)
    launches["rnn_decode"] = phase_rnn_decode(device)
    launches.update(phase_rglru(device))
    launches["train"], train_rep = phase_train(device)
    launches["serve"], serve_rep = phase_serve(device)
    launches["distributed"], dist_rep = phase_distributed(device, prefill)
    graphs_rep = check_graphs(device)
    rows, scans = phase_timing(device)

    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "timings": rows, "nonstatic_scans": scans,
         "lm_decode": lm, "speculative": spec_rep,
         "speculative_rnn": spec_rnn, "dense_lms": dense_lms,
         "families": families, "prefill": prefill,
         "autotune": autotune_rows,
         "robustness": robustness, "train": train_rep,
         "serve": serve_rep, "distributed": dist_rep, "graphs": graphs_rep,
         "launches": launches,
         "max_abs_err": errs},
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
        if name in PRODUCT_LIBS or name in ("decode_matmul", "rglru_scan"):
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
