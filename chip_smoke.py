#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit and builds every CUDA kernel
     from ``src/repro_torch/csrc`` (timed);
  2. holds each scan kernel against its plain PyTorch version on the card,
     at the main path's shapes of all six taggers (B = 256, R in {1, 4},
     float32 and bfloat16 inputs);
  3. serves requests for all six (config x cell) taggers at full width
     through ``RNNServingEngine(..., impl="pallas", device="cuda")`` with
     seeded random weights (``predict``, ``predict_one``, ``submit`` /
     ``flush``, a hoisted and an R=4 schedule), checks every answer against
     the same model on ``backend="xla"``, and checks that every kernel was
     launched;
  4. times each kernel (CUDA events) beside its plain version, one PyTorch
     library call for the same function (``torch.nn.LSTM`` / ``GRU``), and
     its bound on the card;
  5. ends with the JSON result line.

Any failed check raises, so the script exits non-zero; it exits non-zero
and prints no result when no CUDA device is available.  The full timing
table is also written to ``build/chip_smoke.json``.
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
REUSES = (1, 4)
ONE_CALLS = 12                   # predict_one calls per tagger (first builds)
F32_PEAK = 67e12                 # H100 SXM f32 CUDA-core peak, FLOP/s
HBM_BPS = 3.35e12                # H100 SXM device memory, bytes/s
TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
#: the shape whose timings go into the result line (the largest tagger)
HEADLINE = "quickdraw"

#: kernel -> (TPU kernel it replaces, source of the CUDA kernel)
KERNELS = {
    "lstm_scan": "src/repro/kernels/lstm_scan.py:120",
    "lstm_scan_hoisted": "src/repro/kernels/lstm_scan.py:238",
    "gru_scan": "src/repro/kernels/gru_scan.py:99",
    "gru_scan_hoisted": "src/repro/kernels/gru_scan.py:200",
}
SOURCE = "src/repro_torch/csrc/rnn_scan.cu"


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


def scan_inputs(cell, T, fin, H, dtype, seed, device):
    """Seeded inputs at a tagger's shapes: weights scaled like the taggers'
    initialisation (lecun kernel, unit-scale recurrent, small bias)."""
    import torch

    rng = np.random.RandomState(seed)
    g = 4 if cell == "lstm" else 3
    xs = rng.randn(BATCH, T, fin)
    W = rng.randn(fin, g * H) / np.sqrt(fin)
    U = rng.randn(H, g * H) / np.sqrt(H)
    b = rng.randn(*((g * H,) if cell == "lstm" else (2, g * H))) * 0.1
    as_t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
        a, dtype=dt, device=device)
    return as_t(xs, dtype), as_t(W), as_t(U), as_t(b)


def kernel_calls(cell, xs, W, U, b, reuse):
    """(name, kernel thunk, plain thunk, inputs of the bound) per kernel of
    ``cell`` on these inputs; the hoisted kernels get zx from the port's
    hoist stage, as on the main path."""
    from repro_torch.kernels import gru_scan as gs
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.kernels.ops import _hoist_stage

    zx = _hoist_stage(xs, W)
    od = xs.dtype
    if cell == "lstm":
        return [
            ("lstm_scan", lambda: ls.lstm_scan_kernel(xs, W, U, b, reuse=reuse),
             lambda: ls.lstm_scan_plain(xs, W, U, b, reuse=reuse),
             (xs, W, U, b)),
            ("lstm_scan_hoisted",
             lambda: ls.lstm_scan_hoisted_kernel(zx, U, b, reuse=reuse,
                                                 out_dtype=od),
             lambda: ls.lstm_scan_hoisted_plain(zx, U, b, reuse=reuse,
                                                out_dtype=od),
             (zx, U, b)),
        ]
    zxb = (zx + b[0]).contiguous()
    b_rec = b[1].contiguous()
    return [
        ("gru_scan", lambda: gs.gru_scan_kernel(xs, W, U, b, reuse=reuse),
         lambda: gs.gru_scan_plain(xs, W, U, b, reuse=reuse), (xs, W, U, b)),
        ("gru_scan_hoisted",
         lambda: gs.gru_scan_hoisted_kernel(zxb, U, b_rec, reuse=reuse,
                                            out_dtype=od),
         lambda: gs.gru_scan_hoisted_plain(zxb, U, b_rec, reuse=reuse,
                                           out_dtype=od),
         (zxb, U, b_rec)),
    ]


def library_call(name, inputs):
    """One PyTorch call computing the same function as kernel ``name`` on
    its ``inputs`` (cuDNN's LSTM / GRU), used only as a yardstick.  torch's
    LSTM gate order i|f|g|o equals Keras i|f|c|o (bias_hh = 0); its GRU is
    reset_after with gates r|z|n, a permutation of Keras z|r|hh.  The hoisted
    kernels' function (final h from precomputed zx) is the same cell with an
    identity input weight."""
    import torch

    hoisted = name.endswith("hoisted")
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


def bound(name, inputs, out_bytes, B, T, H, fin):
    """(bound_ms, bound_by): the larger of the bytes each input read once
    and the output written once over device-memory bandwidth, and the gate
    matmul FLOPs over the f32 CUDA-core peak (the kernels use no tensor
    cores)."""
    g = 4 if name.startswith("lstm") else 3
    k = H if name.endswith("hoisted") else fin + H
    flops = 2.0 * B * T * k * g * H
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + out_bytes
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_kernels(device) -> dict:
    """Every kernel against its plain version at every main-path shape."""
    import torch

    from repro_torch.configs import get_config

    errs: dict = {}
    for i, tag in enumerate(TAGGERS):
        r = get_config(tag).rnn
        for dtype in (torch.float32, torch.bfloat16):
            for reuse in REUSES:
                xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size,
                                          r.hidden, dtype, 100 + i, device)
                with torch.inference_mode():
                    for name, kern, plain, _ in kernel_calls(r.cell, xs, W, U,
                                                             b, reuse):
                        got = kern()
                        torch.cuda.synchronize()
                        want = plain()
                        check(got.dtype == want.dtype
                              and got.shape == (BATCH, r.hidden),
                              f"{name} {tag}: {got.dtype} {tuple(got.shape)}")
                        err, scale = max_err(got, want)
                        tol = TOL[str(dtype).split(".")[1]]
                        print(f"check {name:18s} {tag:20s} "
                              f"{str(dtype)[6:]:8s} R={reuse}: max_abs_err "
                              f"{err:.3e} (tol {tol * scale:.1e})")
                        check(bool(np.isfinite(err)) and err <= tol * scale,
                              f"{name} {tag} {dtype} R={reuse}: err {err}")
                        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def phase_serving(device) -> dict:
    """The port's main path: all six taggers served on the kernels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.schedule import KernelSchedule, schedule_key
    from repro_torch.models.init import init_params
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.serving import RNNServingEngine

    hoist = KernelSchedule(hoist_input=True)
    r4 = KernelSchedule(reuse_factor=4)
    engines = []
    for i, tag in enumerate(TAGGERS):
        cfg = get_config(tag)
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(i), "cpu")
        eng = RNNServingEngine(cfg, params, impl="pallas", device=device)
        ref = RNNServingEngine(cfg, params, impl="xla", device=device)
        rnn = cfg.rnn
        x = np.random.RandomState(i).randn(
            24, rnn.seq_len, rnn.input_size).astype(np.float32)
        engines.append((tag, eng, ref, x))

    cuda.reset_launches()
    served = {}
    for tag, eng, _, x in engines:
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
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)

    for tag, eng, ref, x in engines:
        want = ref.predict(x)
        got = served[tag]
        for what, rows in (("predict", slice(0, 8)),
                           ("predict_r4", slice(0, 8)),
                           ("predict_one", slice(0, ONE_CALLS)),
                           ("flush", slice(0, 16)),
                           ("flush_hoist", slice(16, 24))):
            g, w = got[what], want[rows]
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"{tag} {what}: shape {g.shape} vs {w.shape}")
            err = float(np.abs(g - w).max())
            scale = max(1.0, float(np.abs(w).max()))
            check(err <= TOL["float32"] * scale,
                  f"{tag} {what}: err {err} vs backend xla")
        for key in eng._infer_cache:
            check(eng.trace_count(key) == 1, f"{tag}: {key} built "
                  f"{eng.trace_count(key)} times")
        rep = eng.serve_report()
        key = schedule_key(eng.resolved_schedule)
        fast = rep[key]["fast_path"]["latency_p50_s"] * 1e3
        flush = rep[key]["measured"]
        print(f"served {tag:20s} keys={sorted(eng._infer_cache)} "
              f"predict_one p50 {fast:.3f} ms, flush of {BATCH} rows: "
              f"{int(flush['batches'])} batch(es), request latency p50 "
              f"{flush['latency_p50_s'] * 1e3:.3f} ms; all answers within "
              f"{TOL['float32']:.0e} of backend xla")
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches


def phase_timing(device) -> list:
    """Kernel, plain and library times and the bound at B = 256."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda

    rows = []
    for i, tag in enumerate(TAGGERS):
        r = get_config(tag).rnn
        xs, W, U, b = scan_inputs(r.cell, r.seq_len, r.input_size, r.hidden,
                                  torch.float32, 200 + i, device)
        for reuse in REUSES:
            for name, kern, plain, inputs in kernel_calls(r.cell, xs, W, U, b,
                                                          reuse):
                lib = library_call(name, inputs)
                with torch.inference_mode():
                    lib_err = float((lib() - kern()).abs().max())
                ms = time_ms(kern, 20)
                plain_ms = time_ms(plain, 3, warmup=1)
                library_ms = time_ms(lib, 20)
                b_ms, b_by, flops, nbytes = bound(
                    name, inputs, BATCH * r.hidden * 4, BATCH, r.seq_len,
                    r.hidden, r.input_size)
                row = {"name": name, "tagger": tag, "reuse": reuse,
                       "B": BATCH, "T": r.seq_len, "in": r.input_size,
                       "H": r.hidden, "chain_steps": r.seq_len * reuse,
                       "rows_per_block": cuda.rows_per_block(BATCH),
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "flop": flops, "bytes": nbytes,
                       "library_max_abs_err": lib_err}
                rows.append(row)
                print(f"time {name:18s} {tag:20s} R={reuse}: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.3f} ms, library "
                      f"{library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                      f"chain {r.seq_len * reuse} steps, library err "
                      f"{lib_err:.1e}")
    return rows


def main() -> int:
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

    t0 = time.perf_counter()
    paths = cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{[str(p.relative_to(ROOT)) for p in paths.values()]}")
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            lines = log.read_text().splitlines()
            regs = [ln.strip() for ln in lines if "registers" in ln]
            spills = [ln.strip() for ln in lines
                      if "spill" in ln and " 0 bytes spill" not in ln]
            print(f"ptxas: {len(regs)} kernels, e.g. "
                  f"{regs[0] if regs else 'n/a'}; spilling: {spills or 'none'}")

    errs = phase_kernels(device)
    launches = phase_serving(device)
    rows = phase_timing(device)

    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "timings": rows, "launches": launches,
         "max_abs_err": errs}, indent=1))

    kernels = []
    for name, replaces in KERNELS.items():
        row = next(r for r in rows if r["name"] == name and r["reuse"] == 1
                   and r["tagger"].startswith(HEADLINE))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{row['tagger']} B={BATCH} R=1", "card": card})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
