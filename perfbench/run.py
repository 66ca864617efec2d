"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix (``perfbench/configs``, ``perfbench/traffic``).  Set-up makes
the tagger's weights on the card from the seed, a pool of events from the
seed, and ``repro_torch``'s ``RNNServingEngine`` on those weights; warms
the traffic's one shape; then one client calls the traffic's entry
(``predict`` on chunks, or ``predict_one``) back to back, with no think
time, for ``--seconds`` (a closed loop).  Each call is timed on the host
clock from the call to its answer on the host.  ``--trace 1`` runs the
same window, cut to ``TRACE_SECONDS``, under ``torch.profiler`` and reports
the per-layer metrics in place of the end-to-end ones.

After the window, a sample of its calls drawn from the seed is held to the
plain float32 reference (``perfbench/reference.py``) on the same weights
and events: the widest gap of a class probability against the
configuration's limit.  The last line of standard output is the result
(JSON); the numbers compared are the last lines of standard error.  With
no card, or fewer than the cell asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()        # the process's start, before torch loads

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Mapping, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)             # perfbench's modules load as a package
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from perfbench import spec  # noqa: E402

#: top-level modules the run's process may not hold: JAX and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's compile cache (its kernels build into build/kernels)
CACHE_DIR = ROOT / "build" / "perfbench-cache"
#: a traced run's window, at most: reading the trace takes the host about
#: 50 us a device event, and the non-static cell launches 1413 kernels a
#: call, so a whole 51-second window took 120 s to read
TRACE_SECONDS = 20


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Bench:
    """A cell made from one seed: the program on the card and what is
    handed to it."""

    cell: spec.Cell
    weights: Dict            # the benchmark's weights (the reference's)
    pool: np.ndarray         # [calls in the pool, rows, T, in]
    engine: object
    call: Callable           # the traffic's entry on one pool item
    stamps: Dict[str, float]  # set-up's steps, seconds since the start


def check_sizes(model_cfg, cfg: Mapping) -> None:
    """The program's registry entry has the configuration's sizes."""
    r = model_cfg.rnn
    have = {"cell": r.cell, "seq_len": r.seq_len, "input_size":
            r.input_size, "hidden": r.hidden, "dense_sizes":
            list(r.dense_sizes), "n_outputs": r.n_outputs,
            "output_activation": r.output_activation}
    want = {k: cfg[k] for k in have}
    if have != want:
        raise ValueError(f"{cfg['arch']}: the program's config {have} is "
                         f"not the benchmark's {want}")


def make_pool(cell: spec.Cell, seed: int) -> np.ndarray:
    from perfbench.generators import GENERATORS

    cfg, t = cell.cfg, cell.traffic
    if (t["loop"], t["clients"], t["think_ms"]) != ("closed", 1, 0):
        raise ValueError("the harness drives one closed-loop client with "
                         "no think time")
    rows = t["events_per_call"]
    n = t["pool_events"] // rows * rows
    x = GENERATORS[t["generator"]](n, np.random.default_rng(seed))
    if x.shape[1:] != (cfg["seq_len"], cfg["input_size"]):
        raise ValueError(f"{t['generator']} makes events {x.shape[1:]}, "
                         f"{cfg['arch']} takes ({cfg['seq_len']}, "
                         f"{cfg['input_size']})")
    return x.reshape(n // rows, rows, *x.shape[1:])


def build(cell: spec.Cell, seed: int, device,
          stamps: Optional[Dict[str, float]] = None) -> Bench:
    """Weights, events and the program's engine, warmed at the traffic's
    shape.  ``stamps`` collects the seconds since the start at each step."""
    import torch

    stamps = {} if stamps is None else stamps
    from perfbench.reference import make_weights
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.registry import get_config
    from repro_torch.serving.engine import RNNServingEngine

    stamps["program"] = time.perf_counter() - T0
    cfg, traffic = cell.cfg, cell.traffic
    if cfg.get("fp") is not None:
        raise ValueError("fixed-point configurations are not run yet")
    model_cfg = get_config(cfg["arch"])
    check_sizes(model_cfg, cfg)
    weights = make_weights(cfg, seed, device)
    stamps["weights"] = time.perf_counter() - T0
    pool = make_pool(cell, seed)
    stamps["events"] = time.perf_counter() - T0
    engine = RNNServingEngine(
        model_cfg, {k: v.clone() for k, v in weights.items()},
        schedule=KernelSchedule(**cfg["schedule"]), device=device,
        cache_dir=str(CACHE_DIR) if device.type == "cuda" else None)
    if traffic["entry"] == "predict":
        call = engine.predict
    elif traffic["entry"] == "predict_one":
        def call(x, one=engine.predict_one):
            return one(x[0])[None]
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    stamps["engine"] = time.perf_counter() - T0
    for i in range(traffic["warmup_calls"]):
        call(pool[i % len(pool)])
        if not i:
            stamps["first_call"] = time.perf_counter() - T0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps["warm"] = time.perf_counter() - T0
    return Bench(cell, weights, pool, engine, call, stamps)


class Sample:
    """A reservoir of ``k`` of the window's calls, drawn from the seed:
    (pool index, answer)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def window(bench: Bench, seconds: float, seed: int, traced: bool):
    """The closed loop: back-to-back calls for ``seconds``.  Returns the
    spans (ns, on the profiler's wall-clock base), the device events of a
    traced run, the sample and the failed calls."""
    import torch

    call, pool = bench.call, bench.pool
    if traced:
        seconds = min(seconds, TRACE_SECONDS)
    sample = Sample(bench.cell.traffic["check_calls"], seed)
    starts: List[int] = []
    ends: List[int] = []
    failed = 0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    gc.collect()
    gc.freeze()
    clock = time.perf_counter_ns
    offset = time.time_ns() - clock()
    setup_s = time.perf_counter() - T0
    deadline = clock() + int(seconds * 1e9)
    i, n = 0, len(pool)
    while True:
        s = clock()
        try:
            out = call(pool[i % n])
        except Exception:           # counted, and the run is not correct
            if not failed:
                traceback.print_exc()
            failed, out = failed + 1, None
        e = clock()
        starts.append(s)
        ends.append(e)
        sample.offer((i % n, out))
        i += 1
        if e >= deadline:
            break
    device = []
    if prof is not None:
        from perfbench.trace import device_events
        t = time.perf_counter()
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        device = device_events(prof)
        print(f"trace: {len(device)} device events read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    spans = (np.asarray(starts, np.int64) + offset,
             np.asarray(ends, np.int64) + offset)
    return spans, device, sample, failed, setup_s


def compare(bench: Bench, kept, answer: Optional[Callable] = None) -> Dict:
    """The sampled calls' answers against the reference on the same
    weights and events: ``{name: [value, limit]}``.  ``answer`` (the
    control) stands in for the program's answers."""
    import torch

    from perfbench.reference import matmul_precision, tagger_blocks

    cfg = bench.cell.cfg
    dev = next(iter(bench.weights.values())).device
    idx = [i for i, _ in kept]
    x = torch.from_numpy(bench.pool[idx].reshape(
        -1, cfg["seq_len"], cfg["input_size"])).to(dev)
    with torch.inference_mode():
        with matmul_precision(False):
            ref = tagger_blocks(cfg, bench.weights, x).cpu().numpy()
        if answer is not None:
            got = answer(x).cpu().numpy()
        else:
            outs = [o for _, o in kept]
            shape = (bench.cell.traffic["events_per_call"],
                     cfg["n_outputs"])
            bad = sum(o is None or np.shape(o) != shape for o in outs)
            if bad:
                return {"answers_missing": [bad, 0]}
            got = np.concatenate([np.asarray(o) for o in outs])
    gap = np.abs(got.astype(np.float64) - ref)
    nonfinite = int((~np.isfinite(got)).any(axis=1).sum())
    return {"answers_missing": [0, 0],
            "nonfinite_rows": [nonfinite, 0],
            "prob_gap_max": [float(np.nan_to_num(gap, nan=np.inf).max()),
                             cfg["check"]["prob_gap_max"]]}


def passed(checks: Mapping) -> bool:
    return all(v <= lim for v, lim in checks.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, stamps: Optional[Dict[str, float]] = None) -> Dict:
    """One run of ``cell``: the result line's fields."""
    import torch

    from perfbench.trace import Window, breakdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the load comes from one process with few threads
    torch.set_num_threads(1)
    bench = build(cell, seed, device, stamps)
    (starts, ends), dev_events, sample, failed, setup_s = window(
        bench, seconds, seed, traced)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    bench.engine = bench.call = None
    print("setup (s since the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in bench.stamps.items()), file=sys.stderr)
    slices = np.bincount((ends - starts[0]) // 10**9)
    print("calls in each second of the window: " + " ".join(
        map(str, slices)), file=sys.stderr)
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = compare(bench, sample.kept)
    win = Window(cell.cfg, cell.traffic, starts, ends,
                 cell.traffic["events_per_call"], setup_s, traced, dev_events)
    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end,
                                win)
    result = {"correct": failed == 0 and passed(checks),
              "attempted": win.calls, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = win.busy_s()
        result["device"]["window_s"] = win.window_s
        result["breakdown"] = breakdown(win)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.resolve(args.workload)
    import torch

    stamps = {"import_torch": time.perf_counter() - T0}
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    stamps["cuda_found"] = time.perf_counter() - T0
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), stamps)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
