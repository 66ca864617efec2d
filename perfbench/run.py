"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix (``perfbench/configs``, ``perfbench/traffic``).  The traffic's
``"entry"`` names the module that makes the program and judges it,
``perfbench/entries/<entry>.py`` (``spec.entry``): its set-up makes the
weights and a pool of inputs from the seed, the program on those weights,
and warms the traffic's shapes.  Then one client calls the entry's call
on the pool's items back to back, with no think time, for ``--seconds``
(a closed loop); each call answers ``events_per_call`` events and is
timed on the host clock from the call to its answer on the host.
``--trace 1`` runs the same window, cut to ``TRACE_SECONDS``, under
``torch.profiler`` and reports the per-layer metrics in place of the
end-to-end ones.

After the window, a sample of its calls drawn from the seed is held by
the entry's ``compare`` to a plain reference on the same weights and
inputs, each number against its limit in the configuration.  The last
line of standard output is the result (JSON); the numbers compared are
the last lines of standard error.  With no card, or fewer than the cell
asks for, it exits 3 and prints no result.
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
from typing import (Callable, Dict, List, Mapping, Optional,  # noqa: E402
                    Sequence)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)             # perfbench's modules load as a package
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
# the entries import this module as perfbench.run: one module, one T0
sys.modules.setdefault("perfbench.run", sys.modules[__name__])

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
    pool: Sequence           # the inputs, one item a call
    engine: object
    call: Callable           # the traffic's entry on one pool item
    stamps: Dict[str, float]  # set-up's steps, seconds since the start


def build(cell: spec.Cell, seed: int, device,
          stamps: Optional[Dict[str, float]] = None) -> Bench:
    """The cell's entry's set-up: weights, inputs and the program, warmed
    at the traffic's shapes.  ``stamps`` collects the seconds since the
    start at each step."""
    t = cell.traffic
    if (t["loop"], t["clients"], t["think_ms"]) != ("closed", 1, 0):
        raise ValueError("the harness drives one closed-loop client with "
                         "no think time")
    return spec.entry(cell.traffic["entry"]).build(
        cell, seed, device, {} if stamps is None else stamps)


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
    """The sampled calls' answers against the reference, by the cell's
    entry: ``{name: [value, limit]}``.  ``answer`` (the control) stands
    in for the program's answers."""
    return spec.entry(bench.cell.traffic["entry"]).compare(
        bench, kept, answer)


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
