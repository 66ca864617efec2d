"""The readings that a cell's limit is set from, in one process on the card.

    python3 perfbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 4 [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds: the cell's weights, inputs and program, as
a run makes them, the traffic's entry called on as many pool items as a
run compares (``check_calls``), and those answers held to the reference
(the program's reading).  For each of ``--control-seeds`` seeds: the
entry's ``control``, the reference in the precision below the
configuration's put in the program's place on the same inputs (the
control's reading; for the taggers, TF32 products for float32).  Prints
one JSON line per seed and, for each side, each number's least and
largest reading; the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import run, spec  # noqa: E402


def program_reading(cell, seed, device):
    bench = run.build(cell, seed, device)
    n = len(bench.pool)
    kept = [(j % n, bench.call(bench.pool[j % n]))
            for j in range(cell.traffic["check_calls"])]
    bench.engine = bench.call = None
    t = time.perf_counter()
    checks = run.compare(bench, kept)
    return checks, time.perf_counter() - t


def control_reading(cell, seed, device):
    """The control's checks, by the cell's entry (its ``control``)."""
    return spec.entry(cell.traffic["entry"]).control(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.resolve(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + k
        checks, ref_s = program_reading(cell, seed, device)
        rows.append({"side": "program", "seed": seed, "reference_s": ref_s,
                     **{n: v for n, (v, _) in checks.items()}})
        print(json.dumps(rows[-1]), flush=True)
    for k in range(args.control_seeds):
        seed = args.first_seed + 1000 + k
        checks = control_reading(cell, seed, device)
        rows.append({"side": "control", "seed": seed,
                     **{n: v for n, (v, _) in checks.items()}})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "device":
               torch.cuda.get_device_name(device)}
    for side in ("program", "control"):
        got = [r for r in rows if r["side"] == side]
        names = [n for n in got[0] if n not in ("side", "seed",
                                                 "reference_s")] if got else []
        summary[side] = {n: {"min": min(r[n] for r in got),
                             "max": max(r[n] for r in got), "n": len(got)}
                         for n in names if all(n in r for r in got)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
