"""End-to-end SERVING driver (the paper's deployment scenarios) on the
port: train the flavor tagger, then serve a MIXED stream of requests —
every tenant states a DESIGN TARGET (latency / resource / throughput
budget) instead of a hard-coded KernelSchedule, and the auto-scheduler
resolves each target to a point on the latency-resource curve: the
explorer enumerates the legal schedule space, prices it analytically,
reduces it to a Pareto frontier, and picks the objective-optimal feasible
point.  Requests then co-batch by the selected schedule's hash (one
executor per key) and the final report pairs each key's measured latency
on the device with ``estimate_schedule`` of the same schedule object: the
paper's measured-vs-analytical two-column table, per tenant — with the
schedules chosen by the machine, not the operator.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_tagger
      [--requests 512] [--max-batch 64] [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch.autotune import DesignTarget, SpaceSpec
from repro_torch.data import flavor_tagging_dataset
from repro_torch.examples._common import train_tagger
from repro_torch.device import require_device
from repro_torch.serving import RNNServingEngine, format_serve_report

# three tenants on one engine, each stating WHAT it needs — the trigger
# latency budget, the resource-capped co-tenant, and the throughput-driven
# coprocessor farm — paper Fig. 1 as live traffic, auto-scheduled
TENANT_TARGETS = (
    ("trigger", DesignTarget(max_latency_us=1.0, objective="latency")),
    ("saver", DesignTarget(max_dsp=12000, objective="resources")),
    ("farm", DesignTarget(min_throughput_eps=1e6, objective="throughput")),
)

# the slice of schedule space this deployment may execute: a "pallas_*"
# backend is the kernel path (the hand-written kernels on the card, their
# plain versions on the CPU), named as repro names it so the keys agree
SPACE = SpaceSpec(reuse_factors=(1, 2, 4), iis=(0, 1), block_batches=(8,),
                  backends=("pallas_interpret",))


def main(requests: int = 512, max_batch: int = 64, steps: int = 150,
         device: str = "cuda") -> Dict:
    device = require_device(device, "serve_tagger")
    cfg, model, params = train_tagger("flavor-tagging-gru", steps=steps,
                                      device=device)
    x, _ = flavor_tagging_dataset(requests, seed=5)

    eng = RNNServingEngine(cfg, params, max_batch=max_batch, device=device)
    for name, target in TENANT_TARGETS:   # resolve + ready each tenant once
        pt = eng.schedule_for_target(target, spec=SPACE)
        print(f"tenant {name:8s} {target.describe()}")
        print(f"  -> {pt.key}  pred {pt.latency_us():.2f}us, "
              f"II {pt.ii_cycles}, dsp {pt.dsp}, bram {pt.bram_18k}")
        eng.warmup(schedule=pt.schedule, fp=pt.fp)

    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    for i in range(requests):
        _, target = TENANT_TARGETS[rng.randint(len(TENANT_TARGETS))]
        eng.submit(x[i], target=target)   # target -> memoized schedule queue
        eng.flush()                       # flush whichever queues are ready
    leftovers = eng.flush(force=True)     # end of stream
    wall = time.perf_counter() - t0

    print(f"served {requests} mixed-target requests in {wall:.2f}s "
          f"({requests / wall:.0f} ev/s), "
          f"{len(leftovers)} flushed at end of stream")
    report = eng.serve_report()
    print(format_serve_report(report))

    d = eng.fpga_design(reuse_kernel=48, reuse_recurrent=40,
                        strategy="resource")
    print(f"FPGA R=(48,40): {d.latency_min_us:.1f}-"
          f"{d.latency_max_us:.1f}us (paper Table 3: 6.7-24.8us) "
          f"II={d.ii_cycles} -> {d.throughput_eps:.0f} ev/s")
    return {"wall_s": wall, "events_per_s": requests / wall,
            "report": report}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(**vars(ap.parse_args()))
