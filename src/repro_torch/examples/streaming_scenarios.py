"""Trigger-grade STREAMING scenarios on the port: the paper's deployment
settings as live overload-aware pipelines.

Three scenarios over one ``StreamingPipeline`` (ingest -> prep -> queue ->
infer -> sink, monotone stamps at every boundary, per-request deadline):

  trigger   HEP level-1 trigger over simulated top-tagging jets: a TRAINED
            GRU scores each jet against a hard per-event deadline; the
            decision sink thresholds the logit into keep/drop, and the
            admission token bucket runs at the priced throughput of the
            DSP-budgeted design point.

  ticks     HFT-style tick replay: bursty arrivals (Poisson clumps); the
            bucket's burst credit and the bounded queue do the work; every
            shed is counted per reason, never silent.

  stress    2x sustained overload with a mid-run infer stall
            (``FaultInjector``): the degradation ladder (cheaper schedules
            from the autotuned frontier, ``degradation_ladder``) downgrades
            at the high-water mark, sheds what it must, recovers at the
            low-water mark, and the exact per-key accounting (submitted ==
            answered + shed + failed) survives the whole episode.

All replays run on a VIRTUAL clock with the analytical service model, so
every latency below is the modeled FPGA's, deterministic, not a time of
the device; the tagger's answers are computed on ``--device`` (the ladder's
schedules are on the reference backend, as in ``repro``).

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_scenarios
      [--events 400] [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import warnings
from typing import Dict

import numpy as np

from repro_torch.autotune import (DesignTarget, SpaceSpec,
                                  degradation_ladder, select)
from repro_torch.data import top_tagging_dataset
from repro_torch.examples._common import train_tagger
from repro_torch.device import require_device
from repro_torch.serving import (FaultInjector, RNNServingEngine,
                                 StreamingPipeline, VirtualClock,
                                 format_stream_report)

SPACE = SpaceSpec(backends=("xla",), block_batches=(8,))
CLOCK_MHZ = 200.0
DEADLINE_US = 50.0


def build(events, steps=120, device="cuda"):
    """Trained tagger engine + DSP-budgeted degradation ladder + jets."""
    cfg, _, params = train_tagger("top-tagging-gru", steps=steps,
                                  device=device)
    eng = RNNServingEngine(cfg, params, max_batch=8, device=device)
    base = select(cfg, DesignTarget(max_dsp=400, objective="latency"), SPACE)
    ladder = degradation_ladder(cfg, base, spec=SPACE, max_rungs=3)
    x, y = top_tagging_dataset(events, seed=11)
    return eng, ladder, x, y


def replay(pipe, clk, xs, dts):
    """Push each event at its arrival offset, pumping as we go."""
    reqs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for x, dt in zip(xs, dts):
            t = clk.advance(dt)
            reqs.append(pipe.push(x, now=t))
            pipe.pump(now=t)
        pipe.drain()
    return reqs


def summarize(name, pipe, reqs, y=None):
    acc = pipe.verify_accounting()        # raises if a request went missing
    answered = [r for r in reqs if r.status == "answered"]
    shed = sum(c["shed"] for c in acc.values())
    print(f"\n-- {name}: {len(reqs)} events -> {len(answered)} answered, "
          f"{shed} shed, {sum(c['failed'] for c in acc.values())} failed, "
          f"{pipe.downgrades} downgrades / {pipe.recoveries} recoveries")
    if answered:
        lat = np.asarray([r.infer_latency_s for r in answered]) * 1e6
        print(f"   admitted latency p50/p99/max = {np.percentile(lat, 50):.2f}"
              f"/{np.percentile(lat, 99):.2f}/{lat.max():.2f} us "
              f"(deadline {pipe.deadline_s * 1e6:.0f} us, "
              f"misses {sum(c['deadline_miss'] for c in acc.values())})")
    if y is not None and answered:
        kept = [r for r in answered if r.result]
        idx = {r.req_id: i for i, r in enumerate(reqs)}
        tp = sum(1 for r in kept if y[idx[r.req_id]] == 1)
        sig = int((y[[idx[r.req_id] for r in answered]] == 1).sum())
        print(f"   trigger kept {len(kept)} jets; signal efficiency "
              f"{tp}/{max(sig, 1)} = {tp / max(sig, 1):.2f}")


def scenario_trigger(eng, ladder, x, y):
    """HEP trigger at 0.8x the rung-0 priced rate: regular bunch crossings,
    thresholded decision at the sink, no overload expected."""
    clk = VirtualClock()
    pipe = StreamingPipeline(
        eng, ladder, deadline_us=DEADLINE_US, clock_mhz=CLOCK_MHZ, clock=clk,
        decision_fn=lambda out: bool(np.asarray(out).ravel()[-1] > 0.5),
        stage_budgets_us={"infer": DEADLINE_US, "sink": 1.0})
    dt = 1.0 / (0.8 * pipe._rung_rate(0))
    reqs = replay(pipe, clk, x, [dt] * len(x))
    summarize("HEP trigger (0.8x, thresholded sink)", pipe, reqs, y=y)
    return pipe


def scenario_ticks(eng, ladder, x):
    """HFT tick replay: Poisson-bursty arrivals averaging 1.2x the rung-0
    rate — mean overload is mild but bursts slam the bucket and queue."""
    clk = VirtualClock()
    pipe = StreamingPipeline(eng, ladder, deadline_us=DEADLINE_US,
                             clock_mhz=CLOCK_MHZ, clock=clk, max_queue=16)
    rng = np.random.RandomState(3)
    mean_dt = 1.0 / (1.2 * pipe._rung_rate(0))
    # clumps of 1-8 back-to-back ticks separated by exponential gaps
    dts = []
    while len(dts) < len(x):
        burst = min(rng.randint(1, 9), len(x) - len(dts))
        dts.append(rng.exponential(mean_dt * burst))
        dts.extend([mean_dt * 0.02] * (burst - 1))
    reqs = replay(pipe, clk, x, dts[:len(x)])
    summarize("HFT tick replay (bursty, 1.2x mean)", pipe, reqs)
    return pipe


def scenario_stress(eng, ladder, x):
    """2x sustained overload plus a 60us infer stall a third of the way in:
    downgrade, shed, recover — with exact accounting throughout."""
    clk = VirtualClock()
    faults = FaultInjector().stall("infer", 60e-6, after=len(x) // 3)
    pipe = StreamingPipeline(eng, ladder, deadline_us=DEADLINE_US,
                             clock_mhz=CLOCK_MHZ, clock=clk, faults=faults)
    dt = 1.0 / (2.0 * pipe._rung_rate(0))
    reqs = replay(pipe, clk, x, [dt] * len(x))
    summarize("2x overload + 60us infer stall", pipe, reqs)
    print(f"   faults fired: {pipe.faults.fired}")
    return pipe


def main(events: int = 400, steps: int = 120, device: str = "cuda") -> Dict:
    device = require_device(device, "streaming_scenarios")
    eng, ladder, x, y = build(events, steps, device)
    print("degradation ladder (base = latency-best under max_dsp=400):")
    for i, pt in enumerate(ladder):
        print(f"  rung {i}: {pt.key}  {pt.throughput_eps(CLOCK_MHZ):.2e} "
              f"ev/s, dsp {pt.dsp}")

    pipes = {"trigger": scenario_trigger(eng, ladder, x, y),
             "ticks": scenario_ticks(eng, ladder, x),
             "stress": scenario_stress(eng, ladder, x)}

    print("\nfull stream report for the stress run:")
    print(format_stream_report(pipes["stress"]))
    return {k: p.verify_accounting() for k, p in pipes.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=400)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(**vars(ap.parse_args()))
