"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>
[--mode static|nonstatic] [--requests N] [--fixed-point] [--reuse R]
[--device cpu]``.

The port of ``repro.launch.serve``.  RNN taggers (the paper's use case):
seeded params, the ``RNNServingEngine`` on ``--device`` (``cuda`` unless
the caller asks for ``cpu``; the engine's default ``impl="pallas"`` serves
on the hand-written scan kernels there), a synthetic request load streamed
through the micro-batcher, wall-clock latency / throughput beside the
analytical FPGA design point of the same (mode, precision, reuse): the
paper's comparison.  ``--reuse`` sets the FPGA design point's reuse
factors only, as in ``repro``; the engine serves its default schedule.

LM archs: a tiny-config ``LMServingEngine`` with continuous batching.

Both drivers print ``repro``'s report and return its numbers as a dict.
Unlike ``repro``'s, ``serve_rnn`` raises if a flush failed: a failed
request is not served, and events/s over it would be wrong.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.config import FixedPointConfig
from repro_torch.data import (flavor_tagging_dataset, quickdraw_dataset,
                              top_tagging_dataset)
from repro_torch.device import device_name, require_device
from repro_torch.models.model import build_model
from repro_torch.registry import get_config
from repro_torch.serving import LMServingEngine, RNNServingEngine
from repro_torch.testing import tiny_config


def request_load(cfg, n_requests: int) -> np.ndarray:
    """The synthetic request payloads of ``repro``'s driver (seed 3)."""
    if "top-tagging" in cfg.name:
        x, _ = top_tagging_dataset(n_requests, seed=3)
    elif "flavor" in cfg.name:
        x, _ = flavor_tagging_dataset(n_requests, seed=3)
    else:
        x, _ = quickdraw_dataset(n_requests, seed=3)
    return x


def serve_rnn(arch: str, mode: str = "static", n_requests: int = 512,
              fixed_point: bool = False, reuse: int = 1,
              device: Union[str, torch.device] = "cuda",
              params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """Serve ``n_requests`` of ``arch``'s synthetic load; returns the
    printed numbers (``served``, ``wall_s``, ``events_per_s``,
    ``latency_p50_ms`` / ``latency_p99_ms``, the ``fpga`` design point),
    the ``answers`` in submission order, their payloads ``x`` and the
    ``engine``.  ``params`` default to the port's seeded init (seed 0)."""
    device = require_device(device, "serve_rnn")
    cfg = get_config(arch)
    if params is None:
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       device=device)
    fp = FixedPointConfig(16, 6) if fixed_point else None
    eng = RNNServingEngine(cfg, params, mode=mode, fp=fp, device=device)
    eng.warmup()
    x = request_load(cfg, n_requests)

    reqs, lat = [], []
    t0 = time.perf_counter()
    for i in range(n_requests):
        reqs.append(eng.batcher.submit(x[i]))
        done = eng.batcher.run(eng.predict)
        lat.extend(d.latency_s for d in done)
    done = eng.batcher.drain()
    if done:
        out = eng.predict(np.stack([d.payload for d in done]))
        t = time.perf_counter()
        for i, d in enumerate(done):
            d.result, d.done_s = out[i], t
        lat.extend(d.latency_s for d in done)
    wall = time.perf_counter() - t0
    failed = [r for r in reqs if r.status != "answered"]
    if failed:
        raise RuntimeError(
            f"serve {arch}: {len(failed)} of {n_requests} requests not "
            f"served ({failed[0].status})") from failed[0].error

    lat_ms = np.asarray(lat) * 1e3
    p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
    print(f"[serve] {arch} mode={mode} fp={'16,6' if fixed_point else 'off'}"
          f" on {device_name(device)}")
    print(f"  served {n_requests} requests in {wall:.2f}s "
          f"({n_requests/wall:.0f} ev/s)")
    print(f"  latency p50={p50:.2f}ms p99={p99:.2f}ms")
    d = eng.fpga_design(reuse_kernel=reuse, reuse_recurrent=reuse,
                        strategy="resource" if reuse > 1 else "latency")
    print(f"  paired FPGA design point: latency {d.latency_min_us:.1f}-"
          f"{d.latency_max_us:.1f}us II={d.ii_cycles} "
          f"DSP={d.dsp} fits={d.fits} ({d.part})")
    print(f"  FPGA throughput @200MHz: {d.throughput_eps:.0f} ev/s "
          f"(batch-1; paper Sec 5.2 compares V100 batch-1 at 660 ev/s)")
    return {"arch": arch, "mode": mode, "fixed_point": fixed_point,
            "device": device_name(device), "served": len(lat),
            "wall_s": wall,
            "events_per_s": n_requests / wall,
            "latency_p50_ms": float(p50), "latency_p99_ms": float(p99),
            "fpga": {"latency_min_us": d.latency_min_us,
                     "latency_max_us": d.latency_max_us,
                     "ii_cycles": d.ii_cycles, "dsp": d.dsp,
                     "fits": d.fits, "part": d.part,
                     "throughput_eps": d.throughput_eps},
            "answers": np.stack([r.result for r in reqs]), "x": x,
            "engine": eng}


def serve_lm(arch: str, n_requests: int = 12,
             device: Union[str, torch.device] = "cuda",
             params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """``arch`` at its tiny config (``testing.tiny_config``) through
    ``LMServingEngine`` with continuous batching: ``n_requests`` prompts of
    2-7 tokens (seed 0), 8 new tokens each.  Returns ``requests``,
    ``tokens``, ``wall_s``, ``tokens_per_s`` and the ``finished`` tokens by
    request id.  ``params`` default to the port's seeded init (seed 0, on
    the CPU's generator, so every device serves the same weights)."""
    device = require_device(device, "serve_lm")
    cfg = tiny_config(get_config(arch))
    if params is None:
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       device="cpu")
    eng = LMServingEngine(cfg, params, max_batch=4, max_seq=64,
                          device=device)
    rng = np.random.RandomState(0)
    pending = [list(rng.randint(2, cfg.vocab_size, rng.randint(2, 8)))
               for _ in range(n_requests)]
    t0 = time.perf_counter()
    finished = {}
    while pending or any(s.active for s in eng.slots):
        while pending and eng.add_request(pending[0], max_new=8) is not None:
            pending.pop(0)
        finished.update(eng.tick())
    wall = time.perf_counter() - t0
    toks = sum(len(v) for v in finished.values())
    print(f"[serve] {arch} (tiny) on {device_name(device)}: {len(finished)} "
          f"requests, {toks} tokens in {wall:.2f}s ({toks/wall:.0f} tok/s, "
          f"continuous batching)")
    return {"arch": arch, "device": device_name(device),
            "requests": len(finished), "tokens": toks, "wall_s": wall,
            "tokens_per_s": toks / wall, "finished": finished}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="top-tagging-gru")
    ap.add_argument("--mode", default="static",
                    choices=["static", "nonstatic"])
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--fixed-point", action="store_true")
    ap.add_argument("--reuse", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.family == "rnn":
        return serve_rnn(args.arch, args.mode, args.requests,
                         args.fixed_point, args.reuse, device=args.device)
    return serve_lm(args.arch, min(args.requests, 12), device=args.device)


if __name__ == "__main__":
    main()
