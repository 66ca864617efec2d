"""The paper's taggers served by ``repro_torch``'s ``RNNServingEngine``:
what the ``predict`` and ``predict_one`` entries share.

Set-up makes the tagger's weights on the card from the seed, a pool of
events from the seed (the traffic's generator), and the engine on those
weights, and warms the traffic's one shape.  The check holds a sample of
the window's answers to the plain float32 reference
(``perfbench/reference.py``) on the same weights and events: the widest
gap of a class probability against the configuration's limit.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from perfbench import run, spec


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


def check_config(cfg: Mapping, traffic: Optional[Mapping] = None) -> None:
    """The configuration's file against the program's registry and, with
    ``traffic``, the events its generator makes."""
    from repro_torch.registry import get_config

    from perfbench.generators import GENERATORS

    check_sizes(get_config(cfg["arch"]), cfg)
    if traffic is not None:
        x = GENERATORS[traffic["generator"]](3, np.random.default_rng(1))
        if x.shape != (3, cfg["seq_len"], cfg["input_size"]) or \
                x.dtype != np.float32:
            raise ValueError(f"{traffic['generator']} makes {x.dtype} "
                             f"events {x.shape[1:]}, {cfg['arch']} takes "
                             f"float32 ({cfg['seq_len']}, "
                             f"{cfg['input_size']})")


def make_pool(cell: spec.Cell, seed: int) -> np.ndarray:
    """[calls in the pool, events a call, T, in], drawn from the seed."""
    from perfbench.generators import GENERATORS

    cfg, t = cell.cfg, cell.traffic
    rows = t["events_per_call"]
    n = t["pool_events"] // rows * rows
    x = GENERATORS[t["generator"]](n, np.random.default_rng(seed))
    if x.shape[1:] != (cfg["seq_len"], cfg["input_size"]):
        raise ValueError(f"{t['generator']} makes events {x.shape[1:]}, "
                         f"{cfg['arch']} takes ({cfg['seq_len']}, "
                         f"{cfg['input_size']})")
    return x.reshape(n // rows, rows, *x.shape[1:])


def build(cell: spec.Cell, seed: int, device, stamps: Dict[str, float],
          entry: Callable) -> run.Bench:
    """Weights, events and the engine, warmed at the traffic's shape;
    ``entry(engine)`` is the call on one pool item."""
    import torch

    from perfbench.reference import make_weights
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.registry import get_config
    from repro_torch.serving.engine import RNNServingEngine

    stamps["program"] = time.perf_counter() - run.T0
    cfg, traffic = cell.cfg, cell.traffic
    if cfg.get("fp") is not None:
        raise ValueError("fixed-point configurations are not run yet")
    model_cfg = get_config(cfg["arch"])
    check_sizes(model_cfg, cfg)
    weights = make_weights(cfg, seed, device)
    stamps["weights"] = time.perf_counter() - run.T0
    pool = make_pool(cell, seed)
    stamps["events"] = time.perf_counter() - run.T0
    engine = RNNServingEngine(
        model_cfg, {k: v.clone() for k, v in weights.items()},
        schedule=KernelSchedule(**cfg["schedule"]), device=device,
        cache_dir=str(run.CACHE_DIR) if device.type == "cuda" else None)
    call = entry(engine)
    stamps["engine"] = time.perf_counter() - run.T0
    for i in range(traffic["warmup_calls"]):
        call(pool[i % len(pool)])
        if not i:
            stamps["first_call"] = time.perf_counter() - run.T0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps["warm"] = time.perf_counter() - run.T0
    return run.Bench(cell, weights, pool, engine, call, stamps)


def compare(bench: run.Bench, kept, answer: Optional[Callable] = None
            ) -> Dict:
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


def control(cell: spec.Cell, seed: int, device) -> Dict:
    """The control's checks: the reference computed with TF32 products,
    the precision below the configurations' float32, in the program's
    place on the seed's weights and the calls a run compares."""
    import torch

    from perfbench.reference import (make_weights, matmul_precision,
                                     tagger_blocks)

    cfg = cell.cfg
    weights = make_weights(cfg, seed, device)
    pool = make_pool(cell, seed)
    bench = run.Bench(cell, weights, pool, None, None, {})
    n = len(pool)
    kept = [(j % n, None) for j in range(cell.traffic["check_calls"])]

    def tf32(x):
        with matmul_precision(True):
            return tagger_blocks(cfg, weights, x)

    with torch.inference_mode():
        return compare(bench, kept, answer=tf32)
