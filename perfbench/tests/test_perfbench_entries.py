"""A traffic entry is one module found by name: a toy entry, with its
configuration and traffic mix, written to a directory of its own, runs
through ``run.run_cell`` as a cell does; and the taggers' entries give,
bit for bit, the pool, the weights and the readings that the harness gave
before they moved into ``perfbench/entries/``."""

import dataclasses
import hashlib
import json
import textwrap

import pytest
import torch

from perfbench import run, spec

TOY_ENTRY = '''
"""A toy entry: each call multiplies a chunk of rows by a seeded matrix
in float32; the check holds the sampled answers to float64."""

import time

import numpy as np
import torch

from perfbench import run


def forward(w, x):
    return x @ w


def check_config(cfg, traffic=None):
    if cfg["arch"] != "toy-matmul":
        raise ValueError(cfg["arch"])


def build(cell, seed, device, stamps):
    d, t = cell.cfg["width"], cell.traffic
    rows = t["events_per_call"]
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(d, d, generator=gen, device=device)
    pool = np.random.default_rng(seed).standard_normal(
        (t["pool_events"] // rows, rows, d), dtype=np.float32)

    def call(x):
        return forward(w, torch.from_numpy(x).to(device)).cpu().numpy()

    for i in range(t["warmup_calls"]):
        call(pool[i % len(pool)])
    stamps["warm"] = time.perf_counter() - run.T0
    return run.Bench(cell, {"w": w}, pool, None, call, stamps)


def compare(bench, kept, answer=None):
    x = bench.pool[[i for i, _ in kept]]
    ref = x.astype(np.float64) @ bench.weights["w"].double().cpu().numpy()
    outs = [o for _, o in kept]
    bad = sum(o is None or np.shape(o) != x.shape[1:] for o in outs)
    if bad:
        return {"answers_missing": [bad, 0]}
    gap = np.abs(np.stack(outs) - ref).max()
    return {"answers_missing": [0, 0],
            "out_gap_max": [float(gap),
                            bench.cell.cfg["check"]["out_gap_max"]]}
'''
TOY_CONFIG = {"arch": "toy-matmul", "width": 8, "dtype": "float32",
              "reduced": [], "check": {"out_gap_max": 1e-4}}
TOY_TRAFFIC = {"entry": "toy", "events_per_call": 16, "loop": "closed",
               "clients": 1, "think_ms": 0, "pool_events": 64,
               "warmup_calls": 2, "check_calls": 3}
E2E = [m for m in spec.load_benchmark()["end_to_end"]
       if m["name"] in ("events_per_s", "chunk_latency_p95_ms", "setup_s")]


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy cell, its files under ``tmp_path``, and its entry module."""
    for sub in ("configs", "traffic", "entries"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    (tmp_path / "traffic" / "toy-rows.json").write_text(
        json.dumps(TOY_TRAFFIC))
    (tmp_path / "entries" / "toy.py").write_text(textwrap.dedent(TOY_ENTRY))
    monkeypatch.setattr(spec, "TRAFFIC", tmp_path / "traffic")
    monkeypatch.setattr(spec, "ENTRIES", tmp_path / "entries")
    cell = spec.make_cell("toy.rows", {"chips": 1},
                          tmp_path / "configs" / "toy.json", "toy-rows", E2E)
    return cell, spec.entry("toy")


def toy_run(cell):
    return run.run_cell(cell, 2**31 + 7, 0.3, False, torch.device("cpu"))


def test_a_toy_entry_runs_as_a_cell(toy):
    cell, mod = toy
    assert spec.entry_names() == ["toy"]
    mod.check_config(cell.cfg, cell.traffic)
    r = toy_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"events_per_s", "chunk_latency_p95_ms",
                                 "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["out_gap_max"]["limit"] == 1e-4


def test_a_faulted_toy_is_not_correct(toy, monkeypatch):
    cell, mod = toy
    forward = mod.forward
    monkeypatch.setattr(mod, "forward", lambda w, x: forward(w, x) * 1.01)
    r = toy_run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["out_gap_max"]["value"] > 1e-4


def test_a_toy_call_that_raises_is_counted(toy, monkeypatch):
    cell, mod = toy
    forward, calls = mod.forward, []

    def flaky(w, x):
        calls.append(1)
        if len(calls) > TOY_TRAFFIC["warmup_calls"] and len(calls) % 3 == 0:
            raise RuntimeError("the toy failed")
        return forward(w, x)
    monkeypatch.setattr(mod, "forward", flaky)
    r = toy_run(cell)
    assert r["failed"] > 0 and not r["correct"]


#: ``quickdraw-lstm.bulk`` at the faults tests' size (chunks of 16 events,
#: a pool of 4, 2 calls compared), seed 2**31 + 99, on the CPU, as the
#: harness gave them before the taggers moved into ``entries/``: sha256
#: of the pool's bytes, of the weights' bytes (keys in sorted order, each
#: key's name then its bytes), and ``compare``'s readings after one build
#: and 2 calls
PINNED = {
    "pool":
        "0e91d7e523650177bc4abaca6c0c2bc0571dcd30f8e1e702eb2d3abdf67bb992",
    "weights":
        "b9efe9a098e18ab1dae559fa0186e759f7955768cd7a72869a79b524497b5f9d",
    "checks": {"answers_missing": [0, 0], "nonfinite_rows": [0, 0],
               "prob_gap_max": [5.960464477539063e-08, 4e-06]},
}


def test_the_tagger_entry_reproduces_the_pinned_digests():
    cell = spec.resolve("quickdraw-lstm.bulk")
    t = dict(cell.traffic, events_per_call=16, pool_events=64,
             check_calls=2)
    bench = run.build(dataclasses.replace(cell, traffic=t), 2**31 + 99,
                      torch.device("cpu"))
    assert bench.pool.shape == (4, 16, 100, 3)
    assert hashlib.sha256(bench.pool.tobytes()).hexdigest() == \
        PINNED["pool"]
    h = hashlib.sha256()
    for k in sorted(bench.weights):
        h.update(k.encode())
        h.update(bench.weights[k].cpu().numpy().tobytes())
    assert h.hexdigest() == PINNED["weights"]
    n = len(bench.pool)
    kept = [(j % n, bench.call(bench.pool[j % n])) for j in range(2)]
    assert run.compare(bench, kept) == PINNED["checks"]
