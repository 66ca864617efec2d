"""BENCHMARK.json against the benchmark's contract, and every cell's data
files found by name."""

import json
import re

import numpy as np
import pytest

from perfbench import spec
from perfbench.generators import GENERATORS

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # a metric's cells report the end-to-end metric it moves
        for w in m.get("workloads", CELLS):
            assert spec.reports(e2e[m["moves"]], w)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert spec.metric_file(m["name"]).exists()


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.resolve(name)
    w = cell.workload
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    t = cell.traffic
    assert (t["loop"], t["clients"], t["think_ms"]) == ("closed", 1, 0)
    assert t["events_per_call"] >= 1 and t["check_calls"] >= 1
    assert t["pool_events"] >= t["events_per_call"]
    # the entry's own look: the tagger's checks that the traffic's
    # generator makes float32 events of the configuration's shape
    spec.entry(t["entry"]).check_config(cell.cfg, t)


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cells = [spec.resolve(w["name"]) for w in BENCH["workloads"]
                 if w["config"] == c["name"]]
        assert cells
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        # every cut is named, by a key of the configuration's file
        assert isinstance(c["reduced"], list)
        assert set(c["reduced"]) <= set(cfg), c["reduced"]
        for cell in cells:
            spec.entry(cell.traffic["entry"]).check_config(cfg)
        assert cfg["check"] and all(lim > 0 for lim in
                                    cfg["check"].values())


def test_entries_found_by_name():
    names = spec.entry_names()
    assert {"predict", "predict_one"} <= set(names)
    assert not any(n.startswith("_") for n in names)
    for name in names:
        mod = spec.entry(name)
        for fn in ("build", "compare", "check_config"):
            assert callable(getattr(mod, fn)), (name, fn)
    assert {w["traffic"] for w in BENCH["workloads"]} <= \
        {p.stem for p in spec.TRAFFIC.glob("*.json")}
    for path in spec.TRAFFIC.glob("*.json"):
        assert json.loads(path.read_text())["entry"] in names, path


@pytest.mark.parametrize("name", ["_tagger", "predict_many"])
def test_unknown_entry_names_those_there_are(name):
    with pytest.raises(KeyError, match="predict_one"):
        spec.entry(name)


def test_generators_are_seeded():
    for gen in GENERATORS.values():
        a = gen(5, np.random.default_rng(2**31 + 3))
        b = gen(5, np.random.default_rng(2**31 + 3))
        c = gen(5, np.random.default_rng(2**31 + 4))
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        assert np.isfinite(a).all()
