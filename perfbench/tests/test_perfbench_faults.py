"""The comparison that decides ``correct``, with the program's timed path
broken underneath: a run without the harness's look for a card, on the
CPU at a size a test holds (chunks of 16 events), must come out not
correct for each fault a cell can have, and correct without one.  (One
card: there is no exchange between cards to leave out.)

These are the taggers' faults: they run on the cells whose traffic entry
is in ``ENTRIES``.  Another entry brings its faults in a module of its
own, ``test_perfbench_faults_<entry>.py`` or any ``test_*.py`` here, with
the ``ENTRIES`` it covers; ``test_every_entry_has_its_faults`` holds
every cell to one."""

import ast
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import run, spec
from repro_torch.models import rnn_tagger
from repro_torch.serving.engine import RNNServingEngine

#: the traffic entries whose cells these faults break
ENTRIES = ("predict", "predict_one")
#: the cells measured and left out for their spread (PERF.md §7): their
#: entries (``predict_one``, the non-static schedule) stay tested
OFF_BENCHMARK = {
    "flavor-tagging-gru.bulk": ("flavor-tagging-gru", "tracks-8192"),
    "quickdraw-lstm.trigger": ("quickdraw-lstm", "strokes-one"),
    "quickdraw-lstm.bulk-nonstatic": ("quickdraw-lstm-nonstatic",
                                      "strokes-2048")}


def cell_of(name):
    if name in OFF_BENCHMARK:
        config, traffic = OFF_BENCHMARK[name]
        return spec.make_cell(name, {"chips": 1},
                              spec.HERE / "configs" / f"{config}.json",
                              traffic)
    return spec.resolve(name)


CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]
         if cell_of(w["name"]).traffic["entry"] in ENTRIES]


def small(name):
    cell = cell_of(name)
    t = dict(cell.traffic)
    if t["events_per_call"] > 1:
        t.update(events_per_call=16, pool_events=64, check_calls=2)
    else:
        t.update(pool_events=16, check_calls=8)
    return dataclasses.replace(cell, traffic=t)


def state_unchanged(monkeypatch):
    """The scan returns its initial state: no step moves h."""
    def frozen(rnn, x, *args, **kw):
        return torch.zeros(x.shape[0], rnn.hidden, dtype=x.dtype)
    monkeypatch.setattr(rnn_tagger, "rnn_layer", frozen)


def half_batch(monkeypatch):
    """Half of each chunk left out, the rest answered by the mean of the
    answered half."""
    predict = RNNServingEngine.predict

    def halved(self, x, *a, **kw):
        out = predict(self, x[: len(x) // 2], *a, **kw)
        rest = np.repeat(out.mean(0, keepdims=True), len(x) - len(out), 0)
        return np.concatenate([out, rest])
    monkeypatch.setattr(RNNServingEngine, "predict", halved)


def answer_altered(monkeypatch):
    """One answer of every call altered where the model produces it: the
    first event's classes reversed."""
    forward = rnn_tagger.RNNTagger.forward

    def altered(self, x, **kw):
        out = forward(self, x, **kw).clone()
        out[0] = out[0].flip(0)
        return out
    monkeypatch.setattr(rnn_tagger.RNNTagger, "forward", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


def one_run(name):
    return run.run_cell(small(name), 2**31 + 99, 0.3, False,
                        torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS + sorted(OFF_BENCHMARK))
def test_sound_run_is_correct(name):
    r = one_run(name)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 cell_of(name).end_to_end}


CASES = [(name, fault) for name in CELLS + sorted(OFF_BENCHMARK)
         for fault in sorted(FAULTS)
         # a single-event call has no half to leave out
         if not (fault == "half_batch"
                 and cell_of(name).traffic["entry"] != "predict")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = one_run(name)
    assert not r["correct"], r["checks"]


def test_failed_calls_are_counted(monkeypatch):
    """A call of the window that raises is counted as failed, and the run
    is not correct."""
    predict = RNNServingEngine.predict
    calls = []

    def flaky(self, x, *a, **kw):
        calls.append(1)
        if len(calls) > 3 and len(calls) % 2:
            raise RuntimeError("the card went away")
        return predict(self, x, *a, **kw)
    monkeypatch.setattr(RNNServingEngine, "predict", flaky)
    r = one_run("quickdraw-lstm.bulk")
    assert r["failed"] > 0 and not r["correct"]


def test_every_entry_has_its_faults():
    """Each cell's traffic entry is named in the ``ENTRIES`` of some test
    module here, which breaks its timed path."""
    covered = set()
    for path in spec.HERE.joinpath("tests").glob("test_*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "ENTRIES"
                    for t in node.targets):
                covered |= set(ast.literal_eval(node.value))
    entries = {cell_of(name).traffic["entry"] for name in
               [w["name"] for w in spec.load_benchmark()["workloads"]]
               + sorted(OFF_BENCHMARK)}
    assert entries <= covered, sorted(entries - covered)
