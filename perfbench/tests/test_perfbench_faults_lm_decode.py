"""The LM decode entry's check with the program's timed path broken
underneath: a run on the CPU, handed a tiny configuration of the same
model (one whole period of granite-4.0-h-micro's layers: attention at
index 5, d 64, the published scalars, bfloat16) and a tiny traffic mix,
comes out correct, and not correct for each fault: the SSM state not
carried across ticks, the new K / V entry not written, the residual
multiplier left out.  A tick that raises is counted under ``failed``.

The tiny model's limits are its own, set as the published ones are.
``logit_gap_max``: sound runs read 0.021-0.028 (4 seeds), the faults
0.090 (state), 0.25 (K / V) and 1.18 (residual), so its limit sits 2x
above the first and 1.5x below the least of the second.
``ssm_state_gap``: sound runs read 0.0086-0.0109, the state not carried
1.0 (the slot's state stays at its zeros), so its limit sits 2.8x above
the first and 33x below the second."""

import dataclasses
import json

import pytest
import torch

from perfbench import run, spec
from repro_torch.models import decode
from repro_torch.models import layers
from repro_torch.serving.lm_engine import LMServingEngine

#: the traffic entries whose cells these faults break
ENTRIES = ("lm_decode",)
CELL = "granite-4.0-h-micro.decode"
#: one whole period of the published layer pattern at a CPU's size
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "shared_intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 1, "mamba_n_heads": 8, "mamba_d_head": 16,
        "mamba_d_state": 16, "mamba_chunk_size": 8, "vocab_size": 256,
        "num_hidden_layers": 10}
TINY_LIMITS = {"logit_gap_max": 0.06, "ssm_state_gap": 0.03}
TRAFFIC = {"events_per_call": 4, "slots": 4, "max_seq": 64,
           "prompt_tokens": {"median": 8, "sigma": 1.0, "min": 2,
                             "max": 24},
           "output_tokens": {"median": 6, "sigma": 0.8, "min": 2,
                             "max": 24},
           "pool_events": 32, "warmup_calls": 2, "check_calls": 4}


@pytest.fixture
def cell(tmp_path):
    full = spec.resolve(CELL)
    cfg = dict(full.cfg, **TINY, check=TINY_LIMITS)
    cfg["layer_types"] = cfg["layer_types"][:10]
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    small = spec.make_cell(CELL, full.workload, path, full.workload[
        "traffic"], full.end_to_end)
    return dataclasses.replace(small, traffic=dict(small.traffic, **TRAFFIC))


def one_run(cell):
    return run.run_cell(cell, 2**31 + 99, 0.5, False, torch.device("cpu"))


def test_sound_run_is_correct(cell):
    r = one_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > TRAFFIC["check_calls"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}


def state_not_carried(monkeypatch):
    """Each Mamba-2 step hands back the state it was given."""
    step = decode.ssm_decode_step

    def dropped(cfg, x, p, prefix, state, conv):
        out, (_, new_conv) = step(cfg, x, p, prefix, state, conv)
        return out, (state, new_conv)
    monkeypatch.setattr(decode, "ssm_decode_step", dropped)


def kv_not_written(monkeypatch):
    """The new K / V entry is never written into the cache."""
    monkeypatch.setattr(decode, "_update_cache", lambda c, new, pos: c)


def residual_unscaled(monkeypatch):
    """Each sublayer joins the residual without Granite's multiplier."""
    monkeypatch.setattr(decode, "residual_scale", lambda cfg, h: h)


#: each fault, and the check that has to see it
FAULTS = {"state_not_carried": (state_not_carried, "ssm_state_gap"),
          "kv_not_written": (kv_not_written, "logit_gap_max"),
          "residual_unscaled": (residual_unscaled, "logit_gap_max")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    breaks, check = FAULTS[fault]
    breaks(monkeypatch)
    r = one_run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_a_raising_tick_is_counted(cell, monkeypatch):
    tick, calls = LMServingEngine.tick, []

    def flaky(self, *a, **kw):
        calls.append(1)
        if len(calls) > TRAFFIC["warmup_calls"] and len(calls) % 3 == 0:
            raise RuntimeError("the card went away")
        return tick(self, *a, **kw)
    monkeypatch.setattr(LMServingEngine, "tick", flaky)
    r = one_run(cell)
    assert r["failed"] > 0 and not r["correct"]


def test_the_residual_fault_reaches_the_program():
    """``decode`` scales through the name the fault patches."""
    assert decode.residual_scale is layers.residual_scale
