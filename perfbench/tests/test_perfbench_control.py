"""The control on the card: the reference computed with TF32 products (the
precision below the configurations' float32), put in the program's place,
fails the comparison that the program passes.  At 256 events a call, a
size a test holds; the full-size readings come from
``perfbench/readings.py``."""

import dataclasses

import pytest

from perfbench import readings, spec

CONFIGS = {"quickdraw-lstm": "strokes-2048",
           "flavor-tagging-gru": "tracks-8192",
           "quickdraw-lstm-nonstatic": "strokes-2048"}


def at_256(config):
    cell = spec.make_cell(config, {"chips": 1},
                          spec.HERE / "configs" / f"{config}.json",
                          CONFIGS[config])
    t = dict(cell.traffic, events_per_call=256, pool_events=1024,
             check_calls=4)
    return dataclasses.replace(cell, traffic=t)


@pytest.mark.card
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_where_the_program_passes(card, config, seed):
    cell = at_256(config)
    program, _ = readings.program_reading(cell, seed, card)
    control = readings.control_reading(cell, seed, card)
    gap, limit = program["prob_gap_max"]
    assert gap <= limit
    gap, limit = control["prob_gap_max"]
    assert gap > limit
