"""``predict`` on chunks of ``events_per_call`` events: a tagger's bulk
entry (``entries/_tagger.py``)."""

from perfbench.entries import _tagger
from perfbench.entries._tagger import (  # noqa: F401
    check_config, compare, control)


def build(cell, seed, device, stamps):
    return _tagger.build(cell, seed, device, stamps,
                         lambda engine: engine.predict)
