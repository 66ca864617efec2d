"""``predict_one`` on one event a call: a tagger's trigger entry
(``entries/_tagger.py``).  A pool item holds one event; its answer comes
back as one row."""

from perfbench.entries import _tagger
from perfbench.entries._tagger import (  # noqa: F401
    check_config, compare, control)


def one_event(engine):
    def call(x, one=engine.predict_one):
        return one(x[0])[None]
    return call


def build(cell, seed, device, stamps):
    return _tagger.build(cell, seed, device, stamps, one_event)
