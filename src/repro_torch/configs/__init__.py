"""The paper's three taggers, each as LSTM and GRU."""

from repro_torch.configs import flavor_tagging, quickdraw, top_tagging

#: config name -> config factory, for the six (config x cell) taggers
TAGGERS = {
    cfg().name: cfg
    for mod in (top_tagging, flavor_tagging, quickdraw)
    for cfg in (mod.lstm_config, mod.gru_config)
}


def get_config(name: str):
    """The tagger config named ``name`` (e.g. ``"quickdraw-gru"``)."""
    try:
        return TAGGERS[name]()
    except KeyError:
        raise KeyError(f"unknown tagger {name!r}; known: {sorted(TAGGERS)}")
