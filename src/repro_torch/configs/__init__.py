"""The paper's three taggers, each as LSTM and GRU, and the dense LMs whose
single-step decode the port serves (gemma-2b, stablelm-3b)."""

from repro_torch.configs import (flavor_tagging, gemma_2b, quickdraw,
                                 stablelm_3b, top_tagging)

#: config name -> config factory, for the six (config x cell) taggers
TAGGERS = {
    cfg().name: cfg
    for mod in (top_tagging, flavor_tagging, quickdraw)
    for cfg in (mod.lstm_config, mod.gru_config)
}

#: config name -> config, for the dense decoder LMs
LMS = {mod.CONFIG.name: mod.CONFIG for mod in (gemma_2b, stablelm_3b)}


def get_config(name: str):
    """The config named ``name`` (e.g. ``"quickdraw-gru"``, ``"gemma-2b"``)."""
    if name in LMS:
        return LMS[name]
    try:
        return TAGGERS[name]()
    except KeyError:
        raise KeyError(f"unknown config {name!r}; known: "
                       f"{sorted(TAGGERS) + sorted(LMS)}")
