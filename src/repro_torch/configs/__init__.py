"""The paper's three taggers, each as LSTM and GRU, and the dense LMs whose
decode the port serves (gemma-2b, stablelm-3b, deepseek-coder-33b,
nemotron-4-340b).  Configs are looked up by arch id through
:func:`repro_torch.registry.get_config`, which this package re-exports."""

from repro_torch.configs import (deepseek_coder_33b, flavor_tagging,
                                 gemma_2b, nemotron_4_340b, quickdraw,
                                 stablelm_3b, top_tagging)
from repro_torch.registry import get_config  # noqa: F401

#: config name -> config factory, for the six (config x cell) taggers
TAGGERS = {
    cfg().name: cfg
    for mod in (top_tagging, flavor_tagging, quickdraw)
    for cfg in (mod.lstm_config, mod.gru_config)
}

#: config name -> config, for the dense decoder LMs
LMS = {mod.CONFIG.name: mod.CONFIG
       for mod in (gemma_2b, stablelm_3b, deepseek_coder_33b, nemotron_4_340b)}
