"""The paper's three taggers, each as LSTM and GRU, and the ten LMs whose
decode the port serves: dense (gemma-2b, stablelm-3b, deepseek-coder-33b,
nemotron-4-340b), moe (qwen2-moe-a2.7b, qwen3-moe-30b-a3b), ssm
(mamba2-780m), hybrid (recurrentgemma-9b), audio enc-dec (whisper-medium)
and vlm (phi-3-vision-4.2b).  Configs are looked up by arch id through
:func:`repro_torch.registry.get_config`, which this package re-exports."""

from repro_torch.configs import (deepseek_coder_33b, flavor_tagging,
                                 gemma_2b, mamba2_780m, nemotron_4_340b,
                                 phi_3_vision_4_2b, quickdraw,
                                 qwen2_moe_a2_7b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, stablelm_3b,
                                 top_tagging, whisper_medium)
from repro_torch.registry import get_config  # noqa: F401

#: config name -> config factory, for the six (config x cell) taggers
TAGGERS = {
    cfg().name: cfg
    for mod in (top_tagging, flavor_tagging, quickdraw)
    for cfg in (mod.lstm_config, mod.gru_config)
}

#: config name -> config, for the ten LMs
LMS = {mod.CONFIG.name: mod.CONFIG
       for mod in (gemma_2b, stablelm_3b, deepseek_coder_33b, nemotron_4_340b,
                   qwen2_moe_a2_7b, qwen3_moe_30b_a3b, mamba2_780m,
                   recurrentgemma_9b, whisper_medium, phi_3_vision_4_2b)}
