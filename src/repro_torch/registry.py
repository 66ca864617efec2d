"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port's copy of ``repro.registry``, under the same arch ids: the ten
LMs (dense, moe, ssm, hybrid, audio enc-dec and vlm) and the paper's six
taggers; and the port's own architectures (:data:`PORT_ONLY_ARCHS`),
which ``repro`` does not have.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# arch id -> module under repro_torch.configs
ARCHS: Dict[str, str] = {
    # assigned pool (10)
    "gemma-2b": "gemma_2b",
    "nemotron-4-340b": "nemotron_4_340b",
    "stablelm-3b": "stablelm_3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mamba2-780m": "mamba2_780m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    # the paper's own benchmarks (3 x {lstm,gru})
    "top-tagging-lstm": "top_tagging",
    "top-tagging-gru": "top_tagging",
    "flavor-tagging-lstm": "flavor_tagging",
    "flavor-tagging-gru": "flavor_tagging",
    "quickdraw-lstm": "quickdraw",
    "quickdraw-gru": "quickdraw",
    # the port's own (no repro counterpart)
    "granite-4.0-h-micro": "granite_4_0_h_micro",
}

#: arch ids the port has and ``repro`` does not
PORT_ONLY_ARCHS = ("granite-4.0-h-micro",)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    if name.endswith("-lstm"):
        return mod.lstm_config()
    if name.endswith("-gru"):
        return mod.gru_config()
    return mod.CONFIG


def list_archs() -> List[str]:
    return sorted(ARCHS)


ASSIGNED_ARCHS = [
    "gemma-2b",
    "nemotron-4-340b",
    "stablelm-3b",
    "deepseek-coder-33b",
    "mamba2-780m",
    "qwen2-moe-a2.7b",
    "qwen3-moe-30b-a3b",
    "recurrentgemma-9b",
    "whisper-medium",
    "phi-3-vision-4.2b",
]
