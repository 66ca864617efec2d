"""Unified model facade: one object per architecture with its parameter
specs, seeded initialisation, training loss and forward pass, dispatched by
config family.

The port of ``repro/models/model.py``: the taggers (``rnn``) and every LM
family (dense, moe, ssm, hybrid, audio enc-dec, vlm), whose parameters
and seeded initialisation serve ``models/decode.py``.  An LM's ``loss``
and ``forward`` raise ``NotImplementedError`` naming ``ROADMAP.md`` module
item 10's prefill: the port has the single-step decode, not
``transformer.forward`` over a whole sequence or ``lm_loss``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import rnn_tagger, transformer
from repro_torch.models.init import ParamSpecs, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def param_specs(self) -> ParamSpecs:
        if self.cfg.family == "rnn":
            return rnn_tagger.param_specs(self.cfg)
        return transformer.param_specs(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             device: Union[str, torch.device] = "cuda") -> Dict:
        """Seeded parameters on ``device``, drawn from ``generator`` (seed 0
        on ``device`` when none is given: a full-width LM is drawn on the
        card, not copied there)."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return init_params(self.param_specs(), generator, device)

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """The training loss of ``batch`` (``{"x", "y"}``) and its metrics."""
        self._require_rnn("loss")
        return rnn_tagger.loss_fn(self.cfg, params, batch["x"], batch["y"])

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Class probabilities of ``batch["x"]`` on the reference path."""
        self._require_rnn("forward")
        return rnn_tagger.forward(self.cfg, params, batch["x"])

    def _require_rnn(self, what: str) -> None:
        if self.cfg.family != "rnn":
            raise NotImplementedError(
                f"Model.{what} of {self.cfg.name!r} ({self.cfg.family}): the "
                f"port has no sequence forward (prefill) or lm_loss for the "
                f"LM yet (ROADMAP.md module item 10, prefill and the "
                f"training forward pass); it serves the LM by decode")


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "rnn":
        transformer.require_lm(cfg, "build_model")
    return Model(cfg)
