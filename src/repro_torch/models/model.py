"""Unified model facade: one object per architecture with its parameter
specs, seeded initialisation, training loss and forward pass, dispatched by
config family.

The port of ``repro/models/model.py``: the taggers (``rnn``) and every LM
family (dense, moe, ssm, hybrid, audio enc-dec, vlm).  An LM's ``loss``
and ``forward`` run ``transformer.forward`` over the whole sequence
(``batch``: ``tokens``, ``labels`` for the loss, and the frontend stubs'
``frame_embeds`` / ``img_embeds`` where the family needs them); its
single-step decode is ``models/decode.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import rnn_tagger, transformer
from repro_torch.models.init import (ParamSpecs, abstract_params, init_params,
                                     param_bytes)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def param_specs(self) -> ParamSpecs:
        if self.cfg.family == "rnn":
            return rnn_tagger.param_specs(self.cfg)
        return transformer.param_specs(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             device: Union[str, torch.device] = "cuda",
             place: Optional[Callable] = None) -> Dict:
        """Seeded parameters on ``device``, drawn from ``generator`` (seed 0
        on ``device`` when none is given: a full-width LM is drawn on the
        card, not copied there); ``place(path, tensor)`` maps each as it is
        drawn (``init_params``)."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return init_params(self.param_specs(), generator, device, place)

    def abstract_params(self, ctx=None) -> Dict:
        """Meta-device stand-ins of the parameters (DTensors under a
        context on a ``DeviceMesh``): the dry run's, with no allocation."""
        return abstract_params(self.param_specs(), ctx)

    def param_bytes(self) -> int:
        return param_bytes(self.param_specs())

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """The training loss of ``batch`` and its metrics: a tagger's
        (``{"x", "y"}``), or an LM's ``lm_loss`` of ``batch["labels"]``
        plus, for the moe family, the weighted load-balance and router
        z-losses (their values among the metrics)."""
        cfg = self.cfg
        if cfg.family == "rnn":
            return rnn_tagger.loss_fn(cfg, params, batch["x"], batch["y"])
        hidden, aux = self._hidden(params, batch, train=True)
        loss, metrics = transformer.lm_loss(cfg, params, hidden,
                                            batch["labels"])
        if "moe_load_balance" in aux:
            m = cfg.moe
            loss = (loss + m.aux_loss_weight * aux["moe_load_balance"]
                    + m.router_z_loss * aux["moe_z_loss"])
            metrics.update(aux)
        return loss, metrics

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        """A tagger's class probabilities of ``batch["x"]`` on the
        reference path, or an LM's logits [b, s, padded vocab] over the
        whole sequence (vlm: the image patches' positions first)."""
        cfg = self.cfg
        if cfg.family == "rnn":
            return rnn_tagger.forward(cfg, params, batch["x"])
        hidden, _ = self._hidden(params, batch, train=False)
        return transformer.logits_fn(cfg, params, hidden)

    def _hidden(self, params, batch, train):
        return transformer.forward(
            self.cfg, params, batch["tokens"], train=train,
            img_embeds=batch.get("img_embeds"),
            frame_embeds=batch.get("frame_embeds"))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "rnn":
        transformer.require_lm(cfg, "build_model")
    return Model(cfg)
