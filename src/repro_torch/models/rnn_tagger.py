"""The paper's benchmark models: RNN (LSTM/GRU) + dense head classifiers.

Top tagging:    [b, 20, 6]  -> LSTM/GRU(20)  -> Dense(64, ReLU) -> sigmoid(1)
Flavor tagging: [b, 15, 6]  -> LSTM/GRU(120) -> Dense(50) -> Dense(10) -> softmax(3)
QuickDraw:      [b, 100, 3] -> LSTM/GRU(128) -> Dense(256) -> Dense(128) -> softmax(5)

Parameters keep the JAX package's flat layout and names
(``rnn/kernel`` [in, G*h], ``rnn/recurrent`` [h, G*h], ``rnn/bias`` [G*h]
or [2, 3h] for the GRU, ``dense{i}/w`` [in, out], ``dense{i}/b``,
``head/w``, ``head/b``), so both packages compute the same function on the
same weights.  :func:`forward` and :func:`loss_fn` take such a mapping of
tensors (the trainer differentiates through them); :class:`RNNTagger` holds
frozen float32 weights for serving and calls :func:`forward` on them.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import tracing
from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.core.quant.fixed_point import is_native_int, quantize
from repro_torch.core.rnn.cells import rnn_param_specs
from repro_torch.core.rnn.layer import rnn_layer
from repro_torch.kernels.ref import matmul, sigmoid
from repro_torch.kernels.reuse_matmul import col_matmul_kernel
from repro_torch.models.init import ParamSpec, ParamSpecs, Params, init_params

Device = Union[str, torch.device]


def param_specs(cfg: ModelConfig) -> ParamSpecs:
    rnn = cfg.rnn
    if rnn is None:
        raise ValueError(f"{cfg.name} has no rnn config")
    specs = dict(rnn_param_specs(rnn, "rnn"))
    prev = rnn.hidden
    for i, width in enumerate(rnn.dense_sizes):
        specs[f"dense{i}/w"] = ParamSpec((prev, width), "lecun",
                                         logical_axes=(None, None))
        specs[f"dense{i}/b"] = ParamSpec((width,), "zeros",
                                         logical_axes=(None,))
        prev = width
    specs["head/w"] = ParamSpec((prev, rnn.n_outputs), "lecun",
                                logical_axes=(None, None))
    specs["head/b"] = ParamSpec((rnn.n_outputs,), "zeros",
                                logical_axes=(None,))
    return specs


def params_from_jax(params: Mapping[str, object],
                    device: Device = "cuda") -> Params:
    """The JAX package's flat tagger parameters (``{"rnn/kernel": ...,
    "dense0/w": ...}``, numpy or JAX arrays) as float32 tensors on
    ``device``, layout unchanged: ``[in, out]`` matrices, Keras gate order
    i|f|c|o (LSTM) and z|r|hh (GRU), GRU bias ``[2, 3h]``."""
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
           for k, v in params.items()}
    W, U, b = (out.get(f"rnn/{n}") for n in ("kernel", "recurrent", "bias"))
    if W is None or U is None or b is None:
        raise KeyError(f"not tagger parameters: {sorted(out)}")
    h = U.shape[0]
    gates = U.shape[1] // h if h else 0
    if (gates not in (3, 4) or U.shape[1] != gates * h
            or W.shape[1] != gates * h
            or b.shape != ((4 * h,) if gates == 4 else (2, 3 * h))):
        raise ValueError(
            f"rnn parameters do not have the Keras layout: kernel "
            f"{tuple(W.shape)}, recurrent {tuple(U.shape)}, bias "
            f"{tuple(b.shape)}")
    return out


class RNNTagger(nn.Module):
    """One tagger: the recurrent layer and its dense head.

    ``params`` is a flat mapping in the layout of :func:`param_specs`
    (tensors or numpy arrays); without it the weights are drawn from
    ``generator`` (seed 0 when none is given).  The weights are held as
    float32 tensors on ``device`` from construction on.
    """

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Mapping[str, object]] = None, *,
                 device: Device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        specs = param_specs(cfg)
        if params is None:
            params = init_params(specs, generator or
                                 torch.Generator().manual_seed(0), "cpu")
        if set(params) != set(specs):
            raise KeyError(f"{cfg.name}: parameters {sorted(params)} do not "
                           f"match {sorted(specs)}")
        self.weights = nn.ParameterDict()
        for path, spec in specs.items():
            t = torch.as_tensor(params[path], dtype=torch.float32,
                                device=device)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{cfg.name}: {path} has shape "
                                 f"{tuple(t.shape)}, expected {spec.shape}")
            self.weights[path] = nn.Parameter(t.contiguous(),
                                              requires_grad=False)

    def forward(self, x: torch.Tensor, *,
                fp: Optional[FixedPointConfig] = None,
                mode: Optional[str] = None, impl: str = "xla",
                schedule=None, lengths=None,
                return_logits: bool = False) -> torch.Tensor:
        """:func:`forward` on this tagger's weights."""
        return forward(self.cfg, self.weights, x, fp=fp, mode=mode,
                       impl=impl, schedule=schedule, lengths=lengths,
                       return_logits=return_logits)


def forward(
    cfg: ModelConfig,
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                     # [b, T, features]
    *,
    fp: Optional[FixedPointConfig] = None,
    mode: Optional[str] = None,
    impl: str = "xla",
    schedule=None,
    lengths=None,
    return_logits: bool = False,
) -> torch.Tensor:
    """[b, T, features] -> class probabilities [b, n_outputs] (or the
    pre-activation logits), on ``params``, a flat mapping of tensors in the
    layout of :func:`param_specs`; gradients flow to them.  ``schedule``
    overrides the config-derived schedule of the recurrent layer;
    ``lengths`` [b] routes a padded batch through the masked-scan ragged
    path.  ``fp`` quantizes the recurrent layer and every point of the
    dense head to the ap_fixed grid, as hls4ml does; the softmax takes
    unquantized logits (its LUT gets extra precision in hls4ml, paper Sec.
    5.1).  Where the layer runs on the kernels (``impl="pallas"``, float or
    native int ``fp``) the head's products run on ``col_matmul``, so a
    row's answer has the same bits in every batch; the reference and the
    ap_fixed emulation keep the head on the reference product, as their
    cells."""
    rec = tracing.ACTIVE
    if rec is not None:
        span = rec.open("model.forward")
        inner = rec.open("rnn.scan")
    rnn = cfg.rnn
    p = params
    h = rnn_layer(rnn, x, p["rnn/kernel"], p["rnn/recurrent"],
                  p["rnn/bias"], fp=fp, mode=mode, impl=impl,
                  schedule=schedule, lengths=lengths)
    if rec is not None:
        rec.close(inner)
        rec.open("model.head")

    def q(t):
        return t if fp is None else quantize(t, fp)

    on_kernel = impl == "pallas" and (fp is None or is_native_int(fp))

    def dense(a, w):
        # the kernel path (float, native int) runs the head on col_matmul,
        # each output one k-ascending chain whatever the batch; the
        # reference and the ap_fixed emulation on ref.matmul.  Both sum in
        # k order on the CPU
        if on_kernel:
            return col_matmul_kernel(a.contiguous(), w.contiguous())
        return matmul(a, w)

    h = q(h.float())
    for i in range(len(rnn.dense_sizes)):
        h = q(dense(h, q(p[f"dense{i}/w"])) + q(p[f"dense{i}/b"]))
        h = q(torch.relu(h))
    logits = dense(h, q(p["head/w"])) + q(p["head/b"])
    if return_logits:
        out = logits
    elif rnn.output_activation == "sigmoid":
        out = sigmoid(q(logits))
    else:
        out = torch.softmax(logits.float(), dim=-1)
    if rec is not None:
        rec.close(span)                  # and model.head inside it
    return out


def loss_fn(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
            x: torch.Tensor, y: torch.Tensor):
    """Binary or categorical cross entropy (matches the paper's training)
    on the reference forward, and the accuracy: ``(loss, {"loss",
    "accuracy"})``."""
    rnn = cfg.rnn
    logits = forward(cfg, params, x, return_logits=True)
    if rnn.output_activation == "sigmoid":
        yl = y.float().reshape(logits.shape)
        ls = F.logsigmoid(logits)
        lns = F.logsigmoid(-logits)
        loss = -torch.mean(yl * ls + (1 - yl) * lns)
        acc = torch.mean(((logits[..., 0] > 0) == (y > 0.5)).float())
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        labels = y.long()[:, None]
        loss = -torch.mean(torch.gather(logp, -1, labels))
        acc = torch.mean((torch.argmax(logits, -1) == labels[:, 0]).float())
    return loss, {"loss": loss, "accuracy": acc}
