"""The plain reference of the taggers, and the seeded weights both sides get.

The recurrent layer follows the Keras equations (paper Eq. 1): LSTM gates
i|f|c|o, c' = f·c + i·g, h' = o·tanh(c'); GRU with ``reset_after``, gates
z|r|h, the reset gate applied to the recurrent product after its bias:
h~ = tanh(x W_h + b_in,h + r·(h U_h + b_rec,h)), h' = z·h + (1 - z)·h~.
The dense head is ReLU layers and a softmax (or sigmoid) output.  Plain
PyTorch in float32 with TF32 off; it imports nothing of the program.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Mapping

import torch


def make_weights(cfg: Mapping, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The tagger's weights in the program's flat layout (``rnn/kernel``
    [in, G·H], ``rnn/recurrent`` [H, G·H], ``rnn/bias`` [G·H] or GRU
    [2, 3H], ``dense{i}/w`` [in, out], ``dense{i}/b``, ``head/w``,
    ``head/b``), float32, drawn on ``device`` in one call from ``seed``:
    matrices N(0, 1/fan_in), biases N(0, 0.1²)."""
    h, fin = cfg["hidden"], cfg["input_size"]
    g = 4 if cfg["cell"] == "lstm" else 3
    shapes = {"rnn/kernel": (fin, g * h), "rnn/recurrent": (h, g * h),
              "rnn/bias": (g * h,) if cfg["cell"] == "lstm" else (2, g * h)}
    prev = h
    for i, width in enumerate(cfg["dense_sizes"]):
        shapes[f"dense{i}/w"] = (prev, width)
        shapes[f"dense{i}/b"] = (width,)
        prev = width
    shapes["head/w"] = (prev, cfg["n_outputs"])
    shapes["head/b"] = (cfg["n_outputs"],)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for (path, shape), part in zip(shapes.items(), flat.split(sizes)):
        scale = shape[0] ** -0.5 if path.endswith(
            ("kernel", "recurrent", "/w")) else 0.1
        out[path] = (part * scale).view(shape).contiguous()
    return out


@contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 (``tf32=False``) or TF32 on the card, restored
    on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rnn_final_state(cfg: Mapping, p: Mapping[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """[B, T, in] -> the recurrent layer's final h [B, H]."""
    W, U, b = p["rnn/kernel"], p["rnn/recurrent"], p["rnn/bias"]
    H = cfg["hidden"]
    h = x.new_zeros(x.shape[0], H)
    c = torch.zeros_like(h)
    for t in range(x.shape[1]):
        if cfg["cell"] == "lstm":
            z = x[:, t] @ W + h @ U + b
            i, f, g, o = z.split(H, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        else:
            zx = x[:, t] @ W + b[0]
            zh = h @ U + b[1]
            xz, xr, xh = zx.split(H, dim=1)
            hz, hr, hh = zh.split(H, dim=1)
            z = torch.sigmoid(xz + hz)
            r = torch.sigmoid(xr + hr)
            h = z * h + (1.0 - z) * torch.tanh(xh + r * hh)
    return h


def tagger(cfg: Mapping, p: Mapping[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """[B, T, in] -> class probabilities [B, n_outputs]."""
    a = rnn_final_state(cfg, p, x)
    for i in range(len(cfg["dense_sizes"])):
        a = torch.relu(a @ p[f"dense{i}/w"] + p[f"dense{i}/b"])
    logits = a @ p["head/w"] + p["head/b"]
    if cfg["output_activation"] == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def tagger_blocks(cfg: Mapping, p: Mapping[str, torch.Tensor],
                  x: torch.Tensor, rows: int = 8192) -> torch.Tensor:
    """:func:`tagger` over blocks of ``rows`` events, so it fits beside
    whatever the card still holds."""
    return torch.cat([tagger(cfg, p, x[i:i + rows])
                      for i in range(0, x.shape[0], rows)])
