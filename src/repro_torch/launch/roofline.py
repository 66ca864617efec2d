"""Roofline analysis from dry-run records, against an H100.

The port of ``repro/launch/roofline.py``, its formulas unchanged, with the
port's ``HardwareConfig`` (default ``config.H100``, NVIDIA's data sheet):

  compute_s    = FLOPs_per_device / peak_flops_bf16
  memory_s     = bytes_accessed_per_device / hbm_bw
  collective_s = wire_bytes_per_device / link_bw
  MODEL_FLOPS  = 6*N_active*tokens (train) / 2*N_active*tokens (+ attention
                 terms): the "useful" flops; their ratio to the counted
                 flops exposes remat / causal waste.
  roofline_fraction = (MODEL_FLOPS/chips/peak) / max(terms)

The dry run's record (``launch/dryrun.py``) gives the FLOPs
(``cost.flops_per_device``: ``FlopCounterMode``'s global count over the
mesh size), the bytes every local op reads and writes
(``cost.bytes_accessed``, one rank, unfused eager ops) and the wire bytes.
``repro`` halves the byte terms of bf16 archs to undo XLA's CPU backend's
f32 legalization; the port's tensors carry their real dtype, so nothing
is halved.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from repro_torch.config import H100, SHAPES, ModelConfig, ShapeConfig
from repro_torch.registry import get_config

CHIPS_SINGLE_POD = 256


def attention_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Exact-schedule attention FLOPs (global, fwd; causal = triangular)."""
    if not cfg.n_heads:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.n_heads, cfg.head_dim
    if shape.kind == "decode":
        if cfg.enc_dec:
            # one token: self cache S + cross cache S (both sized by shape)
            return 4.0 * B * H * hd * (S + S) * cfg.n_decoder_layers
        if cfg.rglru is not None:
            n_att = sum(1 for i in range(cfg.n_layers)
                        if cfg.rglru.pattern[i % len(cfg.rglru.pattern)]
                        == "local_attn")
            return 4.0 * B * H * hd * min(cfg.rglru.window, S) * n_att
        # one token attends to the whole cache
        return 4.0 * B * H * hd * S * cfg.n_layers
    if cfg.enc_dec:
        Stxt = 448
        enc = 4 * B * S * S * H * hd * cfg.n_encoder_layers
        dec = 2 * B * Stxt * Stxt * H * hd * cfg.n_decoder_layers
        cross = 4 * B * Stxt * S * H * hd * cfg.n_decoder_layers
        return enc + dec + cross
    per_layer = 2.0 * B * S * S * H * hd          # causal half of 4BS^2Hhd
    if cfg.rglru is not None:
        n_att = sum(1 for i in range(cfg.n_layers)
                    if cfg.rglru.pattern[i % len(cfg.rglru.pattern)]
                    == "local_attn")
        w = min(cfg.rglru.window, S)
        return 4.0 * B * S * w * H * hd * n_att * 0.5 * 2
    return per_layer * cfg.n_layers


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    from repro_torch.models.transformer import padded_vocab
    n = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    att = attention_model_flops(cfg, shape)
    vd = padded_vocab(cfg) * cfg.d_model if cfg.family != "rnn" else 0
    emb_params = vd * (1 if cfg.tie_embeddings else 2)
    if shape.kind == "train":
        tokens = B * (448 if cfg.enc_dec else S)
        if cfg.enc_dec:
            tokens = B * (S + 448)  # encoder frames + decoder tokens
        return 6.0 * n * tokens + 3.0 * att
    if shape.kind == "prefill":
        # inference computes logits only for the final position; the
        # embedding lookup is a gather (~0 matmul flops)
        tokens = B * S
        return 2.0 * (n - emb_params) * tokens + 2.0 * vd * B + att
    # decode: one new token per sequence (logits every token)
    return 2.0 * (n - emb_params) * B + 2.0 * vd * B + att


def analyze_record(rec: Dict, hw=H100, chips: int = CHIPS_SINGLE_POD
                   ) -> Optional[Dict]:
    if "memory" not in rec:
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    flops_dev = rec["cost"]["flops_per_device"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    wire_dev = rec["collectives"]["wire_bytes_per_device"]

    compute_s = flops_dev / hw.peak_flops_bf16
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = wire_dev / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    counted_global = flops_dev * chips
    ratio = mf / counted_global if counted_global else 0.0
    ideal_compute_s = mf / (chips * hw.peak_flops_bf16)
    frac = ideal_compute_s / max(max(terms.values()), 1e-12)

    suggestions = {
        "collective": "cut cross-device traffic: fewer FSDP weight "
                      "regathers (lower accum / 2D weight sharding), bf16 "
                      "collectives, overlap-friendly scan structure",
        "memory": "cut HBM traffic: tighter remat policy, bf16 "
                  "intermediates, fuse elementwise chains, smaller "
                  "microbatch working set",
        "compute": "raise useful-flop share: remove causal-masked waste, "
                   "reduce remat recompute, larger MXU-aligned tiles",
    }
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": rec["kind"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": counted_global,
        "useful_ratio": ratio, "roofline_fraction": frac,
        "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
        "fits_hbm": rec["memory"]["peak_bytes"] <= hw.hbm_bytes,
        "suggestion": suggestions[dominant],
    }


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL/counted | roofline frac | peak est. GiB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r is None:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['peak_gib']:.1f} | "
            f"{'Y' if r['fits_hbm'] else 'N'} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.json")
    ap.add_argument("--out", default="results/roofline_torch")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        recs = json.load(f)
    rows = []
    for rec in recs:
        if "skipped" in rec:
            rows.append(None)
            continue
        try:
            rows.append(analyze_record(rec))
        except Exception as e:
            print(f"skip {rec.get('arch')}x{rec.get('shape')}: {e}")
    with open(args.out + ".json", "w") as f:
        json.dump([r for r in rows if r], f, indent=1)
    md = markdown_table(rows)
    with open(args.out + ".md", "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    main()
