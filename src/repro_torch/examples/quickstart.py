"""Quickstart: the paper's full pipeline on the port.

1. Train the top-quark tagger (paper benchmark 1) on synthetic LHC jets.
2. Post-training-quantize it to ap_fixed<16,6> (the paper's headline config).
3. Serve it (static mode) on the device, time batch-1 latency with
   ``RNNServingEngine.benchmark`` and print the paired FPGA design points.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--steps 150] [--events 1000] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.config import FixedPointConfig
from repro_torch.core.hls import RNNDesignPoint, estimate_design
from repro_torch.core.quant.ptq import binary_auc, ptq_quantize_model
from repro_torch.data import top_tagging_dataset
from repro_torch.examples._common import train_tagger
from repro_torch.device import device_name, require_device
from repro_torch.models import rnn_tagger
from repro_torch.serving import RNNServingEngine


def main(steps: int = 150, device: str = "cuda", events: int = 1000) -> Dict:
    device = require_device(device, "quickstart")
    # 1. train ---------------------------------------------------------------
    cfg, model, params = train_tagger("top-tagging-gru", steps=steps,
                                      device=device, log_every=50)
    xt, yt = top_tagging_dataset(events, seed=99)
    x = torch.from_numpy(xt).to(device)
    with torch.inference_mode():
        probs = model.forward(params, {"x": x}).cpu().numpy()
    auc_float = binary_auc(probs[:, 0], yt)
    print(f"\nfloat AUC: {auc_float:.4f}")

    # 2. quantize (paper Sec 5.1) ---------------------------------------------
    fp = FixedPointConfig(total_bits=16, integer_bits=6)
    qparams = ptq_quantize_model(params, fp)
    with torch.inference_mode():
        qprobs = rnn_tagger.forward(cfg, qparams, x, fp=fp).cpu().numpy()
    auc_q = binary_auc(qprobs[:, 0], yt)
    print(f"ap_fixed<16,6> AUC: {auc_q:.4f}  "
          f"(ratio {auc_q/auc_float:.4f} — paper Fig. 2: ~1.0 at >=10 "
          f"fractional bits)")

    # 3. serve + FPGA design point (paper Sec 5.2/5.3) ------------------------
    eng = RNNServingEngine(cfg, qparams, mode="static", fp=fp, device=device)
    eng.warmup()
    bench = eng.benchmark(batch=1, iters=10)
    print(f"\nserving batch-1 latency ({device_name(device)}): "
          f"{bench['latency_s']*1e3:.2f} ms")
    d = eng.fpga_design(strategy="latency")
    print(f"FPGA design (latency strategy, xcku115 @200MHz): "
          f"{d.latency_min_us:.2f} us, II={d.ii_cycles}, fits={d.fits}  "
          f"(paper Table 2: 1.7 us)")
    d_ns = estimate_design(RNNDesignPoint(cfg, FixedPointConfig(10, 6),
                                          strategy="latency",
                                          mode="nonstatic"))
    print(f"non-static mode: II={d_ns.ii_cycles} (paper Table 5: 315 -> 1, "
          f">300x throughput)")
    return {"auc_float": auc_float, "auc_ap16_6": auc_q, "benchmark": bench,
            "fpga_latency_us": d.latency_min_us, "fpga_ii": d.ii_cycles,
            "nonstatic_ii": d_ns.ii_cycles}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--events", type=int, default=1000,
                    help="held-out events the AUCs are taken on")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(**vars(ap.parse_args()))
