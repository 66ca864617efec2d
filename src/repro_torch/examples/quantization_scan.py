"""Reproduce paper Fig. 2 for the top tagger on the port: AUC ratio vs
fractional bits at integer bits {6, 8, 10, 12}, printed as an ASCII table.

Run:  PYTHONPATH=src python -m repro_torch.examples.quantization_scan
      [--steps 150] [--events 1000] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.core.quant.ptq import auc_scan, tagger_forward
from repro_torch.data import top_tagging_dataset
from repro_torch.examples._common import train_tagger
from repro_torch.device import require_device

FRAC_BITS = (0, 2, 4, 6, 8, 10, 12, 14)


def main(steps: int = 150, device: str = "cuda", events: int = 1000) -> Dict:
    device = require_device(device, "quantization_scan")
    cfg, model, params = train_tagger("top-tagging-gru", steps=steps,
                                      device=device)
    x, y = top_tagging_dataset(events, seed=99)

    def forward(cfg, params, x, fp=None):      # the reference datapath
        return tagger_forward(cfg, params, x.to(device), fp=fp)

    scan = auc_scan(cfg, forward, params, x, y,
                    integer_bits=(6, 8, 10, 12), fractional_bits=FRAC_BITS)

    print("\nAUC(quantized)/AUC(float) — paper Fig. 2(a) protocol")
    print("frac bits: " + "".join(f"{fb:>8d}" for fb in FRAC_BITS))
    for ib, curve in sorted(scan.items()):
        print(f"  int {ib:2d}:  " + "".join(f"{r:8.4f}" for _, r in curve))
    print("\npaper claim: >=10 fractional bits recovers ~float AUC; "
          "6 integer bits suffice for the taggers.")
    return scan


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--events", type=int, default=1000,
                    help="held-out events each AUC is taken on")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(**vars(ap.parse_args()))
