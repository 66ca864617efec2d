"""End-to-end TRAINING driver: pretrain a reduced stablelm-family LM on the
synthetic token stream with checkpoint / restart, through the port's
trainer (``launch.train.train``: data pipeline -> train step -> optimizer
-> checkpoint manager -> resume).

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain
      [--steps 200] [--resume-steps 50] [--batch 16] [--seq-len 128]
      [--arch stablelm-3b] [--device cpu]
The checkpoints go to a new temporary directory (``--checkpoint-dir`` to
choose one), removed at the end when the driver made it.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import Dict, Optional

from repro_torch.device import require_device
from repro_torch.launch.train import train


def main(steps: int = 200, arch: str = "stablelm-3b", device: str = "cuda",
         checkpoint_dir: Optional[str] = None, resume_steps: int = 50,
         batch: int = 16, seq_len: int = 128) -> Dict:
    device = require_device(device, "lm_pretrain")
    made = checkpoint_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="lm_pretrain_") if made \
        else checkpoint_dir
    try:
        print(f"=== pretraining tiny {arch} for {steps} steps ===")
        _, loss = train(arch, steps=steps, batch=batch, lr=3e-3,
                        seq_len=seq_len, tiny=True, checkpoint_dir=ckpt_dir,
                        device=device)
        print(f"final loss: {loss:.4f}")

        print("\n=== simulated preemption: resume from checkpoint ===")
        _, loss2 = train(arch, steps=steps + resume_steps, batch=batch,
                         lr=3e-3, seq_len=seq_len, tiny=True,
                         checkpoint_dir=ckpt_dir, resume=True, device=device)
        print(f"post-resume loss: {loss2:.4f}")
    finally:
        if made:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"loss": loss, "resumed_loss": loss2}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume-steps", type=int, default=50,
                    help="steps trained after the resume")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    main(**vars(ap.parse_args()))
