"""Synthetic QuickDraw-style stroke dataset (paper Sec. 4.3 stand-in).

Five classes (ant, butterfly, bee, mosquito, snail) as distinct parametric
stroke processes; each drawing is 100 timestamped pen positions (x, y, t),
matching the paper's input format (100 x 3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SEQ = 100
CLASSES = ("ant", "butterfly", "bee", "mosquito", "snail")


def _stroke(rng, label: int) -> np.ndarray:
    t = np.linspace(0, 1, SEQ)
    jitter = lambda s: rng.randn(SEQ) * s
    if label == 0:      # ant: three body blobs + leg zigzags
        seg = (t * 3).astype(int)
        cx = np.array([-0.5, 0.0, 0.5])[np.clip(seg, 0, 2)]
        ang = 2 * np.pi * ((t * 3) % 1.0) * (2 + rng.rand())
        x = cx + 0.18 * np.cos(ang)
        y = 0.15 * np.sin(ang) + 0.25 * np.sign(np.sin(12 * np.pi * t)) * (t > 0.7)
    elif label == 1:    # butterfly: two large lobes (lemniscate)
        ang = 2 * np.pi * t * (1.5 + 0.2 * rng.rand())
        x = 0.8 * np.sin(ang)
        y = 0.6 * np.sin(ang) * np.cos(ang) + 0.1 * np.sin(5 * ang)
    elif label == 2:    # bee: blob + wide zigzag flight path
        x = np.where(t < 0.5, 0.3 * np.cos(4 * np.pi * t),
                     -1 + 4 * (t - 0.5) + 0.0)
        y = np.where(t < 0.5, 0.2 * np.sin(4 * np.pi * t),
                     0.4 * np.sign(np.sin(16 * np.pi * t)))
    elif label == 3:    # mosquito: long thin legs, tiny body
        seg = (t * 6).astype(int) % 2
        x = np.where(seg == 0, 0.1 * np.cos(20 * t), (t - 0.5) * 1.8)
        y = np.where(seg == 0, 0.1 * np.sin(20 * t), -0.8 * t + 0.2)
    else:               # snail: spiral shell + base line
        ang = 4 * np.pi * t
        r = 0.08 + 0.6 * t
        x = np.where(t < 0.8, r * np.cos(ang), -0.6 + 1.8 * (t - 0.8) * 5)
        y = np.where(t < 0.8, r * np.sin(ang), -0.55)
    x = x + jitter(0.02)
    y = y + jitter(0.02)
    # pen speed variation -> non-uniform timestamps like real strokes
    dt = np.abs(rng.randn(SEQ)) * 0.3 + 1.0
    ts = np.cumsum(dt)
    ts = ts / ts[-1]
    return np.stack([x, y, ts], 1).astype(np.float32)


def quickdraw_dataset(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n, 100, 3], y [n] in 0..4)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 5, n).astype(np.int32)
    x = np.stack([_stroke(rng, int(t)) for t in y])
    return x, y
