"""Synthetic jet-flavor-tagging dataset (paper Sec. 4.2 stand-in).

The discriminating physics: b/c hadrons fly O(mm) before decaying, so their
tracks have large transverse impact parameters d0 with large significance
S(d0); light jets' tracks point back to the primary vertex.  We simulate
per-track (pT/pT_jet, dR, d0, dz, S(d0), S(dz)) for 3 classes
(b=0, c=1, light=2), S(d0)-ordered, padded to 15 tracks — the structure the
paper's RNNIP-style tagger consumes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_TRACKS = 15
N_FEATURES = 6

# decay-length scale (mm) and number of displaced tracks per class
_CLASS = {
    0: {"flight": 5.0, "n_disp": (3, 6)},   # b
    1: {"flight": 2.0, "n_disp": (1, 4)},   # c
    2: {"flight": 0.0, "n_disp": (0, 1)},   # light
}


def _make_jet(rng: np.random.RandomState, label: int) -> np.ndarray:
    spec = _CLASS[label]
    n_trk = rng.randint(6, N_TRACKS + 1)
    n_disp = rng.randint(*spec["n_disp"]) if spec["n_disp"][1] > spec["n_disp"][0] else 0
    d0_res = 0.02                                       # 20um resolution
    tracks = []
    for i in range(n_trk):
        displaced = i < n_disp
        if displaced and spec["flight"] > 0:
            lxy = rng.exponential(spec["flight"])
            d0 = lxy * np.abs(rng.randn()) * 0.1 + rng.randn() * d0_res
            dz = lxy * np.abs(rng.randn()) * 0.15 + rng.randn() * 2 * d0_res
        else:
            d0 = rng.randn() * d0_res
            dz = rng.randn() * 2 * d0_res
        pt_frac = rng.beta(1.2, 6.0)
        dr = np.abs(rng.randn()) * 0.15
        s_d0 = d0 / d0_res
        s_dz = dz / (2 * d0_res)
        tracks.append([pt_frac, dr, d0, dz, s_d0, s_dz])

    tracks.sort(key=lambda t: -abs(t[4]))               # |S(d0)| ordering
    arr = np.zeros((N_TRACKS, N_FEATURES), np.float32)
    arr[: len(tracks)] = np.asarray(tracks[:N_TRACKS], np.float32)
    arr[:, 2] = np.tanh(arr[:, 2])                      # bound d0/dz tails
    arr[:, 3] = np.tanh(arr[:, 3])
    arr[:, 4] = np.tanh(arr[:, 4] / 10.0) * 10.0
    arr[:, 5] = np.tanh(arr[:, 5] / 10.0) * 10.0
    return arr


def flavor_tagging_dataset(n: int, seed: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n, 15, 6], y [n] in {0:b, 1:c, 2:light})."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 3, n).astype(np.int32)
    x = np.stack([_make_jet(rng, int(t)) for t in y])
    return x, y
