"""Synthetic top-tagging dataset (paper Sec. 4.1 stand-in).

MadGraph/Pythia are not available offline, so we simulate the *feature
structure* the paper's RNN learns: top jets have 3-prong substructure
(t -> Wb -> qqb) with mass ~173 GeV spread across subjets; light-quark jets
are single-prong with a steeply falling fragmentation spectrum.  Particles
carry the paper's six features (pT, eta, phi, E, dR-from-axis, pid), are
pT-ordered and padded to 20 — an RNN separates these at AUC ~0.9+, giving a
faithful substrate for the quantization scans (Fig. 2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_PARTICLES = 20
N_FEATURES = 6


def _make_jet(rng: np.random.RandomState, is_top: bool) -> np.ndarray:
    jet_pt = 1000.0 * (1 + 0.01 * rng.randn())        # 1 TeV window
    if is_top:
        # 3 subjet cores within dR ~ 2m/pT ~ 0.35 of the axis; sometimes
        # collimated enough to look 1-2 prong (realistic overlap)
        n_cores = 3
        scale = 0.5 if rng.rand() < 0.25 else 1.0
        core_dr = scale * 0.35 * np.abs(rng.randn(n_cores) * 0.4 + 1.0) / 2
        core_phi = rng.uniform(0, 2 * np.pi, n_cores)
        core_frac = rng.dirichlet([4.0, 3.0, 2.0])
    else:
        # QCD jets occasionally radiate a hard secondary prong
        n_cores = 2 if rng.rand() < 0.3 else 1
        core_dr = np.concatenate([[0.02 * np.abs(rng.randn())],
                                  0.2 * np.abs(rng.randn(n_cores - 1)) + 0.05])
        core_phi = rng.uniform(0, 2 * np.pi, n_cores)
        core_frac = (np.array([1.0]) if n_cores == 1
                     else rng.dirichlet([6.0, 1.5]))

    n_part = rng.randint(12, N_PARTICLES + 1)
    parts = []
    for _ in range(n_part):
        c = rng.choice(n_cores, p=core_frac)
        # fragmentation: z ~ falling spectrum within the subjet
        z = rng.beta(1.0, 4.0 if is_top else 6.0)
        pt = jet_pt * core_frac[c] * z
        spread = 0.06 if is_top else 0.03
        dr = core_dr[c] + spread * np.abs(rng.randn())
        ang = core_phi[c] + 0.3 * rng.randn()
        eta = dr * np.cos(ang)
        phi = dr * np.sin(ang)
        energy = pt * np.cosh(eta + 0.0)
        pid = float(rng.choice([-211, 211, 22, 130, 11],
                               p=[0.3, 0.3, 0.25, 0.1, 0.05])) / 211.0
        parts.append([pt, eta, phi, energy, dr, pid])

    parts.sort(key=lambda p: -p[0])                   # pT ordering
    arr = np.zeros((N_PARTICLES, N_FEATURES), np.float32)
    arr[: len(parts)] = np.asarray(parts[:N_PARTICLES], np.float32)
    # detector smearing
    arr[: len(parts), 1:3] += rng.randn(len(parts), 2).astype(np.float32) * 0.01
    arr[: len(parts), 4] = np.abs(arr[: len(parts), 4]
                                  + rng.randn(len(parts)) * 0.02)
    # normalize scales (log-pT/E, raw angles)
    arr[:, 0] = np.log1p(arr[:, 0]) / 7.0
    arr[:, 3] = np.log1p(arr[:, 3]) / 7.0
    return arr


def top_tagging_dataset(n: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n, 20, 6], y [n] in {0,1}); deterministic in seed."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.int32)
    x = np.stack([_make_jet(rng, bool(t)) for t in y])
    return x, y
