"""The benchmark's event generators, drawn in bulk from a seed.

Frozen copies of the port's synthetic datasets (``repro_torch/data/
quickdraw.py``, ``tracks.py`` and ``jets.py``): the same processes, the
same features and scales, drawn for all events at once with numpy instead
of one event at a time, so that a run's set-up makes a pool of tens of
thousands of events in tens of milliseconds.  The values differ from the
port's datasets for the same seed; the distributions do not.

A traffic file names its generator (``GENERATORS``); each takes
``(n, rng)`` and returns float32 events ``[n, T, features]``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

QUICKDRAW_SEQ = 100
TRACKS, TRACK_FEATURES = 15, 6
PARTICLES, PARTICLE_FEATURES = 20, 6


def quickdraw_strokes(n: int, rng: np.random.Generator) -> np.ndarray:
    """QuickDraw-style drawings [n, 100, 3] (x, y, t): five classes (ant,
    butterfly, bee, mosquito, snail) as parametric strokes with jitter and
    non-uniform pen timestamps."""
    seq = QUICKDRAW_SEQ
    t = np.linspace(0, 1, seq)[None, :]
    label = rng.integers(0, 5, n)
    u = rng.random((n, 1))
    jx, jy, jdt = rng.standard_normal((3, n, seq))
    x = np.empty((n, seq))
    y = np.empty((n, seq))

    k = label == 0      # ant: three body blobs + leg zigzags
    seg = np.clip((t * 3).astype(int), 0, 2)
    ang = 2 * np.pi * ((t * 3) % 1.0) * (2 + u[k])
    x[k] = np.array([-0.5, 0.0, 0.5])[seg] + 0.18 * np.cos(ang)
    y[k] = (0.15 * np.sin(ang)
            + 0.25 * np.sign(np.sin(12 * np.pi * t)) * (t > 0.7))
    k = label == 1      # butterfly: two large lobes (lemniscate)
    ang = 2 * np.pi * t * (1.5 + 0.2 * u[k])
    x[k] = 0.8 * np.sin(ang)
    y[k] = 0.6 * np.sin(ang) * np.cos(ang) + 0.1 * np.sin(5 * ang)
    k = label == 2      # bee: blob + wide zigzag flight path
    x[k] = np.where(t < 0.5, 0.3 * np.cos(4 * np.pi * t), -1 + 4 * (t - 0.5))
    y[k] = np.where(t < 0.5, 0.2 * np.sin(4 * np.pi * t),
                    0.4 * np.sign(np.sin(16 * np.pi * t)))
    k = label == 3      # mosquito: long thin legs, tiny body
    seg = (t * 6).astype(int) % 2
    x[k] = np.where(seg == 0, 0.1 * np.cos(20 * t), (t - 0.5) * 1.8)
    y[k] = np.where(seg == 0, 0.1 * np.sin(20 * t), -0.8 * t + 0.2)
    k = label == 4      # snail: spiral shell + base line
    ang = 4 * np.pi * t
    r = 0.08 + 0.6 * t
    x[k] = np.where(t < 0.8, r * np.cos(ang), -0.6 + 1.8 * (t - 0.8) * 5)
    y[k] = np.where(t < 0.8, r * np.sin(ang), -0.55)

    x += 0.02 * jx
    y += 0.02 * jy
    ts = np.cumsum(np.abs(jdt) * 0.3 + 1.0, axis=1)
    ts /= ts[:, -1:]
    return np.stack([x, y, ts], -1).astype(np.float32)


# decay-length scale (mm) and the range of displaced tracks per class
# (b, c, light), as ``randint(lo, hi)``
_FLIGHT = np.array([5.0, 2.0, 0.0])
_DISP_LO = np.array([3, 1, 0])
_DISP_HI = np.array([6, 4, 1])


def flavor_tracks(n: int, rng: np.random.Generator) -> np.ndarray:
    """Jet-flavor tracks [n, 15, 6] (pT/pT_jet, dR, d0, dz, S(d0), S(dz)):
    b / c / light jets of 6-15 tracks, the displaced ones with impact
    parameters from an exponential flight length, ordered by |S(d0)| and
    zero-padded to 15, d0 / dz / significances bounded by tanh."""
    label = rng.integers(0, 3, n)
    n_trk = rng.integers(6, TRACKS + 1, n)
    n_disp = rng.integers(_DISP_LO[label], _DISP_HI[label])
    i = np.arange(TRACKS)[None, :]
    valid = i < n_trk[:, None]
    flight = _FLIGHT[label][:, None]
    displaced = (i < n_disp[:, None]) & (flight > 0)
    d0_res = 0.02                                   # 20 um resolution
    lxy = rng.exponential(1.0, (n, TRACKS)) * flight
    a0, a1, r0, r1, dr = rng.standard_normal((5, n, TRACKS))
    d0 = np.where(displaced, lxy * np.abs(a0) * 0.1, 0.0) + r0 * d0_res
    dz = np.where(displaced, lxy * np.abs(a1) * 0.15, 0.0) + r1 * 2 * d0_res
    pt_frac = rng.beta(1.2, 6.0, (n, TRACKS))
    trk = np.stack([pt_frac, np.abs(dr) * 0.15, d0, dz, d0 / d0_res,
                    dz / (2 * d0_res)], -1)
    order = np.argsort(np.where(valid, -np.abs(trk[..., 4]), np.inf),
                       axis=1, kind="stable")
    trk = np.take_along_axis(trk, order[..., None], axis=1)
    trk[~valid] = 0.0               # the padding sorts last
    trk = trk.astype(np.float32)
    trk[..., 2] = np.tanh(trk[..., 2])
    trk[..., 3] = np.tanh(trk[..., 3])
    trk[..., 4] = np.tanh(trk[..., 4] / 10.0) * 10.0
    trk[..., 5] = np.tanh(trk[..., 5] / 10.0) * 10.0
    return trk


_PIDS = np.array([-211, 211, 22, 130, 11]) / 211.0
_PID_P = np.array([0.3, 0.3, 0.25, 0.1, 0.05])


def top_jets(n: int, rng: np.random.Generator) -> np.ndarray:
    """Top-tagging jets [n, 20, 6] (pT, eta, phi, E, dR, pid): 1 TeV top
    jets of three subjet cores against QCD jets of one or two, 12-20
    particles with a falling fragmentation spectrum, pT-ordered and
    zero-padded to 20, smeared, log-scaled pT and E."""
    is_top = rng.integers(0, 2, n).astype(bool)
    jet_pt = 1000.0 * (1 + 0.01 * rng.standard_normal(n))
    # cores: top 3 (sometimes collimated), QCD 1 or 2 (30 %)
    scale = np.where(rng.random(n) < 0.25, 0.5, 1.0)
    top_dr = (scale[:, None] * 0.35
              * np.abs(rng.standard_normal((n, 3)) * 0.4 + 1.0) / 2)
    qcd_dr = np.concatenate(
        [0.02 * np.abs(rng.standard_normal((n, 1))),
         0.2 * np.abs(rng.standard_normal((n, 2))) + 0.05], axis=1)
    core_dr = np.where(is_top[:, None], top_dr, qcd_dr)
    core_phi = rng.uniform(0, 2 * np.pi, (n, 3))
    two = rng.random(n) < 0.3
    qcd_frac = np.where(two[:, None], np.pad(rng.dirichlet([6.0, 1.5], n),
                                             ((0, 0), (0, 1))),
                        np.array([1.0, 0.0, 0.0]))
    core_frac = np.where(is_top[:, None], rng.dirichlet([4.0, 3.0, 2.0], n),
                         qcd_frac)

    n_part = rng.integers(12, PARTICLES + 1, n)
    valid = np.arange(PARTICLES)[None, :] < n_part[:, None]
    cum = np.cumsum(core_frac, axis=1)
    c = np.minimum((rng.random((n, PARTICLES))[..., None]
                    > cum[:, None, :]).sum(-1), 2)
    z = rng.beta(1.0, np.where(is_top, 4.0, 6.0)[:, None], (n, PARTICLES))
    pt = jet_pt[:, None] * np.take_along_axis(core_frac, c, 1) * z
    spread = np.where(is_top, 0.06, 0.03)[:, None]
    dr = (np.take_along_axis(core_dr, c, 1)
          + spread * np.abs(rng.standard_normal((n, PARTICLES))))
    ang = (np.take_along_axis(core_phi, c, 1)
           + 0.3 * rng.standard_normal((n, PARTICLES)))
    eta, phi = dr * np.cos(ang), dr * np.sin(ang)
    pid = _PIDS[rng.choice(len(_PIDS), (n, PARTICLES), p=_PID_P)]
    parts = np.stack([pt, eta, phi, pt * np.cosh(eta), dr, pid], -1)
    order = np.argsort(np.where(valid, -pt, np.inf), axis=1, kind="stable")
    parts = np.take_along_axis(parts, order[..., None], axis=1)
    parts[~valid] = 0.0
    parts = parts.astype(np.float32)
    smear = rng.standard_normal((n, PARTICLES, 3)).astype(np.float32)
    parts[..., 1:3] += np.where(valid[..., None], smear[..., :2] * 0.01, 0)
    parts[..., 4] = np.where(valid, np.abs(parts[..., 4] + smear[..., 2]
                                           * 0.02), 0)
    parts[..., 0] = np.log1p(parts[..., 0]) / 7.0
    parts[..., 3] = np.log1p(parts[..., 3]) / 7.0
    return parts


GENERATORS: Dict[str, Callable[[int, np.random.Generator], np.ndarray]] = {
    "quickdraw_strokes": quickdraw_strokes,
    "flavor_tracks": flavor_tracks,
    "top_jets": top_jets,
}
