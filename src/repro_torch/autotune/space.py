"""Legal KernelSchedule space enumeration — the paper's hand-built sweep
grid, generated and pruned mechanically.

The port's copy of the JAX package's ``autotune/space.py``.  The axes are
exactly ``KernelSchedule``'s: reuse factor x mode x hoist x hoist_reuse x
ii x block_batch x backend.  Legality pruning applies the same rules the
kernels enforce at dispatch:

  * reuse factors must divide the gate dimension ``G x hidden`` (the kernels
    clamp non-divisors via ``effective_reuse`` — enumerating them would only
    alias already-enumerated points under a different name);
  * ``hoist_reuse > 1`` requires the hoist; pipeline mode implies it
    (``KernelSchedule.__post_init__``); ``ii`` is a pipeline-only axis;
  * kernel-backend points must be launchable on the card
    (:func:`_card_legal`, asking the launchers' own layout functions:
    ``kernels/scan_layout.py`` for the scans, ``kernels/decode_step.py``'s
    ``decode_layout`` for the decode space) — a point the card's launcher
    would refuse is pruned, not clamped.  This replaces the JAX package's
    TPU rule (``check_tpu_alignment``: 128-lane column tiles, 8-sublane
    batch tiles), which the port does not carry;
  * duplicates (same ``schedule.key()``) collapse to one point.

The result is deterministic (sorted by key) so Pareto frontiers and selected
schedules are reproducible across runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence, Tuple

from repro_torch.config import ModelConfig
from repro_torch.core.hls.resources import gate_count
from repro_torch.kernels import scan_layout
from repro_torch.kernels.decode_step import decode_layout
from repro_torch.kernels.schedule import MODES, KernelSchedule


def divisors(n: int) -> Tuple[int, ...]:
    """All divisors of n, ascending — the legal reuse factors of a gate
    dimension (hls4ml restricts R the same way)."""
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return tuple(small + large[::-1])


@dataclass(frozen=True)
class SpaceSpec:
    """Which slice of the schedule space to enumerate.

    ``reuse_factors=None`` means every divisor of the gate dimension — the
    full hls4ml-legal R axis.  The defaults describe one block_batch on a
    kernel backend (``"pallas_interpret"``: the key a JAX-package engine
    with ``impl="pallas"`` uses; in the port every kernel backend runs the
    CUDA kernels on the card), pruned by the card's launch rules
    (:func:`_card_legal`).
    """

    reuse_factors: Optional[Tuple[int, ...]] = None
    modes: Tuple[str, ...] = MODES
    hoist: Tuple[bool, ...] = (False, True)
    hoist_reuses: Tuple[int, ...] = (1,)
    iis: Tuple[int, ...] = (0,)
    block_batches: Tuple[int, ...] = (8,)
    backends: Tuple[str, ...] = ("pallas_interpret",)
    max_points: int = 4096

    def __post_init__(self):
        for m in self.modes:
            if m not in MODES:
                raise ValueError(f"mode {m!r} not in {MODES}")


def _card_legal(schedule: KernelSchedule, cfg: ModelConfig) -> bool:
    """True when the card's launchers take every scan launch ``schedule``
    makes for ``cfg`` (``backend="xla"`` runs the reference: always).

    Asks ``kernels/scan_layout.py`` what the launch would: past
    ``scan_route``'s cluster H the block kernel (and ``col_matmul``) take
    every shape; up to it, a static scan needs a cluster layout
    (``scan_layout``, at the block batch and :func:`~repro_torch.kernels.
    scan_layout.model_resident`'s residency; hoisted: the zx mode), which
    the launcher refuses where no candidate fits; a pipeline scan runs the
    zx mode at R = 1's layout for every R.  Non-static blocks and the hoist
    stage run on ``col_matmul``, which takes any shape."""
    if not schedule.use_pallas or schedule.mode == "nonstatic":
        return True
    rnn = cfg.rnn
    if scan_layout.scan_route(rnn.hidden) != "cluster":
        return True
    reuse = (1 if schedule.mode == "pipeline" else
             schedule.effective_reuse(gate_count(rnn.cell) * rnn.hidden))
    try:
        scan_layout.scan_layout(schedule.block_batch, rnn.hidden,
                                rnn.input_size, rnn.cell, reuse,
                                resident=scan_layout.model_resident,
                                hoisted=schedule.hoist_input)
    except ValueError:
        return False
    return True


def _decode_card_legal(schedule: KernelSchedule,
                       products: Sequence[Tuple[int, int]],
                       bf16: bool = False) -> bool:
    """True when ``decode_matmul``'s launcher has a layout
    (``decode_layout``) for each [block_batch, K] @ [K, N] product of
    ``products`` at the schedule's effective reuse."""
    if not schedule.use_pallas:
        return True
    try:
        for K, N in products:
            decode_layout(schedule.block_batch, K, N,
                          schedule.effective_reuse(N), bf16)
    except ValueError:
        return False
    return True


def _raw_points(gate_dim: int, spec: SpaceSpec) -> Iterator[KernelSchedule]:
    rfs = spec.reuse_factors if spec.reuse_factors is not None \
        else divisors(gate_dim)
    for backend in spec.backends:
        for bb in spec.block_batches:
            for r in rfs:
                if gate_dim % r != 0:
                    continue            # aliases the gcd point — prune
                for mode in spec.modes:
                    base = dict(reuse_factor=r, mode=mode, block_batch=bb,
                                backend=backend)
                    if mode == "pipeline":
                        # hoist is implied; ii and hoist_reuse are live axes
                        for ii in spec.iis:
                            for hr in spec.hoist_reuses:
                                if hr > 1 and gate_dim % hr != 0:
                                    continue
                                yield KernelSchedule(ii=ii, hoist_reuse=hr,
                                                     **base)
                        continue
                    for hoist in spec.hoist:
                        if not hoist:
                            yield KernelSchedule(**base)
                            continue
                        for hr in spec.hoist_reuses:
                            if hr > 1 and gate_dim % hr != 0:
                                continue
                            yield KernelSchedule(hoist_input=True,
                                                 hoist_reuse=hr, **base)


def _legal_space(cfg: ModelConfig, spec: Optional[SpaceSpec],
                 legal: Callable[[KernelSchedule], bool]
                 ) -> Tuple[KernelSchedule, ...]:
    assert cfg.rnn is not None, "the schedule space is an RNN-family concept"
    spec = spec or SpaceSpec()
    gate_dim = gate_count(cfg.rnn.cell) * cfg.rnn.hidden
    seen = {}
    for s in _raw_points(gate_dim, spec):
        if not legal(s):
            continue
        seen.setdefault(s.key(), s)
        if len(seen) >= spec.max_points:
            break
    return tuple(seen[k] for k in sorted(seen))


def enumerate_space(cfg: ModelConfig,
                    spec: Optional[SpaceSpec] = None
                    ) -> Tuple[KernelSchedule, ...]:
    """The legal, deduplicated, deterministic schedule space for one model."""
    return _legal_space(cfg, spec, lambda s: _card_legal(s, cfg))


# ---------------------------------------------------------------------------
# Decode-legal slice (the single-step kernels of kernels/decode_step.py)
# ---------------------------------------------------------------------------


def decode_legal(schedule: KernelSchedule) -> bool:
    """True when the single-step decode kernels can execute ``schedule``.

    A decode step has no time axis, so the scan-only degrees of freedom are
    illegal: mode must be ``"static"`` (ONE weights-resident block serves
    the step; non-static/pipeline describe per-timestep block chains that
    do not exist here), and the hoist axes (``hoist_input``,
    ``hoist_reuse``) and pipeline ``ii`` must be off — there is no input
    projection to hoist out of a single step.  The reuse factor and
    backend axes carry over unchanged.
    """
    return (schedule.mode == "static" and not schedule.hoist_input
            and schedule.hoist_reuse == 1 and schedule.ii == 0)


def native_int_legal(schedule: KernelSchedule) -> bool:
    """True when the NATIVE int8/int4 kernel bodies can execute
    ``schedule``.

    Quantized datapaths never hoist — splitting z = q(xW + hU + b) into a
    precomputed zx plus an in-loop hU would move the hls4ml quantization
    points — so ``hoist_input``/``hoist_reuse`` and pipeline mode (which
    implies the hoist) are illegal, as is a pipeline ``ii``.  Reuse factor,
    mode static/nonstatic, block_batch and backend carry over: the native
    scan runs the same per-timestep structure either way, with R column
    tiles per gate matmul.
    """
    return (not schedule.hoist_input and schedule.mode != "pipeline"
            and schedule.hoist_reuse == 1 and schedule.ii == 0)


def enumerate_decode_space(cfg: ModelConfig,
                           spec: Optional[SpaceSpec] = None
                           ) -> Tuple[KernelSchedule, ...]:
    """The decode-legal slice of the schedule space (deduped, sorted) —
    what ``autotune.select_decode`` and the decode estimators price; a
    point whose gate products ``decode_matmul`` cannot lay out is pruned."""
    rnn = cfg.rnn
    assert rnn is not None, "the schedule space is an RNN-family concept"
    gate_dim = gate_count(rnn.cell) * rnn.hidden
    products = ((rnn.input_size, gate_dim), (rnn.hidden, gate_dim))  # xW, hU
    space = _legal_space(cfg, spec,
                         lambda s: _decode_card_legal(s, products))
    return tuple(s for s in space if decode_legal(s))


# ---------------------------------------------------------------------------
# Speculative slice: legal (draft, verify, K) triples over the decode space
# ---------------------------------------------------------------------------


def lm_decode_schedules(cfg: ModelConfig,
                        spec: Optional[SpaceSpec] = None
                        ) -> Tuple[KernelSchedule, ...]:
    """The decode-legal schedule slice for a DENSE-stack LM config — the
    reuse factors are divisors of the gcd of the scheduled step's fused
    matmul output widths (q|k|v, attn out, MLP in, MLP down), so every
    enumerated R is what ``effective_reuse`` resolves on EVERY matmul in
    the chain: the point priced is the point executed, chain-wide.
    """
    import math

    spec = spec or SpaceSpec()
    d, f = cfg.d_model, cfg.d_ff
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    glu = cfg.mlp_type in ("swiglu", "geglu")
    chain = ((d, (hq + 2 * hk) * hd), (hq * hd, d), (d, 2 * f if glu else f),
             (f, d))
    bf16 = cfg.compute_dtype == "bfloat16"
    g = 0
    for _, w in chain:
        g = math.gcd(g, w)
    rfs = spec.reuse_factors if spec.reuse_factors is not None \
        else divisors(g)
    seen = {}
    for backend in spec.backends:
        for bb in spec.block_batches:
            for r in rfs:
                if g % r != 0:
                    continue
                s = KernelSchedule(reuse_factor=r, mode="static",
                                   block_batch=bb, backend=backend)
                if not _decode_card_legal(s, chain, bf16):
                    continue
                seen.setdefault(s.key(), s)
                if len(seen) >= spec.max_points:
                    break
    return tuple(seen[k] for k in sorted(seen))


def speculative_draft_legal(draft: Optional[KernelSchedule],
                            verify: KernelSchedule) -> bool:
    """True when ``draft`` may propose tokens for ``verify`` to check.

    ``None`` (the n-gram CacheTable) is always legal — free drafts cost
    nothing to be wrong.  A model draft must itself be decode-legal
    (it runs the same single-step kernels) and STRICTLY cheaper than the
    verify schedule — reuse_factor strictly higher, the cheap side of the
    paper's R asymmetry.  Equal-or-denser drafts would pay more per draft
    than verification recovers; they are pruned, not penalized.
    """
    if draft is None:
        return True
    return (decode_legal(draft)
            and draft.reuse_factor > verify.reuse_factor)


def enumerate_speculative_space(cfg: ModelConfig,
                                spec: Optional[SpaceSpec] = None, *,
                                ks: Tuple[int, ...] = (1, 2, 4, 8),
                                include_ngram: bool = True
                                ) -> Tuple[Tuple[Optional[KernelSchedule],
                                                 KernelSchedule, int], ...]:
    """Every legal (draft, verify, K) triple: verify ranges over the
    decode-legal slice (RNN families via ``enumerate_decode_space``,
    dense stacks via ``lm_decode_schedules``), drafts over the same slice
    restricted by ``speculative_draft_legal`` plus the free n-gram draft
    (``None``) when ``include_ngram``.  Deterministic order: sorted by
    (verify key, draft key or '', K)."""
    if cfg.rnn is not None:
        pool = enumerate_decode_space(cfg, spec)
    else:
        pool = lm_decode_schedules(cfg, spec)
    triples = []
    for verify in pool:
        drafts: Tuple[Optional[KernelSchedule], ...] = tuple(
            d for d in pool if speculative_draft_legal(d, verify))
        if include_ngram:
            drafts = (None,) + drafts
        for draft in drafts:
            for k in ks:
                if k < 1:
                    continue        # K=0 is "speculation off", not a point
                triples.append((draft, verify, k))
    triples.sort(key=lambda t: (t[1].key(),
                                "" if t[0] is None else t[0].key(), t[2]))
    return tuple(triples)
