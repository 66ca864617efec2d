"""Reuse-factor scheduling layer: ONE object that configures every scan
kernel of the port.

The paper's central knob is the hls4ml reuse factor: with reuse R each DSP
performs R multiplications per matrix product, so DSPs shrink by R while
latency grows by R (Tables 2-4), and the static / non-static mode choice
trades initiation interval against resource replication (Table 5, Fig. 6).
``KernelSchedule`` carries exactly those degrees of freedom plus the
execution backend, and is:

  * hashable / frozen: usable as a dict key and inside frozen configs;
  * honored by the scan kernels: gate matmuls are partitioned into
    ``reuse_factor`` *sequential column tiles* per timestep, so each
    thread block really walks ``sequential_steps(seq_len)`` dependent steps.

The keys this module produces are byte-identical to the JAX package's, so
a schedule names the same design point in both packages.

Dependency note: this module imports nothing from ``repro_torch`` so that
``repro_torch.config`` can embed schedules in frozen model configs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Iterable, Tuple

MODES = ("static", "nonstatic", "pipeline")
BACKENDS = ("auto", "xla", "pallas_interpret", "pallas_tpu")

#: queue key for requests that carry no schedule at all
DEFAULT_SCHEDULE_KEY = "default"


@dataclass(frozen=True)
class KernelSchedule:
    """How a scan kernel is scheduled on the latency–resource curve.

    reuse_factor  hls4ml reuse R: gate matmuls run as R sequential column
                  tiles per timestep; latency x R, parallel multipliers / R.
    mode          "static" — one weights-resident block scans the whole
                  sequence (paper Fig. 1 left, II = seq_len x R).
                  "nonstatic" — one block per timestep, state flows
                  block-to-block (Fig. 1 right, II = one block latency).
                  "pipeline" — NONSTATIC with the input projection hoisted
                  out of every block (implies ``hoist_input``).
    block_batch   batch granule: the scan wrappers pad the batch to a
                  multiple of min(block_batch, max(8, B)) rows before the
                  launch.  The CUDA kernels pick their rows per thread block
                  from the card's SM count, not from this field.
    backend       "xla" selects the golden reference (kernels/ref.py);
                  every other value ("auto", "pallas_interpret",
                  "pallas_tpu") selects the kernel path, which launches the
                  CUDA kernel on a CUDA tensor and runs the kernel's plain
                  version on a CPU tensor.
    hoist_input   compute the input projection xW for ALL timesteps as ONE
                  batched [B*T, fin] @ [fin, G*h] matmul outside the
                  sequential scan (only hU carries the recurrence).
    ii            pipeline mode only: target initiation interval in
                  sequential steps (0 = auto = reuse_factor).
    hoist_reuse   reuse factor of the hoisted input GEMM itself (1 = fully
                  parallel; >1 runs it as R-tiled sequential column passes).
    """

    reuse_factor: int = 1
    mode: str = "static"
    block_batch: int = 128
    backend: str = "auto"
    hoist_input: bool = False
    ii: int = 0
    hoist_reuse: int = 1

    def __post_init__(self):
        if self.reuse_factor < 1:
            raise ValueError(f"reuse_factor must be >= 1: {self.reuse_factor}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.block_batch < 1:
            raise ValueError(f"block_batch must be >= 1: {self.block_batch}")
        if self.ii < 0:
            raise ValueError(f"ii must be >= 0: {self.ii}")
        if self.hoist_reuse < 1:
            raise ValueError(f"hoist_reuse must be >= 1: {self.hoist_reuse}")
        if self.mode == "pipeline":
            # pipelining the block chain REQUIRES the hoist: only once the
            # xW GEMM leaves the blocks is a block slim enough to free up
            # after its hU tiles, letting the next inference enter at ii
            object.__setattr__(self, "hoist_input", True)
        elif self.ii:
            # ii is a pipeline-mode knob; normalize it away on other modes
            # (instead of raising) so replace(mode=...) stays total and the
            # normalized schedule keys/hashes equal the ii-free one
            object.__setattr__(self, "ii", 0)
        if self.hoist_reuse > 1 and not self.hoist_input:
            raise ValueError(
                "hoist_reuse > 1 without hoist_input: there is no hoisted "
                "input GEMM to tile")

    # -- backend resolution -------------------------------------------------

    @property
    def use_pallas(self) -> bool:
        """True for every kernel backend (the name is kept from the JAX
        package so both packages read the same field)."""
        return self.backend != "xla"

    # -- reuse partitioning -------------------------------------------------

    def effective_reuse(self, dim: int) -> int:
        """Largest divisor of ``dim`` that also divides ``reuse_factor``:
        column tiles must align with the packed gate layout, so ragged
        reuse requests degrade to the nearest feasible divisor."""
        return math.gcd(self.reuse_factor, dim)

    def sequential_steps(self, seq_len: int) -> int:
        """Dependent steps of one inference: time x reuse, in every mode."""
        return seq_len * self.reuse_factor

    def initiation_interval(self, seq_len: int) -> int:
        """Sequential steps before the NEXT inference can enter (paper II)."""
        if self.mode == "static":
            return seq_len * self.reuse_factor
        if self.mode == "pipeline":
            return max(self.ii or self.reuse_factor, 1)
        return self.reuse_factor

    # -- stable identity ----------------------------------------------------

    def key(self) -> str:
        """Stable, human-readable hash of the schedule: the co-batching key.

        Non-default axes append as suffix tokens (``-hoist``, ``-hrN``,
        ``-iiN``) so default schedules keep their short keys.
        """
        base = (f"{self.mode}-R{self.reuse_factor}"
                f"-bb{self.block_batch}-{self.backend}")
        if self.hoist_input:
            base += "-hoist"
        if self.hoist_reuse != 1:
            base += f"-hr{self.hoist_reuse}"
        if self.ii:
            base += f"-ii{self.ii}"
        return base

    # -- sweeping -----------------------------------------------------------

    def replace(self, **kw) -> "KernelSchedule":
        return replace(self, **kw)

    @classmethod
    def from_key(cls, key: str) -> "KernelSchedule":
        """Inverse of :meth:`key`; also accepts the fp-suffixed form
        ``schedule_key`` produces (the ``-apW_I_rnd_sat`` tail is ignored).

        The first four tokens are positional and REQUIRED (a malformed core
        raises ValueError); known later tokens (``hoist``, ``hrN``, ``iiN``)
        parse and unknown ones are ignored.
        """
        parts = key.split("-")
        if len(parts) < 4:
            raise ValueError(f"not a schedule key: {key!r}")
        mode, r, bb, backend = parts[:4]
        if not (r.startswith("R") and r[1:].isdigit()
                and bb.startswith("bb") and bb[2:].isdigit()):
            raise ValueError(f"not a schedule key: {key!r}")
        kw = dict(reuse_factor=int(r[1:]), mode=mode,
                  block_batch=int(bb[2:]), backend=backend)
        for tok in parts[4:]:
            if tok == "hoist":
                kw["hoist_input"] = True
            elif tok.startswith("hr") and tok[2:].isdigit():
                kw["hoist_reuse"] = int(tok[2:])
            elif tok.startswith("ii") and tok[2:].isdigit():
                kw["ii"] = int(tok[2:])
        return cls(**kw)

    @classmethod
    def sweep(cls, reuse_factors: Iterable[int] = (1, 2, 4, 8),
              modes: Iterable[str] = MODES, *, block_batch: int = 128,
              backend: str = "auto") -> Tuple["KernelSchedule", ...]:
        """The paper's Fig. 1 sweep grid as schedule objects."""
        return tuple(cls(reuse_factor=r, mode=m, block_batch=block_batch,
                         backend=backend)
                     for m in modes for r in reuse_factors)


def cache_meta(schedule: "KernelSchedule | None", fp=None) -> dict:
    """Exhaustive (schedule, fp) identity: every dataclass field of the
    schedule and the fixed-point config lands in the dict, unlike the
    forward-compatible routing key."""
    from dataclasses import asdict, is_dataclass

    meta: dict = {"schedule": (None if schedule is None
                               else asdict(schedule))}
    if fp is None:
        meta["fp"] = None
    elif is_dataclass(fp):
        meta["fp"] = asdict(fp)
    else:
        meta["fp"] = repr(fp)
    return meta


def schedule_key(schedule: "KernelSchedule | None", fp=None) -> str:
    """Stable co-batching key for a (schedule, fixed-point config) pair.

    ``fp`` is duck-typed (anything with ``total_bits`` / ``integer_bits``);
    ``None`` fp means the float datapath.
    """
    base = DEFAULT_SCHEDULE_KEY if schedule is None else schedule.key()
    if fp is None:
        return base
    rounding = getattr(fp, "rounding", "rnd")
    saturation = getattr(fp, "saturation", "sat")
    return (f"{base}-ap{fp.total_bits}_{fp.integer_bits}"
            f"_{rounding}_{saturation}")
