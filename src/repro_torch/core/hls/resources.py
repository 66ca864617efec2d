"""FPGA part catalogue (paper Sec. 5), DSP packing rules, and the
schedule-driven latency/resource estimator.

The port's copy of the JAX package's ``core/hls/resources.py``: pure
Python on the same integers and floats, so every estimate equals the JAX
package's field for field.  ``estimate_schedule`` consumes the SAME
:class:`KernelSchedule` object the scan kernels execute (kernels/ops.py):
the latency-cycle count is the schedule's sequential step count (time x
R, plus the pipe depth), and the DSP / BRAM numbers describe the weight
tile that schedule keeps live.  Every number here is the paper's FPGA
model at ``clock_mhz``, never a time measured on the card.

``vmem_bytes`` / ``weight_vmem_bytes`` keep the JAX package's names so
that ``report_row`` compares key for key with it: they come from that
package's analytic on-chip model of a kernel step (live weight tile,
scratch and state), not from the H100's shared memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.quant.fixed_point import is_native_int, packed_weight_bytes
from repro_torch.kernels.schedule import KernelSchedule


def _act_itemsize(fp) -> int:
    """Bytes per live activation/state element: native int datapaths hold
    int8 grid indices (1 byte); float and emulated fp paths hold f32."""
    return 1 if is_native_int(fp) else 4


@dataclass(frozen=True)
class FPGAPart:
    name: str
    dsp: int
    ff: int
    lut: int
    bram_18k: int


FPGA_PARTS = {
    # Xilinx Kintex UltraScale (top/flavor tagging target)
    "xcku115": FPGAPart("xcku115-flvb2104-2-i", dsp=5520, ff=1326720,
                        lut=663360, bram_18k=4320),
    # Xilinx Alveo U250 (QuickDraw target)
    "u250": FPGAPart("xcu250-figd2104-2-e", dsp=12288, ff=3456000,
                     lut=1728000, bram_18k=5376),
    # Virtex UltraScale+ VU9P single SLR (CMS L1T phase-2 candidate)
    "vu9p_slr": FPGAPart("xcvu9p (1 SLR)", dsp=2280, ff=788160,
                         lut=394080, bram_18k=1440),
}


def gate_count(cell: str) -> int:
    """Gates per recurrent cell: LSTM i|f|c|o = 4, GRU r|z|n = 3 — the
    paper's 4:3 LSTM:GRU resource ratio (Sec. 5.2).  The single source of
    truth for the pricing bridge (resources.py, design.py, autotune)."""
    return 4 if cell == "lstm" else 3


def resolved_axes(schedule: KernelSchedule, rnn) -> "tuple[int, int]":
    """(effective reuse, effective hoist reuse) the kernels actually execute.

    The kernels clamp both reuse axes to divisors of the gate dimension
    (ops.py via ``effective_reuse`` / gcd), so every consumer of a schedule's
    price — ``estimate_schedule``, the table-calibrated design bridge, the
    autotune explorer — must resolve the same divisors or it would price a
    schedule that never runs.  This helper is that shared resolution.
    """
    gate_dim = gate_count(rnn.cell) * rnn.hidden
    return (schedule.effective_reuse(gate_dim),
            math.gcd(schedule.hoist_reuse, gate_dim))


def mults_per_dsp(total_bits: int) -> float:
    """DSP48E2 is a 27x18 multiplier: below 18 bits one mult per DSP; the
    paper observes DSP usage flat until the precision exceeds the DSP input
    width, then doubling (Fig. 3)."""
    if total_bits <= 18:
        return 1.0
    if total_bits <= 27:
        return 2.0
    return 4.0


# ---------------------------------------------------------------------------
# Schedule-driven estimates (the software side of the paper's Fig. 1 curve)
# ---------------------------------------------------------------------------

# pipeline depth of one reuse pass (activation LUT + accumulate), cycles
_C_PIPE = 4


@dataclass(frozen=True)
class ScheduleEstimate:
    """What one (cell, schedule) point costs, in paper units.

    latency_cycles  end-to-end cycles for ONE inference — grows with R.
                    The recurrence chain seq_len x R is irreducible (h_t
                    depends on h_{t-1}); hoisting adds the front-stage GEMM
                    cycles but halves the per-step working set, and
                    pipeline mode keeps this chain while dropping II.
    ii_cycles       cycles before the next inference can enter — the
                    II-based throughput axis: seq_len x R (static), one
                    block (nonstatic), or the schedule's explicit ``ii``
                    target (pipeline: slimmed hoisted blocks free up after
                    their hU tiles)
    dsp             parallel multipliers live at once (x seq_len blocks for
                    non-static/pipeline) — shrinks with R, and with
                    hoisting the replicated per-block mults drop from
                    (fin+h)*G*h to h*G*h (the shared hoist GEMM is counted
                    once)
    bram_18k        weight storage (non-static replicates per block; the
                    hoisted input weights are stored once)
    vmem_bytes      the JAX package's on-chip model: live weight tile +
                    scratch per kernel step (not the card's shared memory)
    weight_vmem_bytes  the weight portion of vmem_bytes alone — under a
                    native int fp this is the PACKED layout's bytes
                    (``packed_weight_bytes``: int8 /4, int4 /8 vs f32),
                    identical to what the residency cache measures
    """

    schedule: KernelSchedule
    latency_cycles: int
    ii_cycles: int
    dsp: int
    bram_18k: int
    vmem_bytes: int
    weight_vmem_bytes: int = 0

    def latency_us(self, clock_mhz: float = 200.0) -> float:
        return self.latency_cycles / clock_mhz

    def throughput_eps(self, clock_mhz: float = 200.0) -> float:
        return clock_mhz * 1e6 / max(self.ii_cycles, 1)

    def service_s(self, clock_mhz: float = 200.0) -> float:
        """End-to-end service time of one event, in seconds — the latency
        half of the streaming pipeline's single-server queue model."""
        return self.latency_us(clock_mhz) * 1e-6

    def ii_s(self, clock_mhz: float = 200.0) -> float:
        """Initiation interval in seconds — the server occupancy per event
        (the next event may enter after this, even while the previous one
        is still in flight on a pipelined design)."""
        return max(self.ii_cycles, 1) / (clock_mhz * 1e6)

    def report_row(self, clock_mhz: float = 200.0) -> dict:
        """The analytical column of the serving layer's measured-vs-
        analytical table, keyed exactly like the measured one."""
        return {
            "schedule_key": self.schedule.key(),
            "latency_cycles": self.latency_cycles,
            "latency_us": self.latency_us(clock_mhz),
            "ii_cycles": self.ii_cycles,
            "throughput_eps": self.throughput_eps(clock_mhz),
            "dsp": self.dsp,
            "bram_18k": self.bram_18k,
            "vmem_bytes": self.vmem_bytes,
            "weight_vmem_bytes": self.weight_vmem_bytes,
        }


def gate_mults(cell: str, input_size: int, hidden: int, *,
               hoisted: bool = False) -> int:
    """Multiplications of one recurrent step (kernel + recurrent matmul).

    ``hoisted=True`` counts only the recurrent (hU) half — the sequential
    working set once the input projection leaves the scan.
    """
    g = gate_count(cell)
    fan_in = hidden if hoisted else input_size + hidden
    return fan_in * g * hidden


def estimate_schedule(schedule: KernelSchedule, rnn, fp=None
                      ) -> ScheduleEstimate:
    """Latency/resource estimate derived from the schedule object itself.

    ``rnn`` is an ``RNNConfig``; ``fp`` an optional ``FixedPointConfig``
    (defaults to the paper's ap_fixed<16,6>).  Monotone by construction:
    latency_cycles rises and dsp falls as reuse_factor grows.

    II-based pricing of the hoisted/pipelined variants: the hoisted input
    GEMM is a shared fully-pipelined front stage (its cycles add once to
    latency; its multipliers/weights are NOT replicated per block), the
    sequential blocks carry only hU, and pipeline mode's II is the
    schedule's explicit ``ii`` target — exactly the structure the kernels
    in ops.py execute.
    """
    total_bits = fp.total_bits if fp is not None else 16
    g = gate_count(rnn.cell)
    # price what EXECUTES: the kernels clamp reuse to a divisor of the gate
    # dim (ops.py), so the estimate must use the same effective R or it
    # would describe a schedule that never runs
    R, hr = resolved_axes(schedule, rnn)
    hoist = schedule.hoist_input
    mults_seq = gate_mults(rnn.cell, rnn.input_size, rnn.hidden,
                           hoisted=hoist)
    mults_in = rnn.input_size * g * rnn.hidden            # the hoisted GEMM

    # latency/II in kernel sequential steps (time x R_eff, the JAX
    # package's grid length), each step costing a pipeline constant.  The
    # recurrence chain seq_len x R is irreducible; the hoist stage adds its
    # own pipelined pass (hr tiles) up front.
    latency = rnn.seq_len * R + _C_PIPE + (hr + _C_PIPE if hoist else 0)
    if schedule.mode == "static":
        ii = rnn.seq_len * R
    elif schedule.mode == "pipeline":
        # hoisted blocks free up after their R hU-tiles, so the next
        # inference enters at the schedule's ii target
        ii = schedule.initiation_interval(rnn.seq_len)
    else:
        ii = R + _C_PIPE

    # parallel multipliers per block = sequential mults / R; non-static and
    # pipeline have seq_len blocks in silicon (Fig. 6 resource blowup).
    # The hoist GEMM's multipliers are shared across blocks — added once.
    blocks = rnn.seq_len if schedule.mode in ("nonstatic", "pipeline") else 1
    pack = mults_per_dsp(total_bits)
    dsp = int(-(-mults_seq // R) * pack) * blocks
    weight_bits = mults_seq * total_bits
    bram = int(-(-weight_bits // 18432)) * blocks
    if hoist:
        dsp += int(-(-mults_in // hr) * pack)
        bram += int(-(-(mults_in * total_bits) // 18432))

    # on-chip model: live weight column tile + gate scratch + state;
    # hoisting swaps the (fin+h) x gw tile for h x gw plus the streamed zx
    # tile.  The
    # pipeline kernel unrolls its R passes in-block with the full U
    # resident (the replicated-resources design it executes).  The weight
    # bytes come from packed_weight_bytes — the SAME formula the residency
    # packer realizes (f32, or the native int8/int4 packed layout) — and
    # activations/state shrink to 1 byte on the native datapath.
    gw = (g * rnn.hidden) // R
    bt = schedule.block_batch
    fan_in = rnn.hidden if hoist else rnn.input_size + rnn.hidden
    if schedule.mode == "pipeline":
        weight_vmem = packed_weight_bytes(rnn.hidden, g * rnn.hidden, fp)
    else:
        weight_vmem = packed_weight_bytes(fan_in, gw, fp)
    act = _act_itemsize(fp)
    vmem = weight_vmem + act * (
        bt * g * rnn.hidden                     # z/zh scratch
        + (bt * g * rnn.hidden if hoist else 0)  # zx stream tile
        + 2 * bt * rnn.hidden)                   # h, c state
    return ScheduleEstimate(schedule=schedule, latency_cycles=latency,
                            ii_cycles=ii, dsp=dsp, bram_18k=bram,
                            vmem_bytes=vmem, weight_vmem_bytes=weight_vmem)


# ---------------------------------------------------------------------------
# Throughput -> admission-rate bridge (the streaming pipeline's runtime gate)
# ---------------------------------------------------------------------------


def admission_rate_eps(estimate: ScheduleEstimate,
                       clock_mhz: float = 200.0, *,
                       utilization: float = 1.0) -> float:
    """Events/s an admission gate may let through for one priced schedule.

    This is the bridge that turns a :class:`DesignTarget` budget into a
    RUNTIME guarantee: the analytical initiation-interval throughput of the
    resolved schedule (``estimate.throughput_eps`` — the same number the
    explorer's feasibility check read) becomes the refill rate of the
    streaming pipeline's token bucket, derated by ``utilization``
    (queueing theory: a single-server queue is only stable below 1.0;
    1.0 is exact for deterministic arrivals, bursty traffic should derate).
    Arrivals beyond this rate are shed at ingest instead of growing an
    unbounded queue the design can never drain.
    """
    if not 0.0 < utilization <= 1.0:
        raise ValueError(f"utilization must be in (0, 1]: {utilization}")
    return utilization * estimate.throughput_eps(clock_mhz)


# ---------------------------------------------------------------------------
# Single-step decode estimates (the paper's single-event, II ~ R regime)
# ---------------------------------------------------------------------------


def estimate_decode_step(schedule: KernelSchedule, rnn, fp=None
                         ) -> ScheduleEstimate:
    """What one scheduled RNN decode step costs — the single-event engine.

    The decode kernel (kernels/decode_step.py) runs the gate matmuls
    ``[B, d] @ [d, G*h]`` (d = input + hidden) as R column-tile passes
    unrolled in-block with the FULL weight matrix resident, so:

      latency_cycles  one step = the R sequential tile passes + pipe depth
                      (no seq_len factor — the state update IS the step)
      ii_cycles       ~ R: the block frees after its own tile passes, the
                      next event enters immediately (paper II 1-in-R)
      dsp             live multipliers per pass = d x G*h / R (x DSP pack)
      bram_18k        the resident weight store — R tiles storage, not 1/R:
                      residency trades multipliers, not memory
      vmem_bytes      full weight + gate scratch + state (on-chip model)
    """
    total_bits = fp.total_bits if fp is not None else 16
    g = gate_count(rnn.cell)
    gate_dim = g * rnn.hidden
    R = schedule.effective_reuse(gate_dim)
    d_in = rnn.input_size + rnn.hidden
    mults = d_in * gate_dim
    pack = mults_per_dsp(total_bits)
    bt = schedule.block_batch
    # resident weights = the TWO matrices the decode step actually packs
    # (W: input x G*h, U: hidden x G*h) — per-matrix packed_weight_bytes so
    # the estimate equals the residency cache's measured packed nbytes
    weight_vmem = (packed_weight_bytes(rnn.input_size, gate_dim, fp)
                   + packed_weight_bytes(rnn.hidden, gate_dim, fp))
    act = _act_itemsize(fp)
    return ScheduleEstimate(
        schedule=schedule,
        latency_cycles=R + _C_PIPE,
        ii_cycles=R,
        dsp=int(-(-mults // R) * pack),
        bram_18k=int(-(-(mults * total_bits) // 18432)),
        vmem_bytes=weight_vmem + act * (bt * gate_dim + bt * d_in
                                        + 2 * bt * rnn.hidden),
        weight_vmem_bytes=weight_vmem)


def estimate_lm_decode(schedule: KernelSchedule, cfg, fp=None
                       ) -> ScheduleEstimate:
    """Per-token estimate of the scheduled dense-decoder step (the LM
    serving engine's decode path) from the SAME schedule object the keyed
    decoder executes.

    The scheduled step is a chain of fused matmuls per layer — q|k|v
    (gate-fused), attention out, MLP in (gate-fused), MLP down — each run
    as R in-block column-tile passes over resident weights.  Latency sums
    the chain (each matmul: its effective R passes + pipe depth); II is the
    widest matmul's R (the paper's single-token initiation interval); DSP
    counts every layer's live multipliers (all layers resident, like the
    non-static scan pricing); BRAM/VMEM hold the full resident weights.
    """
    total_bits = fp.total_bits if fp is not None else 16
    d, f = cfg.d_model, cfg.d_ff
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    glu = cfg.mlp_type in ("swiglu", "geglu")
    # (d_in, d_out) of each fused matmul in the per-layer chain
    chain = [(d, (hq + 2 * hk) * hd),            # q|k|v gate-fused
             (hq * hd, d),                       # attention out
             (d, 2 * f if glu else f),           # MLP in (gate|up fused)
             (f, d)]                             # MLP down
    pack = mults_per_dsp(total_bits)
    latency = dsp = bram = vmem_w = 0
    ii = 1
    for d_in, d_out in chain:
        R = schedule.effective_reuse(d_out)
        mults = d_in * d_out
        latency += R + _C_PIPE
        ii = max(ii, R)
        dsp += int(-(-mults // R) * pack)
        bram += int(-(-(mults * total_bits) // 18432))
        vmem_w += packed_weight_bytes(d_in, d_out, fp)
    L = cfg.n_layers
    bt = schedule.block_batch
    act = _act_itemsize(fp)
    return ScheduleEstimate(
        schedule=schedule,
        latency_cycles=L * latency,
        ii_cycles=ii,
        dsp=L * dsp,
        bram_18k=L * bram,
        vmem_bytes=L * vmem_w + act * (bt * max(o for _, o in chain)
                                       + 2 * bt * d),
        weight_vmem_bytes=L * vmem_w)


# ---------------------------------------------------------------------------
# Speculative decode pricing (draft cheap on high R, verify dense on R1)
# ---------------------------------------------------------------------------


def expected_round_tokens(k: int, accept_rate: float) -> float:
    """Expected tokens emitted per speculative round at draft depth ``k``
    and per-draft acceptance probability ``accept_rate`` (independent
    drafts): the truncated geometric sum ``(1 - a^(k+1)) / (1 - a)`` —
    between 1 (reject-all) and ``k + 1`` (accept-all, the bonus token
    included)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1]: {accept_rate}")
    if accept_rate == 1.0:
        return float(k + 1)
    return (1.0 - accept_rate ** (k + 1)) / (1.0 - accept_rate)


@dataclass(frozen=True)
class SpeculativeEstimate:
    """What one speculative (draft, verify, K) triple costs per round.

    ``draft=None`` prices the free n-gram ``CacheTable`` draft (zero
    cycles, zero silicon); a schedule drafts on the model itself — K
    sequential steps at the cheap schedule's latency.  The verify pass is
    ONE batched K+1-position program on the dense schedule: its first
    position costs the full pipeline latency, each further position one
    more initiation interval (the paper's II-limited steady state).

      cycles_per_round = K x draft.latency + verify.latency
                         + K x max(verify.ii, 1)
      tokens_per_cycle = expected_round_tokens(K, accept_rate) / cycles

    ``speedup_vs_sequential`` compares against K=0 sequential decode on
    the SAME verify schedule (one token per verify latency) — exactly 1.0
    at K=0, by construction.  Resources are the sum of both resident
    datapaths: speculation buys its tokens/s with the draft schedule's
    (cheap) silicon, never with accuracy."""

    draft: Optional[ScheduleEstimate]
    verify: ScheduleEstimate
    k: int
    accept_rate: float
    expected_tokens: float
    cycles_per_round: float
    tokens_per_cycle: float
    dsp: int
    bram_18k: int

    def speedup_vs_sequential(self) -> float:
        return self.tokens_per_cycle * float(self.verify.latency_cycles)

    def tokens_per_s(self, clock_mhz: float = 200.0) -> float:
        return self.tokens_per_cycle * clock_mhz * 1e6

    def latency_us_per_token(self, clock_mhz: float = 200.0) -> float:
        return (self.cycles_per_round / max(self.expected_tokens, 1e-12)
                / clock_mhz)

    def report_row(self, clock_mhz: float = 200.0) -> dict:
        return {
            "k": self.k,
            "draft_key": (None if self.draft is None
                          else self.draft.schedule.key()),
            "verify_key": self.verify.schedule.key(),
            "accept_rate": self.accept_rate,
            "expected_tokens": self.expected_tokens,
            "cycles_per_round": self.cycles_per_round,
            "tokens_per_cycle": self.tokens_per_cycle,
            "tokens_per_s": self.tokens_per_s(clock_mhz),
            "speedup_vs_sequential": self.speedup_vs_sequential(),
            "dsp": self.dsp,
            "bram_18k": self.bram_18k,
        }


def estimate_speculative(draft_est: Optional[ScheduleEstimate],
                         verify_est: ScheduleEstimate, k: int,
                         accept_rate: float) -> SpeculativeEstimate:
    """Price a (draft, verify, K) speculative triple analytically.

    ``draft_est=None`` is the n-gram table draft (free); otherwise the
    draft schedule pays K sequential single-step latencies per round.
    The verify pass pays one dense latency plus K extra initiation
    intervals for the batched positions.  At ``k=0`` the round IS the
    sequential step (no drafts, no extra positions): tokens_per_cycle is
    exactly ``1 / verify.latency_cycles`` and the speedup is exactly 1.
    """
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    exp_tok = expected_round_tokens(k, accept_rate)
    draft_cycles = 0.0 if draft_est is None \
        else float(k * draft_est.latency_cycles)
    cycles = (draft_cycles + float(verify_est.latency_cycles)
              + float(k * max(verify_est.ii_cycles, 1)))
    dsp = verify_est.dsp + (0 if draft_est is None else draft_est.dsp)
    bram = verify_est.bram_18k + (0 if draft_est is None
                                  else draft_est.bram_18k)
    return SpeculativeEstimate(
        draft=draft_est, verify=verify_est, k=k, accept_rate=accept_rate,
        expected_tokens=exp_tok, cycles_per_round=cycles,
        tokens_per_cycle=exp_tok / cycles, dsp=dsp, bram_18k=bram)
