"""Analytical HLS design-space model for RNN layers — reproduces the paper's
latency / II / resource tables without Vivado.

The model encodes hls4ml's documented scaling laws:
  * static latency  = seq_len x (R_kernel + c_pipe) cycles       (Tables 2-4)
  * static II       = latency (a new inference waits for the whole sequence)
  * non-static II   = single-block II (=1 fully pipelined)        (Table 5)
  * non-static res  = seq_len x static resources                  (Fig. 6)
  * DSP             = (mults / R) x packing(W)  — flat in W until the DSP
                      input width (18b) is exceeded, then doubles  (Figs 3)
  * FF/LUT          ~ W x mults / R (+ base)  — linear in precision (Figs 4-5)
  * GRU : LSTM      = 3 : 4 in everything matmul-driven           (Sec. 5.2)
  * hoisted input   = kernel-GEMM mults leave the (replicated) sequential
                      blocks and come back once as a shared pipelined front
                      stage; pipeline mode II = the schedule's ii target

Pipeline constants c_pipe and the (constant-in-R) max-latency offsets are
calibrated per benchmark against Tables 2-4.  The port's copy of the JAX
package's ``core/hls/design.py``; ``tests/test_torch_hls.py`` holds it to
that package field for field and to every table entry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.config import FixedPointConfig, ModelConfig, RNNConfig
from repro_torch.core.hls.resources import (
    FPGA_PARTS,
    ScheduleEstimate,
    estimate_schedule,
    gate_count,
    mults_per_dsp,
    resolved_axes,
)
from repro_torch.kernels.schedule import KernelSchedule


# per-benchmark calibration: (c_pipe cycles, max-min latency offset cycles,
# latency-strategy per-step cycles)
_CALIB: Dict[str, Tuple[int, int, int]] = {
    "top-tagging": (20, 820, 17),
    "flavor-tagging": (37, 3620, 45),
    "quickdraw": (22, 25720, 40),
}
_DEFAULT_CALIB = (24, 2000, 20)


def _calib_for(name: str):
    for key, v in _CALIB.items():
        if key in name:
            return v
    return _DEFAULT_CALIB


@dataclass(frozen=True)
class RNNDesignPoint:
    cfg: ModelConfig
    fp: FixedPointConfig = field(default_factory=FixedPointConfig)
    reuse_kernel: int = 1
    reuse_recurrent: int = 1
    mode: str = "static"               # static | nonstatic | pipeline
    strategy: str = "resource"         # latency | resource
    part: str = "xcku115"
    clock_mhz: float = 200.0
    # hoisted input projection: the kernel (xW) GEMM runs as one shared
    # fully-pipelined front stage instead of inside every sequential block
    hoist_input: bool = False
    hoist_reuse: int = 1               # reuse of the hoisted front GEMM
    ii: int = 0                        # pipeline mode: target II in cycles
                                       # (0 = one block's reuse passes)


@dataclass(frozen=True)
class HLSDesign:
    latency_min_us: float
    latency_max_us: float
    ii_cycles: int
    dsp: int
    ff: int
    lut: int
    bram_18k: int
    throughput_eps: float              # events/second = clock / II
    fits: bool
    part: str

    def as_dict(self):
        return self.__dict__.copy()


def _rnn_mults(rnn: RNNConfig) -> Tuple[int, int, int]:
    """(kernel mults, recurrent mults, head mults) per timestep/inference."""
    g = gate_count(rnn.cell)
    mk = rnn.input_size * g * rnn.hidden
    mr = rnn.hidden * g * rnn.hidden
    mh = 0
    prev = rnn.hidden
    for w in rnn.dense_sizes:
        mh += prev * w
        prev = w
    mh += prev * rnn.n_outputs
    return mk, mr, mh


def estimate_design(pt: RNNDesignPoint) -> HLSDesign:
    cfg = pt.cfg
    rnn = cfg.rnn
    assert rnn is not None, "HLS model applies to the RNN tagger family"
    c_pipe, max_off, lat_step = _calib_for(cfg.name)
    cycle_us = 1.0 / pt.clock_mhz
    W = pt.fp.total_bits
    seq = rnn.seq_len

    mk, mr, mh = _rnn_mults(rnn)

    # --- latency / II ------------------------------------------------------
    if pt.strategy == "latency":
        per_step = lat_step
    else:
        per_step = pt.reuse_kernel + c_pipe
    rnn_latency = seq * per_step
    if pt.hoist_input:
        # the hoisted xW GEMM is one extra pipelined front-stage pass
        rnn_latency += max(pt.hoist_reuse, 1) + c_pipe
    latency_min = rnn_latency
    latency_max = rnn_latency + max_off

    if pt.mode == "static":
        ii = rnn_latency
    elif pt.mode == "pipeline":
        # hoisted blocks carry only the hU tiles: a new inference enters at
        # the explicit II target (default: one block's reuse passes)
        ii = max(pt.ii or pt.reuse_kernel, 1)
    else:
        # one block per timestep, state flows block->block: a new inference
        # enters once the first block frees up
        ii = max(per_step if pt.strategy != "latency" else 1, 1)
        if pt.strategy == "latency":
            ii = 1

    # --- resources ----------------------------------------------------------
    rk = 1 if pt.strategy == "latency" else pt.reuse_kernel
    rr = 1 if pt.strategy == "latency" else pt.reuse_recurrent
    # hoisting removes the kernel-GEMM mults from the (per-block, possibly
    # seq_len-replicated) sequential datapath; they come back once below as
    # a shared front stage
    mk_block = 0.0 if pt.hoist_input else mk / rk
    ops_parallel = mk_block + mr / rr + mh / max(rk, 1)
    if W >= 12:
        # multiplications map to DSP48s; packing doubles above 18b inputs
        dsp_one = ops_parallel * mults_per_dsp(W)
        lut_mult = 0.0
    else:
        # hls4ml synthesizes narrow mults into fabric LUTs (paper Fig. 6:
        # non-static at W=10 sits near the LUT line with ~0 DSP growth)
        dsp_one = 0.0
        lut_mult = 0.55 * W * ops_parallel
    import math as _m
    # reuse FSM/mux cost: zero when fully parallel (R=1, no multiplexing)
    reuse_mux = 40.0 * ops_parallel * _m.log2(max(rk, 1))
    ff_one = 0.6 * W * ops_parallel + 12.0 * ops_parallel \
        + 2.0 * W * rnn.hidden                      # pipeline regs
    lut_one = 0.35 * W * ops_parallel + lut_mult + reuse_mux \
        + 25.0 * rnn.hidden * W                     # activations (LUT tables)
    # BRAM: resource strategy keeps weights in BRAM (hoisted kernel weights
    # live in the shared front stage, not in every replicated block)
    n_weights = (0 if pt.hoist_input else mk) + mr + mh
    bram_one = (n_weights * W) / 18432.0 if pt.strategy == "resource" else 0.0

    mult = seq if pt.mode in ("nonstatic", "pipeline") else 1
    dsp = int(dsp_one * mult)
    ff = int(ff_one * mult)
    lut = int(lut_one * mult)
    bram = int(bram_one * mult)

    if pt.hoist_input:
        # shared hoisted front GEMM: mk mults at hoist_reuse, counted ONCE
        # (never replicated across the seq_len blocks)
        hr = max(pt.hoist_reuse, 1)
        hoist_ops = mk / hr
        if W >= 12:
            dsp += int(hoist_ops * mults_per_dsp(W))
        else:
            lut += int(0.55 * W * hoist_ops)
        ff += int(0.6 * W * hoist_ops)
        lut += int(0.35 * W * hoist_ops)
        if pt.strategy == "resource":
            bram += int((mk * W) / 18432.0)

    part = FPGA_PARTS[pt.part]
    # paper Sec 5.2: Vivado synthesis reduces HLS LUT estimates by 20-65%
    # and FF by 10-20%; the fits check uses the post-Vivado expectation.
    VIVADO_LUT, VIVADO_FF = 0.65, 0.85
    fits = (dsp <= part.dsp and ff * VIVADO_FF <= part.ff
            and lut * VIVADO_LUT <= part.lut and bram <= part.bram_18k)

    clock_hz = pt.clock_mhz * 1e6
    return HLSDesign(
        latency_min_us=latency_min * cycle_us,
        latency_max_us=latency_max * cycle_us,
        ii_cycles=int(ii),
        dsp=dsp, ff=ff, lut=lut, bram_18k=bram,
        throughput_eps=clock_hz / max(ii, 1),
        fits=fits,
        part=part.name,
    )


def design_point_for_schedule(cfg: ModelConfig, schedule: KernelSchedule,
                              fp: Optional[FixedPointConfig] = None,
                              **kw) -> RNNDesignPoint:
    """Bridge a kernel schedule to the table-calibrated design-space model:
    the SAME object that executes on the card (kernels/ops.py) prices the
    FPGA design, so sweeping schedules sweeps the paper's Fig. 1 curve.

    The reuse factor is clamped to the divisor the kernel actually executes
    (``resolved_axes`` — the SAME resolution ``estimate_schedule`` applies),
    keeping the priced design and the executed schedule in lockstep for
    non-divisor R requests.
    """
    assert cfg.rnn is not None
    r_eff, hr_eff = resolved_axes(schedule, cfg.rnn)
    return RNNDesignPoint(
        cfg, fp if fp is not None else FixedPointConfig(),
        reuse_kernel=r_eff,
        reuse_recurrent=r_eff,
        mode=schedule.mode,
        hoist_input=schedule.hoist_input,
        hoist_reuse=hr_eff,
        ii=schedule.ii, **kw)


def estimate_design_for_schedule(cfg: ModelConfig, schedule: KernelSchedule,
                                 fp: Optional[FixedPointConfig] = None,
                                 **kw) -> HLSDesign:
    return estimate_design(design_point_for_schedule(cfg, schedule, fp, **kw))


def schedule_estimate_for(cfg: ModelConfig, schedule: KernelSchedule,
                          fp: Optional[FixedPointConfig] = None
                          ) -> ScheduleEstimate:
    """Kernel-level (gate matmul) estimate from the same schedule object."""
    assert cfg.rnn is not None
    return estimate_schedule(schedule, cfg.rnn, fp)


# paper Sec. 5.2 GPU reference points (Nvidia V100, QuickDraw LSTM)
V100_THROUGHPUT_EPS = {1: 660.0, 10: 7700.0, 100: 30000.0}
