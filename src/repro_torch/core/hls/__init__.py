"""The paper's FPGA pricing: the schedule-driven estimator
(``resources``), the table-calibrated HLS design model (``design``) and the
unified priced point (``design_point``).  Pure Python, the port's own copy
of the JAX package's ``core/hls``; every number is the FPGA model's at a
clock, never a time on the card."""
from repro_torch.core.hls.design import (  # noqa: F401
    HLSDesign,
    RNNDesignPoint,
    design_point_for_schedule,
    estimate_design,
    estimate_design_for_schedule,
    schedule_estimate_for,
)
from repro_torch.core.hls.design_point import (  # noqa: F401
    PARETO_AXES,
    DesignPoint,
    price_decode_point,
    price_point,
)
from repro_torch.core.hls.resources import (  # noqa: F401
    FPGA_PARTS,
    ScheduleEstimate,
    SpeculativeEstimate,
    admission_rate_eps,
    estimate_decode_step,
    estimate_lm_decode,
    estimate_schedule,
    estimate_speculative,
    expected_round_tokens,
    gate_count,
    resolved_axes,
)
