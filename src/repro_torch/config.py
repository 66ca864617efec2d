"""Configuration dataclasses of the paper's taggers.

The port's copy of the parts of ``repro.config`` that the LSTM/GRU taggers
use.  Configs are frozen (hashable) so they can key caches and embed
schedules.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.kernels.schedule import KernelSchedule


@dataclass(frozen=True)
class RNNConfig:
    """Paper-core recurrent layer configuration (LSTM / GRU taggers)."""

    cell: str = "lstm"                  # "lstm" | "gru"
    hidden: int = 20
    seq_len: int = 20
    input_size: int = 6
    dense_sizes: Tuple[int, ...] = (64,)
    n_outputs: int = 1
    output_activation: str = "sigmoid"  # "sigmoid" | "softmax"
    mode: str = "static"                # "static" | "nonstatic"
    # hls4ml-style knobs
    reuse_kernel: int = 1
    reuse_recurrent: int = 1
    # explicit kernel schedule; None derives one from the knobs above
    schedule: Optional[KernelSchedule] = None

    def kernel_schedule(self) -> KernelSchedule:
        """The schedule this layer executes: the explicit one, else static
        (or ``mode``) at R = ``reuse_kernel``."""
        if self.schedule is not None:
            return self.schedule
        return KernelSchedule(reuse_factor=self.reuse_kernel, mode=self.mode)


@dataclass(frozen=True)
class ModelConfig:
    """One tagger architecture (``family="rnn"``)."""

    name: str = "unnamed"
    family: str = "rnn"
    rnn: Optional[RNNConfig] = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytical parameter count of the tagger (Keras layout)."""
        if self.family != "rnn" or self.rnn is None:
            raise NotImplementedError(
                f"param_count covers the rnn family only, not {self.family!r}")
        r = self.rnn
        g = 4 if r.cell == "lstm" else 3
        n = g * (r.input_size * r.hidden + r.hidden * r.hidden + r.hidden)
        if r.cell == "gru":
            n += 3 * r.hidden  # keras GRU reset_after: separate recurrent bias
        prev = r.hidden
        for h in r.dense_sizes:
            n += prev * h + h
            prev = h
        n += prev * r.n_outputs + r.n_outputs
        return n


@dataclass(frozen=True)
class FixedPointConfig:
    """ap_fixed<total, integer>: the paper's quantization scheme."""

    total_bits: int = 16
    integer_bits: int = 6
    signed: bool = True
    rounding: str = "rnd"              # rnd (round-half-even) | trn (truncate)
    saturation: str = "sat"            # sat | wrap

    @property
    def fractional_bits(self) -> int:
        return self.total_bits - self.integer_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.fractional_bits)

    @property
    def max_value(self) -> float:
        sign = 1 if self.signed else 0
        return (2 ** (self.total_bits - sign) - 1) / self.scale

    @property
    def min_value(self) -> float:
        return -(2 ** (self.total_bits - 1)) / self.scale if self.signed else 0.0
