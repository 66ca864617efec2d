"""Configuration dataclasses of the paper's taggers, the dense LMs and
training.

The port's copy of the parts of ``repro.config`` that the LSTM/GRU taggers,
the dense decoder's single-step decode and the trainer use.  Configs are
frozen (hashable) so they can key caches and embed schedules.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
    """One architecture: a tagger (``family="rnn"``) or a dense decoder LM
    (``family="dense"``).

    The transformer fields and their defaults are ``repro.config``'s dense
    subset.  Two defaults differ from ``repro``'s: ``family`` ("rnn", not
    "dense") and ``compute_dtype`` ("float32", not "bfloat16"); every LM
    config of the port sets both explicitly (``configs/gemma_2b.py``,
    ``stablelm_3b.py``, ``deepseek_coder_33b.py``, ``nemotron_4_340b.py``).
    """

    name: str = "unnamed"
    family: str = "rnn"
    rnn: Optional[RNNConfig] = None

    # transformer backbone (dense decoder)
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                  # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1000
    mlp_type: str = "swiglu"           # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logits_softcap: float = 0.0        # gemma-style soft capping (0 = off)
    attn_window: int = 0               # 0 = full attention; >0 = local window

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    grad_accum: int = 1                # microbatch steps inside train_step

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def qkv_dims(self) -> Tuple[int, int]:
        return self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytical parameter count: the tagger's (Keras layout) or the
        dense decoder's (embeddings, layers, final norm)."""
        if self.family == "dense":
            d, V = self.d_model, self.vocab_size
            q_dim, kv_dim = self.qkv_dims
            attn = d * q_dim + 2 * d * kv_dim + q_dim * d
            mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) \
                * d * self.d_ff
            emb = V * d * (1 if self.tie_embeddings else 2)
            return emb + self.n_layers * (attn + mlp + 2 * d) + d
        if self.family != "rnn" or self.rnn is None:
            raise NotImplementedError(
                f"param_count covers the rnn and dense families, not "
                f"{self.family!r}")
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
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    state_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    grad_accum: int = 1
    loss_dtype: str = "float32"
    z_loss: float = 1e-4
    compress_grads: bool = False       # int8 gradient compression
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10


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
