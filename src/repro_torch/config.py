"""Configuration dataclasses of the paper's taggers, the LMs and training.

The port's copy of the parts of ``repro.config`` that the LSTM/GRU taggers,
the LMs (every family: dense, moe, ssm, hybrid, audio enc-dec, vlm; their
sequence forward and single-step decode) and the trainer use.  Configs are frozen (hashable) so they
can key caches and embed schedules.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.kernels.schedule import KernelSchedule


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style routed experts)."""

    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0          # always-on shared experts (DeepSeek/Qwen style)
    d_ff_expert: int = 0               # per-expert hidden dim (0 -> use d_ff)
    capacity_factor: float = 1.25      # train-time capacity (tokens dropped beyond)
    eval_capacity_factor: float = 2.0
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256              # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin RG-LRU configuration."""

    lru_width: int = 0                 # 0 -> d_model
    conv_width: int = 4
    window: int = 2048                 # local-attention window in hybrid blocks
    # repeating block pattern: 2 recurrent blocks then 1 local-attention block
    pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")


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
    """One architecture: a tagger (``family="rnn"``) or an LM (families
    dense | moe | ssm | hybrid | audio | vlm).

    The transformer and family fields and their defaults are
    ``repro.config``'s, with the three the sequence forward reads
    (``remat``, ``attn_chunk_q``, ``attn_chunk_kv``).  Four of
    ``repro``'s are not carried, since none changes a value on one
    device: ``scan_layers`` (the port loops over the stacked layers),
    ``probe_unroll`` (a cost-analysis mode of XLA), ``impl`` (the LM path
    has no kernel to choose) and ``seq_shard_residual`` (a sharding
    constraint).  Two defaults differ from ``repro``'s: ``family`` ("rnn",
    not "dense") and ``compute_dtype`` ("float32", not "bfloat16"); every
    LM config of the port sets both explicitly (``configs/*.py``).
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

    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    n_decoder_layers: int = 0
    max_encoder_len: int = 1500

    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    n_frontend_tokens: int = 0         # vision: number of patch tokens prepended

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "full"                # full | dots | none
    attn_chunk_q: int = 1024           # blockwise-attention query chunk
    attn_chunk_kv: int = 2048          # blockwise-attention kv chunk
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
        LM's (embeddings, layers, final norm), as ``repro`` counts it."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        if self.family == "rnn":
            if self.rnn is None:
                raise ValueError(f"{self.name}: family 'rnn' without rnn=")
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
        emb = V * d * (1 if self.tie_embeddings else 2)
        q_dim, kv_dim = self.qkv_dims
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) \
            * d * self.d_ff
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            per_layer = (
                d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
                + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)       # conv
                + n_heads * 2                                          # A_log, D
                + d_in * d                                             # out_proj
            )
            return emb // 2 + L * per_layer + 2 * d  # tied embedding, final norm
        if self.family == "moe":
            m = self.moe
            dff = m.d_ff_expert or self.d_ff
            mlp = m.n_experts * 3 * d * dff + d * m.n_experts
            mlp += m.n_shared_experts * 3 * d * dff
        if self.family == "hybrid":
            rg = self.rglru
            w = rg.lru_width or d
            n_rec = sum(1 for p in self._pattern_for_layers() if p == "rglru")
            n_att = L - n_rec
            rec = 2 * d * w + rg.conv_width * w + 3 * w + w * d  # in/out proj + conv + gates
            return (emb + n_rec * (rec + mlp + 2 * d)
                    + n_att * (attn + mlp + 2 * d) + d)
        per_layer = attn + mlp + 2 * d
        if self.enc_dec:
            # encoder + decoder stacks; decoder layers add cross-attention
            L = self.n_encoder_layers + self.n_decoder_layers
            return emb + L * per_layer + self.n_decoder_layers * (attn + d) + d
        return emb + L * per_layer + d

    def _pattern_for_layers(self):
        pat = self.rglru.pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.n_layers
        dff = m.d_ff_expert or self.d_ff
        q_dim, kv_dim = self.qkv_dims
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        mlp_active = ((m.top_k + m.n_shared_experts) * 3 * d * dff
                      + d * m.n_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + mlp_active + 2 * d) + d


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


# ---------------------------------------------------------------------------
# Shapes (the dry run's cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs whose state is sub-quadratic in context (run long_500k)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) dry-run cell runs, and why not if skipped."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: 524k dense KV decode out of scope (DESIGN.md §4)"
    return True, ""


# ---------------------------------------------------------------------------
# Hardware constants (the roofline's device)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareConfig:
    """One card's peaks, for the roofline (``launch/roofline.py``).

    ``H100`` is NVIDIA's data sheet for the H100 SXM (dense rates, no
    sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 on the
    tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3,
    80 GB.  ``link_bw`` is NVLink 4's data-sheet rate, 900 GB/s per GPU
    counting both directions (18 links of 50 GB/s), so 450 GB/s one way:
    the rate a ring collective's per-device wire bytes move at."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12    # per card
    peak_flops_f32: float = 67e12      # per card, outside the tensor cores
    hbm_bw: float = 3.35e12            # bytes/s per card
    link_bw: float = 450e9             # bytes/s per card, one direction
    hbm_bytes: int = 80 * 10 ** 9      # 80 GB


H100 = HardwareConfig()
