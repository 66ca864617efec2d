"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) blocks: d_inner = 2*d_model = 3072, head_dim 64,
48 value heads, n_groups=1, conv width 4. [arXiv:2405.21060; unverified]

The SSD recurrence is a linear RNN; decode is the "static mode"
single-block state update (``models/ssm.py::ssm_decode_step``).
"""

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
    grad_accum=4,
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
