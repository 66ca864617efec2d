"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified]
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    mlp_type="swiglu",
    norm_type="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
