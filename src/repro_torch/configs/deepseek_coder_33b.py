"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.

Llama architecture (SwiGLU, RMSNorm, RoPE). [arXiv:2401.14196; hf]
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=100000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=8,   # 33B on 16GiB chips: moments+grads leave little headroom
)
