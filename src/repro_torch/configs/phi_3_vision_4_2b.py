"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064. phi3-mini backbone + CLIP frontend (a stub: precomputed patch
embeddings prepended to the token sequence, through ``img_proj/w``).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""

from repro_torch.config import ModelConfig

N_PATCH_TOKENS = 576  # 24x24 CLIP-L/14 patch grid @ 336px (stubbed)

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
    frontend="vision",
    n_frontend_tokens=N_PATCH_TOKENS,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=2,
)
