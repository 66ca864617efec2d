"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) d_ff=1408/expert,
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The JAX package's config, field for field; ``compute_dtype`` is set
explicitly (the port's default differs).
"""

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
                  capacity_factor=1.25),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=4,
)
