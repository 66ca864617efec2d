"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert,
vocab=151936, 128 routed experts top-8, no shared experts.
[hf:Qwen/Qwen3-30B-A3B; hf]

The JAX package's config, field for field; ``compute_dtype`` is set
explicitly (the port's default differs).
"""

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8, n_shared_experts=0, d_ff_expert=768,
                  capacity_factor=1.25),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=4,
)
