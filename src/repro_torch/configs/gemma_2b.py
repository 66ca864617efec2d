"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU MLP, head_dim=256 (note: 8*256 = 2048), MQA on the 2b model.
[arXiv:2403.08295; hf]
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    logits_softcap=30.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=4,     # 256k-vocab f32 logits: keep microbatch loss under HBM
)
