"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

Squared-ReLU MLP, GQA. [arXiv:2402.16819; unverified]
Largest assigned arch — dry-run uses bf16 params + heavy grad accumulation.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=8,   # §Perf NEM-2: accum 4 cut wire 22% but peak 36->49GB; 8 is the HBM pareto
)
