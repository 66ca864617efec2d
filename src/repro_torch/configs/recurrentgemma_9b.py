"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Griffin: RG-LRU + local attention, pattern (rglru, rglru, local).
[arXiv:2402.19427; unverified]

The RG-LRU layer is the paper's recurrent cell at LLM scale: a gated linear
recurrence with elementwise state update.  Decode keeps an O(1) LRU state
and a ring buffer of the local window.
"""

from repro_torch.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048,
                      pattern=("rglru", "rglru", "local_attn")),
    tie_embeddings=True,
    logits_softcap=30.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    grad_accum=4,
)
