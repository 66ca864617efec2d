"""granite-4.0-h-micro [hybrid]: 40L d_model=2048, 36 Mamba-2 layers and 4
full-attention layers, GQA 32/8 (head_dim 64), SwiGLU d_ff=8192 in every
layer, vocab=100352, tied embeddings.
[huggingface.co/ibm-granite/granite-4.0-h-micro config.json: model_type
granitemoehybrid with num_local_experts 0, so dense]

``layer_types`` puts attention at layers 5, 15, 25 and 35: four periods
of (mamba x 5, attention, mamba x 4).  The Mamba-2 mixer has mamba2-780m's
widths (64 heads of 64, d_state 128, one group, conv 4 with bias, chunk
256, expand 2: d_inner 4096); the attention has no positions (NoPE) and
Granite's softmax scale 1/64.  Granite's scalars: embeddings times 12,
each sublayer's output times 0.22 into the residual, logits over 8.

A port-only architecture: ``repro`` has no such model.  Its decode keeps
two kinds of state side by side: per Mamba layer a float32 SSM state and
the conv tail, per attention layer a full-length KV cache
(``models/decode.py::cache_specs``).
"""

from repro_torch.config import GraniteConfig, ModelConfig, SSMConfig

#: one period of ``layer_types``
PERIOD = ("mamba",) * 5 + ("attn",) + ("mamba",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    norm_eps=1e-5,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    pattern=PERIOD,
    granite=GraniteConfig(embedding_multiplier=12.0,
                          attention_multiplier=0.015625,
                          residual_multiplier=0.22, logits_scaling=8.0),
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
