"""whisper-medium [audio]: enc-dec, 24+24L d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865. [arXiv:2212.04356; unverified]

The conv frontend is a stub: ``transformer.forward`` takes precomputed
frame embeddings [B, T, d_model] (``frame_embeds``) through the encoder.
Decode serves the decoder half: one token a step, self-attention over
its KV cache and cross-attention over ``cache/xk`` / ``cache/xv``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    enc_dec=True,
    n_layers=24,               # per stack (24 encoder + 24 decoder)
    n_encoder_layers=24,
    n_decoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    frontend="audio",
    max_encoder_len=1500,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

# decoder text length used in train cells (whisper max target length)
TRAIN_TEXT_LEN = 448
