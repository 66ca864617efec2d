"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s layout.  It serves the paper's LSTM/GRU taggers
(``configs``) through ``serving.RNNServingEngine`` on hand-written CUDA
kernels (``csrc/*.cu``, wrapped in ``kernels/``): every float schedule, and
the fixed-point datapaths (``core/quant``; native int8/int4 on
``quant_matmul``, the ap_fixed emulation on the quantized cells).  The
single-step decode of the taggers and of the dense decoder LMs (gemma-2b,
stablelm-3b; ``models/decode.py``) runs on ``decode_matmul``, served by
``serving.LMServingEngine``.  The package imports neither ``jax`` nor
``repro``; entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``.
"""
