"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s layout.  This slice serves the paper's LSTM/GRU taggers
(``configs``) through ``serving.RNNServingEngine`` on hand-written CUDA scan
kernels (``csrc/rnn_scan.cu``, wrapped in ``kernels/lstm_scan.py`` and
``kernels/gru_scan.py``).  The package imports neither ``jax`` nor
``repro``; entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``.
"""
