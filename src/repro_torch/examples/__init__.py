"""The port's examples, run as ``python -m repro_torch.examples.<name>``:
``quickstart``, ``serve_tagger``, ``streaming_scenarios``,
``quantization_scan`` and ``lm_pretrain`` (each on ``--device``, ``cuda``
unless the caller asks for ``cpu``)."""
