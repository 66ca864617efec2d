"""Kernels of the port: CUDA sources in ``csrc/``, their wrappers and
plain versions (``lstm_scan``, ``gru_scan``, ``reuse_matmul``,
``quantized``, ``fixed_point``, ``decode_step``, ``rglru_scan``,
``hadamard``), the build and launch counters (``cuda``), the golden
references (``ref``) and the scheduled dispatch and weight residency
(``ops``).  Importing builds nothing: a kernel is built at first launch."""
