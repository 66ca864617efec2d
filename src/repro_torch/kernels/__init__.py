"""Scan kernels of the port: CUDA sources in ``csrc/``, their wrappers and
plain versions (``lstm_scan``, ``gru_scan``), the build and launch counters
(``cuda``), the golden references (``ref``) and the scheduled dispatch
(``ops``).  Importing builds nothing: a kernel is built at first launch."""
