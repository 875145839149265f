"""The benchmark of the PyTorch / CUDA port (``litepi_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``python3 -m cardbench
--help``).  Configurations, traffic mixes, limits and per-layer metric
readers are files of their own under this directory, found by name
(``cardbench/spec.py``)."""
