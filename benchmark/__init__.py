"""The benchmark of the PyTorch/CUDA port ``difusion_tpu_torch``.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Configurations, traffic mixes and
per-layer metrics are files found by name (``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``).
"""
