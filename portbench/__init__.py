"""Benchmark of the PyTorch / CUDA port (``cpu_tsdf_tpu_torch``) on one card.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line. See
``portbench/README.md``.
"""
