"""portbench: the benchmark of ``metrics_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line.  Cells, configurations, traffic mixes and per-layer
metrics are found by name: see ``portbench/README.md``.
"""
