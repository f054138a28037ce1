"""The benchmark of ``sudo_rm_rf_tpu_torch`` on one NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own under ``configs/``, ``traffic/`` and ``metrics/``, found by
the name that ``BENCHMARK.json`` gives it.
"""
