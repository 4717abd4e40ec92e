"""The benchmark of ``upright_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  What
belongs to one configuration, traffic mix or metric is a file of its own
(``registry.py``); the plain reference the outputs are judged against is
``reference/``; the tests are under ``tests/``.
"""
