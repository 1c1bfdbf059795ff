"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations, the traffic mixes and the metrics; the harness
(``perfbench/harness.py``) finds every file of a cell by those names.
Run one cell with::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
