"""The benchmark of the PyTorch and CUDA port (``aegis_tpu_torch``).

``python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the machine's GPU
and prints one JSON result line; ``README.md`` says how to add a cell, a
configuration or a metric as files alone.
"""
