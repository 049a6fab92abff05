"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, dataset,
per-layer metric or reference sits in a file of its own under this
directory, found by the name ``BENCHMARK.json`` gives it (``manifest.py``).
"""
