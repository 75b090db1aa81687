"""radiobench: the benchmark of the PyTorch and CUDA port
(``rustradio_tpu_torch``) on one NVIDIA card.

    python -m radiobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line: see
``run.py``.  The cells, configurations, traffic, generators, drivers,
metrics and references are files of their own under this directory, found by name
(``harness.py``)."""
