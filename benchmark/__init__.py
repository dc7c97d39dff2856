"""The benchmark of ``sdft_tpu_torch``: ``python3 -m benchmark.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once on the card and prints its result as the last line
of standard output (``run.py``)."""
