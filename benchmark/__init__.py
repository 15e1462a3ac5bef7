"""The benchmark of trinity_tpu_torch on the card: see run.py and BENCHMARK.json."""
