"""The port's benchmark: one data-driven harness (``run.py``) over the
configurations, traffic mixes and per-layer metrics named in
``BENCHMARK.json``, each a file of its own under this folder."""
