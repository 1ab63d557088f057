"""The benchmark of the PyTorch and CUDA port (``neurec_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how
to add a configuration, a traffic mix or a per-layer metric as files.
"""
