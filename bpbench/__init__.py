"""The benchmark of ``broadphase_tpu_torch`` on a CUDA card: ``run.py``
runs one cell of ``BENCHMARK.json`` (see ``harness.py``)."""
