"""The port's benchmark: one run of one cell of ``BENCHMARK.json`` on the
PyTorch and CUDA package ``repro_torch`` (``python3 portbench/run.py``)."""
