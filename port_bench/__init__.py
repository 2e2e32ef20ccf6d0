"""The benchmark of the PyTorch port (``mikudance_tpu_torch``): ``run.py``
runs one cell; ``BENCHMARK.json`` at the root names the cells and metrics."""
