"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells,
traffic, metric readers, drivers and the plain reference, found by the
names in ``BENCHMARK.json``."""
