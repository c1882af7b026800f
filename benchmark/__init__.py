"""The benchmark of the PyTorch and CUDA port (``inverse_flow_tpu_torch``):
see ``benchmark/README.md`` and ``BENCHMARK.json``."""
