"""The benchmark of the PyTorch and CUDA port (``hippyflow_tpu_torch``):
``run.py`` is its command; see ``BENCHMARK.json`` at the checkout's root."""
