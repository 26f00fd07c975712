"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python3 portbench/run.py``, driven by ``BENCHMARK.json``.  It imports
neither JAX nor the JAX package; its reference (``portbench/reference``)
imports nothing of the port either."""
