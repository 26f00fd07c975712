"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the JAX package, each with its plain PyTorch version beside it
(``ref.py``), its wrapper and launch counter (``kernel.py``), its public
wrapper (``ops.py``) and its CUDA source (``csrc/``)."""
