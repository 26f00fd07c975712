"""The mamba mixer's prefill passes around K2: CUDA kernels, plain versions and wrappers."""
