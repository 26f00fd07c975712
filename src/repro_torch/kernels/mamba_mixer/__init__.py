"""The mamba mixer's passes around K2 and their backward passes: CUDA kernels, plain
versions and wrappers."""
