"""Flash attention (K1): CUDA kernel, plain version and wrapper."""
