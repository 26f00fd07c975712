"""Mamba-1 selective scan: CUDA kernel, plain version and wrapper."""
