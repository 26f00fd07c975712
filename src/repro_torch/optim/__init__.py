"""Optimizers of the PyTorch port (port of ``repro.optim``)."""
