"""Core engines of the PyTorch port: the routed-graph engine, the bandwidth-signature model and the NUMA simulator."""
