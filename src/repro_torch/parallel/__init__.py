"""Parallelism on ``torch.distributed`` (port of ``repro.parallel``): the
mesh, the logical-axis rules and the collectives the sharded layers call."""
