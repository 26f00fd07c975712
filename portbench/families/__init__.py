"""A model family: the leaves the benchmark draws for it, with their
shapes and initial values (``layout``), the leaves served in float32
(``FLOAT32_SERVED``, besides the norm scales), the products of one layer
(``products``) and its kernels' work in a prefill and in a training
micro-batch (``prefill_kernels``, ``train_kernels``; ``portbench/work.py``
counts them), and how the leaves become the program's model (``build``).
The harness finds a family's module by the configuration's ``family``,
and refuses a family without one; the reference model of the same name
lies in ``portbench/reference/``, with the leaves it keeps out of weight
decay (``NO_DECAY``, besides the norm scales)."""
