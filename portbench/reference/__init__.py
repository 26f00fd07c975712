"""The plain reference: the same models in float32 PyTorch, written from
their equations, with no kernel, cache or batching of the program.  It
imports neither JAX, the JAX package nor anything of the port."""
