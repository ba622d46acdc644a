"""PyTorch/CUDA port of the collective-capable NoC reproduction.

A second package beside the JAX reference ``repro``: the same module names
and signatures, plain PyTorch on tensors, and hand-written CUDA kernels for
Hopper (``kernels/csrc``).  It imports neither ``jax`` nor ``repro``.
"""
