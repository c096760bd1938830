"""PyTorch / CUDA port of the subgraph matcher (``repro`` is the JAX
reference it is held against). Mirrors ``repro``'s subpackages module
for module; imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
