"""PyTorch/CUDA port of the production-stack-tpu serving engine.

A package of its own beside the JAX one: it imports ``torch``, ``numpy``
and the standard library only, and never the JAX package. Its paged
attention and its int4 weight matmul run in hand-written CUDA kernels for
Hopper (``ops/csrc/``); every entry point runs on the GPU unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
