"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

It keeps the JAX package's module layout and names, so each module's
counterpart sits at the same path under ``repro``.  It imports neither
``jax`` nor ``repro``: what it needs from them it keeps as its own copy.

Subpackages (ported so far: the mamba2 serving slice):
  configs  architecture registry (--arch ids), a copy of ``repro.configs``
  kernels  hand-written Hopper kernels (SSD) + plain-torch versions
  models   the SSM decoder (``("ssm",)`` pattern)
  serve    batched serving engine
  launch   serving driver
"""

__version__ = "0.1.0"
