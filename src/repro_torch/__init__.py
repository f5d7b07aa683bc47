"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

It keeps the JAX package's module layout and names, so each module's
counterpart sits at the same path under ``repro``.  It imports neither
``jax`` nor ``repro``: what it needs from them it keeps as its own copy.

Subpackages and modules (ported so far: serving mamba2-1.3b and
recurrentgemma-9b, and training mamba2-1.3b through the platform):
  configs   architecture registry (--arch ids), a copy of ``repro.configs``
  core      the dataset platform's engine, a copy of ``repro.core``
  platform  the platform facade, a copy of ``repro.platform``
  data      tokenize/pack components (a copy), the snapshot loader and the
            torch host->device feed
  kernels   hand-written Hopper kernels (SSD, flash attention, RG-LRU) and
            their plain-torch versions
  models    the decoder for the ``ssm``, ``rec`` and ``local`` block kinds,
            with the training loss
  train     AdamW, the train step, checkpoints through the platform
  serve     batched serving engine
  launch    serving and training drivers
  weights   parameter trees to and from the JAX package's layout
"""

__version__ = "0.1.0"
