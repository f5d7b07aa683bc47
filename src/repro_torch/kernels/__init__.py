# Hand-written Hopper kernels for the perf-critical compute, one package per
# TPU kernel of ``repro.kernels``.  Each has ref.py (plain-torch oracle),
# ops.py (impl dispatch, with the kernel's plain version for CPU tensors) and
# kernel.py (wrapper of the CUDA source under csrc/, built by _build.py on
# first use).  All three TPU kernels are ported: ssd, flash_attention, rglru.

from . import flash_attention, rglru, ssd

__all__ = ["flash_attention", "rglru", "ssd"]
