# Hand-written Hopper kernels for the perf-critical compute, one package per
# TPU kernel of ``repro.kernels``.  Each has ref.py (plain-torch oracle),
# ops.py (impl dispatch, with the kernel's plain version for CPU tensors) and
# kernel.py (wrapper of the CUDA source under csrc/, built by _build.py on
# first use).  All three TPU kernels are ported: ssd, flash_attention, rglru.

from . import flash_attention, rglru, ssd

__all__ = ["flash_attention", "rglru", "ssd", "launch_counts"]


def launch_counts() -> dict:
    """Launches so far of each kernel route in this process, by kernel:
    ``flash_fwd_wgmma`` and ``flash_fwd``, ``ssd_fwd_wgmma`` and ``ssd_fwd``
    (each call of either counted once, on the route it took), ``rglru_fwd``.
    Reads the wrappers' counters; builds nothing."""
    from .flash_attention.kernel import flash_cuda
    from .rglru.kernel import rglru_cuda
    from .ssd.kernel import ssd_cuda
    return {"flash_fwd_wgmma": flash_cuda.wgmma_launches,
            "flash_fwd": flash_cuda.launches - flash_cuda.wgmma_launches,
            "ssd_fwd_wgmma": ssd_cuda.wgmma_launches,
            "ssd_fwd": ssd_cuda.launches - ssd_cuda.wgmma_launches,
            "rglru_fwd": rglru_cuda.launches}
