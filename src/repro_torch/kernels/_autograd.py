"""The kernels are forward-only: their wrappers refuse inputs that need a
gradient.

A wrapper writes its outputs into fresh buffers through ``ctypes``, so they
carry no ``grad_fn``: a model trained through a kernel would lose, without
a word, every gradient that flows through the scan or the attention.  The
reference's kernels define no VJP either; it trains through its plain
paths, and so does the port (``ssd_impl="chunked"``, ``rglru_impl="scan"``,
``attn_impl="ref"`` or ``"chunked"``).  Serving runs under
``torch.inference_mode`` and is not affected.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, plain: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel) and its outputs "
            f"carry no gradient; train through the plain version, {plain}, "
            "or call it under torch.no_grad() / torch.inference_mode()")
