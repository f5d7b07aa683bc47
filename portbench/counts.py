"""Operations and bytes of the served work, from the configuration's shapes.

The yardstick of the roofline and MFU metrics.  It counts the work the
inputs need, whatever computes it: unpadded tokens, each token's top-k
experts only (no capacity slots), the causal (and windowed) pairs of each
request's own tokens, each weight read once a decode step, only the
looked-up embedding rows and the K/V of valid positions.  Matrix products
only: norms, RoPE, softmax and routing are left out, so a share counts
less than the chip did, never more.  The flash-attention bound copies the
arithmetic of ``chip_smoke.py::flash_bound`` (operations 4 D a valid pair a
q head; q and the output, and K/V of the keys reached, read or written
once) for the valid pairs of unpadded rows.

The formulas here are the decoder's (``reference/decoder.py``: attention
and a SwiGLU MLP or top-k experts in every layer).  A configuration's
reference module (``reference.module``) that defines its own
``layer_params``, ``prefill_flops``, ``flash_call`` or ``decode_step`` is
counted by that instead; the readers call only the functions of this
module, so a share reads the same work whatever implements it.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

from . import reference

__all__ = ["PEAK_BF16_FLOPS", "HBM_BYTES_PER_S", "pairs", "layer_params",
           "prefill_flops", "flash_call", "decode_step", "weight_bytes",
           "decoder_layer_params", "decoder_prefill_flops", "decoder_flash_call",
           "decoder_decode_step"]

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
_ELT = {"float32": 4, "bfloat16": 2}


def pairs(n: int, window=None) -> int:
    """(query, key) pairs of a causal attention over n tokens, each query
    reaching at most ``window`` keys (itself included)."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def _own(cfg: Dict, name: str, formula: Callable) -> Callable:
    """The configuration's reference module's own count ``name``, or
    ``formula``."""
    return getattr(reference.module(cfg), name, formula)


def layer_params(cfg: Dict) -> int:
    """Weights one token multiplies by in one layer."""
    return _own(cfg, "layer_params", decoder_layer_params)(cfg)


def prefill_flops(cfg: Dict, lens: Iterable[int]) -> int:
    """A wave's useful prefill operations, its requests' prompt lengths
    ``lens``."""
    return _own(cfg, "prefill_flops", decoder_prefill_flops)(cfg, lens)


def flash_call(cfg: Dict, lens: Iterable[int]) -> Dict[str, float]:
    """A layer's flash-attention call over a wave: ``flops``, ``bytes`` and
    least ``seconds``.  The readers take ``num_hidden_layers`` of them a
    wave, so where layers differ it is their mean."""
    return _own(cfg, "flash_call", decoder_flash_call)(cfg, lens)


def decode_step(cfg: Dict, contexts: Iterable[int], weights: int) -> Dict[str, float]:
    """One decode step of the rows at ``contexts``: ``flops``, ``bytes`` and
    least ``seconds``.  ``weights`` is :func:`weight_bytes`."""
    return _own(cfg, "decode_step", decoder_decode_step)(cfg, contexts, weights)


def weight_bytes(cfg: Dict) -> int:
    """Bytes of every weight but the embedding table (a step reads only the
    rows it looks up), in the shapes and dtypes of the configuration's
    reference module."""
    ref = reference.module(cfg)
    total = 0
    for name, shape in ref.param_shapes(cfg).items():
        if name == "embed":
            continue
        n = 1
        for s in shape:
            n *= s
        total += n * ref.param_dtype(cfg, name).itemsize
    return total


def decoder_layer_params(cfg: Dict) -> int:
    """Weights one token multiplies by in one layer: the attention's four
    projections, and the MLP's three, or its k experts' and the router."""
    D, Hq, Hkv, dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    F, E, k = cfg["intermediate_size"], cfg["num_local_experts"], cfg["num_experts_per_tok"]
    attn = 2 * D * Hq * dh + 2 * D * Hkv * dh
    return attn + (k * 3 * D * F + D * E if E else 3 * D * F)


def _attn_flops(cfg: Dict, n_pairs: int) -> int:
    return 4 * cfg["head_dim"] * cfg["num_attention_heads"] * n_pairs


def decoder_prefill_flops(cfg: Dict, lens: Iterable[int]) -> int:
    """A wave's useful prefill operations: every request's own tokens through
    every layer, and the head at its last position."""
    L, window = cfg["num_hidden_layers"], cfg.get("sliding_window")
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return sum(L * (2 * n * layer_params(cfg) + _attn_flops(cfg, pairs(n, window))) + head
               for n in lens)


def decoder_flash_call(cfg: Dict, lens: Iterable[int]) -> Dict[str, float]:
    """One layer's attention over a wave: operations, bytes and least
    seconds, for the requests' own tokens (bf16)."""
    lens = list(lens)
    Hq, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    window = cfg.get("sliding_window")
    flops = sum(_attn_flops(cfg, pairs(n, window)) for n in lens)
    tokens = sum(lens)
    nbytes = 2 * (2 * tokens * Hq * dh + 2 * tokens * Hkv * dh)
    return {"flops": flops, "bytes": nbytes,
            "seconds": max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)}


def decoder_decode_step(cfg: Dict, contexts: Iterable[int], weights: int) -> Dict[str, float]:
    """One decode step of the rows still serving a request, each at its
    context length (keys, the new token's included): operations, bytes and
    least seconds.  ``weights`` is :func:`weight_bytes`."""
    contexts = list(contexts)
    L, window = cfg["num_hidden_layers"], cfg.get("sliding_window")
    D, Hkv, dh = cfg["hidden_size"], cfg["num_key_value_heads"], cfg["head_dim"]
    kv_elt = _ELT[cfg["compute_dtype"]]
    keys = [c if window is None else min(c, window) for c in contexts]
    flops = sum(L * (2 * layer_params(cfg) + _attn_flops(cfg, n))
                + 2 * D * cfg["vocab_size"] for n in keys)
    nbytes = (weights + len(contexts) * D * _ELT[cfg["param_dtype"]]
              + sum(L * 2 * Hkv * dh * n * kv_elt for n in keys))
    return {"flops": flops, "bytes": nbytes,
            "seconds": max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)}
