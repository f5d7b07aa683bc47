"""Model zoo facade: ``build_model(cfg, rt)`` returns the right family."""

from ..configs.base import ModelConfig
from .common import RuntimeConfig
from .decoder import DecoderLM

__all__ = ["build_model", "DecoderLM", "RuntimeConfig"]


def build_model(cfg: ModelConfig, rt: RuntimeConfig = RuntimeConfig(), *,
                device="cuda", seed: int = 0) -> DecoderLM:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet: the encoder-decoder "
            "slice")
    return DecoderLM(cfg, rt, device=device, seed=seed)
