"""Model zoo facade: ``build_model(cfg, rt)`` returns the right family."""

from typing import Union

from ..configs.base import ModelConfig
from .common import RuntimeConfig
from .decoder import DecoderLM
from .encdec import EncDecLM

__all__ = ["build_model", "DecoderLM", "EncDecLM", "RuntimeConfig"]


def build_model(cfg: ModelConfig, rt: RuntimeConfig = RuntimeConfig(), *,
                device="cuda", seed: int = 0) -> Union[DecoderLM, EncDecLM]:
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, rt, device=device, seed=seed)
    return DecoderLM(cfg, rt, device=device, seed=seed)
