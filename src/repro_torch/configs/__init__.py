"""Architecture registry: ``--arch <id>`` resolves here.

10 assigned architectures x 4 shapes = 40 cells.  ``cells()`` enumerates
them with runnability (long_500k needs sub-quadratic attention; the skip
rule is documented in DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

from typing import Dict, List

from . import (arctic_480b, gemma2_9b, gemma3_12b, internvl2_2b, mamba2_1_3b,
               mixtral_8x22b, qwen2_5_32b, recurrentgemma_9b,
               seamless_m4t_medium, stablelm_1_6b)
from .base import SHAPES, Cell, ModelConfig, ShapeConfig

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
    "stablelm-1.6b": stablelm_1_6b,
    "gemma3-12b": gemma3_12b,
    "gemma2-9b": gemma2_9b,
    "arctic-480b": arctic_480b,
    "mixtral-8x22b": mixtral_8x22b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "recurrentgemma-9b": recurrentgemma_9b,
    "mamba2-1.3b": mamba2_1_3b,
    "internvl2-2b": internvl2_2b,
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        return _MODULES[arch].CONFIG
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}") from None


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def cell_runnable(arch: str, shape: str) -> Cell:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return Cell(arch, shape, False,
                    "full-attention arch: 500k decode is quadratic "
                    "(global/full layers); skip per assignment rule")
    return Cell(arch, shape, True)


def cells() -> List[Cell]:
    return [cell_runnable(a, s) for a in ARCHS for s in SHAPES]


__all__ = ["ARCHS", "SHAPES", "Cell", "ModelConfig", "ShapeConfig",
           "get_config", "get_smoke_config", "cells", "cell_runnable"]
