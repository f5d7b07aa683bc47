from .ops import rglru, rglru_step
from .ref import RGLRU_C, rglru_reference, rglru_step_reference

__all__ = ["rglru", "rglru_step", "rglru_reference", "rglru_step_reference",
           "RGLRU_C"]
