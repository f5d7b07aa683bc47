from .ops import ssd, ssd_step
from .ref import bf16_ssd_limit, ssd_reference, ssd_step_reference

__all__ = ["ssd", "ssd_step", "ssd_reference", "ssd_step_reference", "bf16_ssd_limit"]
