"""Plain references of the served architectures, one module each.

A configuration file names its module with ``"reference": "<name>"``: the
module ``portbench.reference.<name>``.  Without the key it is ``decoder``.
What a module defines is in ``portbench/README.md`` ("Adding a
configuration").
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

__all__ = ["DEFAULT", "module"]

DEFAULT = "decoder"


def module(cfg: Dict) -> ModuleType:
    """The reference module that configuration ``cfg`` names."""
    return importlib.import_module(f"{__name__}.{cfg.get('reference', DEFAULT)}")
